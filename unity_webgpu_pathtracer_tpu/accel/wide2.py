"""Split-table variant of the fat-row format: hot internal rows, cold leaves.

Random row gathers get dearer as the table outgrows the caches.  The
unified fat-row table for a 1M-tri scene is 87 MB, but most arrivals touch
*internal* rows which only need 32 of the 48 floats.  Splitting:

* ``inner (O, Ni, 32)``  — per octant: [child boxes SoA 24 | child codes 4 |
  skip 1 | inst meta 3].  ~19 MB for 1M tris.
* ``leaf_geo (Nl, 48)``  — octant-independent (shared!) inline triangle
  rows; gathered only in the amortized leaf phase.
* ``leaf_skip (O, Nl)``  — per-octant DFS continuation of each leaf (the
  only octant-dependent part of a leaf), a tiny int32 table.

Signed position codes replace row indices: ``pos > 0`` = inner row
``pos-1``, ``pos < 0`` = leaf row ``-pos-1``, ``0`` = traversal end.

Built by post-processing the unified ``accel.wide`` table (one code path
for numpy and the C++ builder).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

OFF_PTRS = 24
OFF_SKIP = 44
OFF_KIND = 45


class SplitTables(NamedTuple):
    inner: np.ndarray       # (O, Ni, 32) float32
    leaf_geo: np.ndarray    # (Nl, 48) float32 (skip/kind lanes cleared)
    leaf_skip: np.ndarray   # (O, Nl) int32 signed codes
    leaf_count: np.ndarray  # (Nl,) int32 triangle count per leaf


def split_wide(table: np.ndarray) -> SplitTables:
    """Split a unified (O, N, 48) table (accel.wide / accel.tlas layout)."""
    n_oct, n, _ = table.shape
    kinds0 = table[0, :, OFF_KIND : OFF_KIND + 1].view(np.int32)[:, 0]
    is_leaf0 = kinds0 > 0

    # Shared leaf table from octant 0 (content is octant-independent).
    leaf_rows0 = np.where(is_leaf0)[0]
    nl = leaf_rows0.shape[0]
    leaf_geo = table[0, leaf_rows0].copy()
    leaf_count = leaf_geo[:, OFF_KIND : OFF_KIND + 1].view(np.int32)[:, 0].copy()
    # Count stays in the row (octant-independent); only the skip is per-octant.
    leaf_geo[:, OFF_SKIP] = 0.0
    # Identity key: the sorted attribute-index set names a leaf uniquely.
    leaf_id_by_key = {}
    for li, row_idx in enumerate(leaf_rows0):
        idx = table[0, row_idx, 36:40].view(np.int32)
        cnt = leaf_count[li]
        leaf_id_by_key[tuple(sorted(idx[:cnt].tolist()))] = li

    ni = n - nl
    inner = np.zeros((n_oct, ni, 32), np.float32)
    leaf_skip = np.zeros((n_oct, nl), np.int32)

    for o in range(n_oct):
        kinds = table[o, :, OFF_KIND : OFF_KIND + 1].view(np.int32)[:, 0]
        is_leaf = kinds > 0
        # Row index -> signed code for this octant.
        inner_new = np.cumsum(~is_leaf) - 1          # per-row inner id
        leaf_local = np.cumsum(is_leaf) - 1          # per-row local leaf ord
        # Map local leaf rows to shared leaf ids via the identity key.
        leaf_ids = np.zeros(n, np.int64)
        for row_idx in np.where(is_leaf)[0]:
            idx = table[o, row_idx, 36:40].view(np.int32)
            cnt = table[o, row_idx, OFF_KIND : OFF_KIND + 1].view(np.int32)[0]
            leaf_ids[row_idx] = leaf_id_by_key[tuple(sorted(idx[:cnt].tolist()))]

        def code(row_idx):
            r = np.asarray(row_idx)
            c = np.where(
                r >= n, 0,
                np.where(is_leaf[np.clip(r, 0, n - 1)],
                         -(leaf_ids[np.clip(r, 0, n - 1)] + 1),
                         inner_new[np.clip(r, 0, n - 1)] + 1),
            )
            return c.astype(np.int32)

        rows = table[o]
        skips = rows[:, OFF_SKIP : OFF_SKIP + 1].view(np.int32)[:, 0]
        inner_rows = np.where(~is_leaf)[0]
        out = inner[o]
        out[:, 0:24] = rows[inner_rows, 0:24]
        # Child pointers: internal rows store row indices; instance rows
        # (kind < 0) store [blas_ptr, blas_len, material, -]: remap blas_ptr
        # to a code and blas range ends to (inner_end, leaf_end).
        ptrs = rows[inner_rows, OFF_PTRS : OFF_PTRS + 4].view(np.int32)
        kk = kinds[inner_rows]
        remapped = np.zeros_like(ptrs)
        internal_mask = kk == 0
        im = internal_mask[:, None] & (ptrs > 0)
        remapped[im] = code(ptrs[im])
        # Instance rows: blas region [p, p+l) -> entry code + end ids.
        inst_rows = np.where(kk < 0)[0]
        for ir in inst_rows:
            p, l = int(ptrs[ir, 0]), int(ptrs[ir, 1])
            remapped[ir, 0] = code(p)
            rng = np.arange(p, p + l)
            inner_in = rng[~is_leaf[rng]]
            leaf_in = rng[is_leaf[rng]]
            remapped[ir, 1] = (inner_new[inner_in].max() + 2) if inner_in.size else 1
            remapped[ir, 2] = (leaf_ids[leaf_in].max() + 2) if leaf_in.size else 1
            # material override moves to lane 3
            remapped[ir, 3] = ptrs[ir, 2]
        out[:, 24:28] = remapped.view(np.float32)
        out[:, 28] = code(skips[inner_rows]).view(np.float32)
        out[:, 29] = kk.view(np.float32)   # 0 internal, <0 instance id code

        lr = np.where(is_leaf)[0]
        leaf_skip[o, leaf_ids[lr]] = code(skips[lr])

    return SplitTables(inner=inner, leaf_geo=leaf_geo, leaf_skip=leaf_skip,
                       leaf_count=leaf_count)
