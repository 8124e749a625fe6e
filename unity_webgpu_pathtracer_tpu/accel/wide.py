"""Fat-row 4-ary BVH ("wide") — a frozen traversal format.

The format optimizes for ONE row gather per traversal arrival, on the
premise that a batched row gather costs about the same whatever the row
width (up to a few hundred bytes):

* internal rows carry all four children's AABBs + their DFS indices, so one
  gather tests four subtrees;
* leaf rows carry up to four full Möller-Trumbore triangle records inline
  (``[e2, e1, v0]`` + attribute index), so leaf intersection needs no second
  gather;
* traversal is stackless: rows are DFS-ordered per ray octant with skip
  pointers (see ``accel.linearize`` for the rationale), and a lane's entire
  traversal state is one int32 pointer.

Unified row layout, ``(N, 48)`` float32 (ints bitcast):

====== ========================== ===========================
floats  internal                   leaf
====== ========================== ===========================
0:24    child AABBs ×4 (lo3,hi3)   tri SoA ``[e2x·4|e2y·4|e2z·4|e1…]``
24:28   child DFS ptrs (int)       (continues tri SoA)
28:36   unused                     tri SoA ``…|v0z·4]`` (9 comps × 4)
36:40   unused                     attr index ×4 (int)
44      skip (int)                 skip (int)
45      leaf count = 0             leaf count 1..4 (int)
46:48   pad                        pad
====== ========================== ===========================

Leaf triangle lanes are stored SoA *within the row*: floats
``[e2x·4 | e2y·4 | e2z·4 | e1x·4 | ... | v0z·4 | idx·4]`` so the 4-wide
intersection vectorizes over the last axis without reshuffles.
"""

from __future__ import annotations

import numpy as np

from unity_webgpu_pathtracer_tpu.accel.bvh2 import BVH2

ROW = 48
OFF_PTRS = 24
OFF_TRI_V0 = 28  # placeholder doc anchor; see _leaf_row
OFF_IDX = 40
OFF_SKIP = 44
OFF_COUNT = 45
MAX_LEAF = 4


def _children4(bvh: BVH2, node: int, octant: int, axis: np.ndarray) -> list[int]:
    """Collapse two BVH2 levels into ≤4 children, near-first for octant."""
    l = bvh.left[node]
    pair = [l, l + 1]
    if (octant >> axis[node]) & 1:
        pair.reverse()
    out = []
    for c in pair:
        if bvh.count[c] > 0:
            out.append(c)
        else:
            cl = bvh.left[c]
            sub = [cl, cl + 1]
            if (octant >> axis[c]) & 1:
                sub.reverse()
            out.extend(sub)
    return out


def _leaf_row(row, bvh: BVH2, node: int, tri_records: np.ndarray,
              attr_index: np.ndarray):
    start = int(bvh.start[node])
    cnt = int(bvh.count[node])
    recs = tri_records[start : start + cnt]           # (cnt, 9) [e2,e1,v0]
    idx = attr_index[start : start + cnt]
    # SoA within the row: 9 components x 4 lanes, then 4 attr indices.
    block = np.zeros((9, MAX_LEAF), np.float32)
    block[:, :cnt] = recs.T
    row[0:36] = block.reshape(-1)
    ints = np.zeros(MAX_LEAF, np.int32)
    ints[:cnt] = idx
    row[36:40] = ints.view(np.float32)
    row[OFF_COUNT] = np.asarray([cnt], np.int32).view(np.float32)[0]


def build_wide(bvh: BVH2, tri_records: np.ndarray, attr_index: np.ndarray,
               octant_orders: bool = True) -> np.ndarray:
    """Emit the fat-row arrays; returns (O, N, 48) float32, O = 8 or 1."""
    n2 = bvh.node_count
    axis = np.zeros(n2, np.int32)
    inner = bvh.left >= 0
    li = bvh.left[inner]
    c_l = (bvh.nmin[li] + bvh.nmax[li]) * 0.5
    c_r = (bvh.nmin[li + 1] + bvh.nmax[li + 1]) * 0.5
    axis[inner] = np.argmax(np.abs(c_r - c_l), axis=-1)

    octants = range(8) if octant_orders else (0,)
    outs = []
    for octant in octants:
        rows: list[np.ndarray] = []

        def emit(node: int) -> int:
            """Emit the row(s) for `node`'s subtree; returns its DFS index."""
            my = len(rows)
            row = np.zeros(ROW, np.float32)
            rows.append(row)
            if bvh.count[node] > 0:
                _leaf_row(row, bvh, node, tri_records, attr_index)
            else:
                kids = _children4(bvh, node, octant, axis)
                ptrs = np.zeros(4, np.int32)
                # SoA within the row: [lox·4|loy·4|loz·4|hix·4|hiy·4|hiz·4]
                # so each slab component is a contiguous (B, 4) slice.
                boxes = np.zeros((6, 4), np.float32)
                boxes[0:3, :] = np.inf
                boxes[3:6, :] = -np.inf
                for k, c in enumerate(kids):
                    boxes[0:3, k] = bvh.nmin[c]
                    boxes[3:6, k] = bvh.nmax[c]
                    ptrs[k] = emit(c)
                row[0:24] = boxes.reshape(-1)
                row[OFF_PTRS : OFF_PTRS + 4] = ptrs.view(np.float32)
            skip = len(rows)
            row[OFF_SKIP] = np.asarray([skip], np.int32).view(np.float32)[0]
            return my

        import sys

        old = sys.getrecursionlimit()
        sys.setrecursionlimit(max(old, 10000))
        try:
            emit(0)
        finally:
            sys.setrecursionlimit(old)
        # Fix skips: each node's skip must be its DFS index + subtree size —
        # with recursive emit, `skip = len(rows)` at return time is exactly
        # that (all descendants emitted between).
        outs.append(np.stack(rows))
    n = max(o.shape[0] for o in outs)
    assert all(o.shape[0] == n for o in outs)
    return np.stack(outs)


def validate_wide(nodes: np.ndarray, tri_count: int):
    """Every triangle reachable exactly once per octant order; skips sane."""
    f = tri_count
    for oi in range(nodes.shape[0]):
        seen = np.zeros(f, np.int32)
        rows = nodes[oi]
        n = rows.shape[0]
        i = 0
        # Walk the full DFS by always "entering": visit node 0..n-1 in order.
        for i in range(n):
            row = rows[i]
            cnt = row[OFF_COUNT : OFF_COUNT + 1].view(np.int32)[0]
            skip = row[OFF_SKIP : OFF_SKIP + 1].view(np.int32)[0]
            assert i < skip <= n
            if cnt > 0:
                idx = row[36:40].view(np.int32)[:cnt]
                seen[idx] += 1
        assert (seen == 1).all(), "leaf coverage broken"
