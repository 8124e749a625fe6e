"""16-wide quantized BVH ("wide16") — the production traversal format.

Same design as :mod:`accel.wide8` (CWBVH-style quantized children,
per-lane register stacks, ``tiny_bvh.h:5909-5931`` format lineage) but
doubled on both axes, on the premise that a 384-byte row gathers at about
the per-row price of a 192-byte row:

* **16 children per inner node** — the tree is one level shallower per
  descent and sibling culling tests 16 boxes per gather;
* **16 triangles per leaf row** — half the leaf arrivals of wide8.

Fewer arrivals per ray is the aim: every arrival is one dependent row
gather per lane.

Child-visit order is **true nearest-first**: the traversal picks the hit
child with the smallest slab entry t (argmin over the 16 lanes) instead of
wide8's octant-slot approximation, so the builder assigns slots in plain
surface-area order with no octant coding.

Row layout, unified ``(N, 96)`` float32 (ints bitcast). ``f[3]`` is the
row kind ``meta``: 0 = inner, 1..16 = leaf triangle count, <0 = TLAS
instance ``-(id+1)``.

====== ============================== ========================== ==================
floats  inner                          leaf                       instance
====== ============================== ========================== ==================
0:3     anchor (node AABB min)         anchor (leaf AABB min)     unused
3       meta = 0                       meta = count               meta = -(id+1)
4       exps ``ex|ey<<8|ez<<16``       tri f16 SoA (72 floats:    world→local 3x4
5:8     unused                         9 comps x 16 lanes, v0     (4:16)
8:32    q8 boxes ``[qlox·16|qloy·16|   anchor-relative, 4:76)     blas root (16)
        qloz·16|qhix·16|qhiy·16|
        qhiz·16]``
32:48   child row ptrs (int, -1 empty) attr idx x16 (76:92, -1)
====== ============================== ========================== ==================
"""

from __future__ import annotations

import dataclasses

import numpy as np

from unity_webgpu_pathtracer_tpu.accel.bvh2 import BVH2, build_bvh2
from unity_webgpu_pathtracer_tpu.accel.wide8 import _f32, _subtree_ranges

ROW = 96
WIDTH = 16
MAX_LEAF = 16
MAX_DEPTH = 20   # traversal stack entries; build asserts depth < this

OFF_META = 3
OFF_EXPS = 4
OFF_QBOX = 8     # 24 floats: 96 bytes comp-major
OFF_PTRS = 32    # 16 ints
OFF_TRIS = 4     # 72 floats: 9 comps x 16 f16
OFF_IDX = 76     # 16 ints
OFF_W2L = 4
OFF_BLAS = 16

# ---- leaf8 variant: 48-float rows, 16-wide inner / 8-triangle leaves ----
# The inner layout above occupies words 0..47 exactly (anchor 3, meta,
# exps, qbox 24, ptrs 16), so halving the LEAF slot count to 8 (9 comps x
# 8 f16 = 36 words at 4:40, attr idx x8 at 40:48) packs both kinds into a
# 48-float row: HALF the node-gather traffic per arrival and HALF the leaf
# Moller-Trumbore work, traded against more leaf arrivals from splitting
# 9..16-triangle leaves.  Consumers dispatch on
# ``nodes.shape[-1]`` (96 = classic, 48 = leaf8); the instance-row layout
# (w2l at 4:16, blas root at 16) is unchanged and fits either width.
ROW8 = 48
LEAF8 = 8
OFF_IDX8 = 40


def _collapse16(bvh: BVH2, node: int, counts: np.ndarray,
                max_leaf: int = MAX_LEAF) -> list[int]:
    """Greedy 2-wide -> up-to-16-wide collapse: repeatedly expand the child
    with the largest surface area; subtrees with <= max_leaf triangles stay
    whole (they become one leaf row)."""

    def area(c):
        d = np.maximum(bvh.nmax[c] - bvh.nmin[c], 0.0)
        return float(d[0] * d[1] + d[1] * d[2] + d[2] * d[0])

    l = bvh.left[node]
    kids = [l, l + 1]
    while len(kids) < WIDTH:
        expandable = [
            (area(c), i)
            for i, c in enumerate(kids)
            if bvh.left[c] >= 0 and counts[c] > max_leaf
        ]
        if not expandable:
            break
        _, i = max(expandable)
        c = kids.pop(i)
        cl = bvh.left[c]
        kids.extend([cl, cl + 1])
    return kids


def _canon_f16(h: np.ndarray) -> np.ndarray:
    """Canonicalize f16 bit patterns: subnormals and -0 flush to +0 (below
    quantization noise), inf/nan clamp to +-65504, so every decoder sees
    only normal values and zero."""
    hb = h.view(np.uint16)
    hb = np.where((hb & 0x7C00) == 0, np.uint16(0), hb)
    hb = np.where((hb & 0x7C00) == 0x7C00,
                  (hb & np.uint16(0x8000)) | np.uint16(0x7BFF), hb)
    return hb


# Slot <-> storage-position permutations (SPLIT slot order).
#
# The SPLIT order lets a decoder that works on whole (16, lanes) blocks
# assemble them with a few in-order concatenations instead of a 16-way
# interleave per component.  It stores:
#
# * leaf f16: word w carries (slot w, slot w+8) -> decode is
#   concat([lo-halves (8,BLK), hi-halves (8,BLK)]) — 1 concat, in order;
# * child q-bytes: byte j of word w carries slot 4j+w -> decode is
#   concat over j of 4 (4, BLK) shifted blocks — 4 concats, in order.
#
# The XLA/numpy consumers apply these STATIC index permutations after
# their whole-slice bitcasts (CPU/test path; cost irrelevant there).
# PERM_Q is an involution (pos(pos(s)) == s); PERM_H_* are inverses.
PERM_H_POS = np.array([2 * s if s < 8 else 2 * (s - 8) + 1
                       for s in range(16)])        # slot -> halfword pos
PERM_H_SLOT = np.argsort(PERM_H_POS)               # halfword pos -> slot
PERM_Q = np.array([4 * (s % 4) + s // 4 for s in range(16)])  # involution
# leaf8 halfword order: word w carries (slot w, slot w+4) over 4 words.
PERM_H8_POS = np.array([2 * s if s < 4 else 2 * (s - 4) + 1
                        for s in range(8)])


def _pack_f16_split(vals: np.ndarray) -> np.ndarray:
    """(2k,) float -> (k,) float32 words in SPLIT order: word w = slot w
    (lo half) | slot w+k (hi half).  k=8 for classic 16-slot leaves, k=4
    for leaf8 rows."""
    h = _canon_f16(np.asarray(vals, np.float16))
    k = h.shape[0] // 2
    words = h[0:k].astype(np.uint32) | (h[k:2 * k].astype(np.uint32) << 16)
    return words.view(np.int32).view(np.float32)


def _pack_u8_t(vals16: np.ndarray) -> np.ndarray:
    """(16,) uint8 slots -> (4,) float32 words in SPLIT order: byte j of
    word w = slot 4j+w."""
    s = np.asarray(vals16, np.uint8).astype(np.uint32)
    words = (s[0:4] | (s[4:8] << 8) | (s[8:12] << 16) | (s[12:16] << 24))
    return words.view(np.int32).view(np.float32)


def _quantize_node(row: np.ndarray, nmin: np.ndarray, nmax: np.ndarray,
                   boxes: list):
    """Write anchor + exponents + conservative 8-bit child boxes (same
    conservative power-of-two scale scheme as wide8)."""
    anchor = np.asarray(nmin, np.float32)
    extent = np.maximum(np.asarray(nmax, np.float32) - anchor, 0.0)
    e = np.ceil(np.log2(np.maximum(extent / 255.0, 1e-30))).astype(np.int32)
    e = np.clip(e, -126, 127)
    scale = np.ldexp(np.ones(3, np.float32), e)
    short = 255.0 * scale < extent
    e = np.clip(e + short.astype(np.int32), -126, 127)
    scale = np.ldexp(np.ones(3, np.float32), e)
    row[0:3] = anchor
    row[OFF_EXPS] = _f32(
        int(e[0] + 127) | (int(e[1] + 127) << 8) | (int(e[2] + 127) << 16)
    )
    qlo = np.full((WIDTH, 3), 255, np.uint8)
    qhi = np.zeros((WIDTH, 3), np.uint8)
    for k, b in enumerate(boxes):
        if b is None:
            continue
        lo, hi = b
        ql = np.floor((np.asarray(lo, np.float32) - anchor) / scale)
        qh = np.ceil((np.asarray(hi, np.float32) - anchor) / scale)
        qlo[k] = np.clip(ql, 0, 255).astype(np.uint8)
        qhi[k] = np.clip(qh, 0, 255).astype(np.uint8)
    # comp-major: qlox·16, qloy·16, qloz·16, qhix·16, qhiy·16, qhiz·16
    # (SPLIT byte order within each comp — see PERM_Q).
    out = []
    for arr in (qlo, qhi):
        for c in range(3):
            out.append(_pack_u8_t(arr[:, c]))
    row[OFF_QBOX : OFF_QBOX + 24] = np.concatenate(out)


def _leaf_row(row: np.ndarray, nmin, recs: np.ndarray, idx: np.ndarray,
              slots: int = WIDTH):
    """recs: (cnt, 9) [e2,e1,v0] float32; v0 stored anchor-relative f16."""
    cnt = recs.shape[0]
    anchor = np.asarray(nmin, np.float32)
    row[0:3] = anchor
    row[OFF_META] = _f32(cnt)
    comps = np.zeros((9, slots), np.float32)
    comps[:, :cnt] = recs.T
    comps[6:9, :cnt] -= anchor[:, None]          # v0 relative to anchor
    packed = [_pack_f16_split(comps[c]) for c in range(9)]
    nw = 9 * slots // 2
    row[OFF_TRIS : OFF_TRIS + nw] = np.concatenate(packed)
    ints = np.full(slots, -1, np.int32)
    ints[:cnt] = idx
    off_idx = OFF_IDX if slots == WIDTH else OFF_IDX8
    row[off_idx : off_idx + slots] = ints.view(np.float32)


@dataclasses.dataclass
class Wide16:
    nodes: np.ndarray      # (N, 96) float32
    depth: int             # max stack depth observed (pushes per path)
    # Leaf rows index attributes by BVH-order position; the host permutes
    # the attribute tables by `order`.
    order: np.ndarray | None = None


def build_wide16(bvh: BVH2, tri_records: np.ndarray,
                 attr_index: np.ndarray, leaf8: bool = False) -> Wide16:
    """Emit the quantized 16-wide table from a BVH2 (single mesh/scene).

    ``leaf8=True`` emits the 48-float-row variant (8-triangle leaves,
    identical inner layout) — see the ROW8 block comment above."""
    row_f = ROW8 if leaf8 else ROW
    max_leaf = LEAF8 if leaf8 else MAX_LEAF
    starts, counts = _subtree_ranges(bvh)
    rows: list[np.ndarray] = []
    max_depth = 0

    def sa(c):
        d = np.maximum(bvh.nmax[c] - bvh.nmin[c], 0.0)
        return float(d[0] * d[1] + d[1] * d[2] + d[2] * d[0])

    def emit_leaf(node: int) -> int:
        my = len(rows)
        row = np.zeros(row_f, np.float32)
        rows.append(row)
        lo, cnt = int(starts[node]), int(counts[node])
        sel = bvh.order[lo : lo + cnt]
        _leaf_row(row, bvh.nmin[node], tri_records[sel],
                  attr_index[lo : lo + cnt], slots=max_leaf)
        return my

    def emit(node: int, depth: int) -> int:
        nonlocal max_depth
        max_depth = max(max_depth, depth)
        if counts[node] <= max_leaf:
            return emit_leaf(node)
        my = len(rows)
        row = np.zeros(row_f, np.float32)
        rows.append(row)
        kids = _collapse16(bvh, node, counts, max_leaf)
        # Nearest-first ordering is computed at runtime from slab-entry t,
        # so slots carry no octant code — plain surface-area order.
        slots = sorted(kids, key=sa, reverse=True) + [None] * (WIDTH - len(kids))
        boxes = [
            None if c is None else (bvh.nmin[c], bvh.nmax[c]) for c in slots
        ]
        _quantize_node(row, bvh.nmin[node], bvh.nmax[node], boxes)
        ptrs = np.full(WIDTH, -1, np.int32)
        for k, c in enumerate(slots):
            if c is not None:
                ptrs[k] = emit(c, depth + 1)
        row[OFF_PTRS : OFF_PTRS + 16] = ptrs.view(np.float32)
        return my

    import sys

    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 100000))
    try:
        emit(0, 1)
    finally:
        sys.setrecursionlimit(old)
    assert max_depth < MAX_DEPTH, f"tree depth {max_depth} >= {MAX_DEPTH}"
    return Wide16(nodes=np.stack(rows), depth=max_depth,
                  order=np.array(bvh.order, np.int32))


TOP_COLS = 119  # anchor 3 | scale 3 | qlo 48 | qhi 48 | ptrs 16 | meta 1


def _decode_top_row(nodes: np.ndarray, p: int, out: np.ndarray) -> None:
    """Decode node row ``p`` into a (TOP_COLS,) slot-table row (plain f32
    fields, ints exact below 2^24).  ``out[118]`` (meta) is left for the
    caller; this fills anchor/scale/qboxes/ptrs for an inner row."""
    row = nodes[p]
    out[0:3] = row[0:3]
    eword = int(row[OFF_EXPS : OFF_EXPS + 1].view(np.int32)[0])
    for c in range(3):
        out[3 + c] = np.ldexp(np.float32(1.0), ((eword >> (8 * c)) & 0xFF) - 127)
    # Un-permute the SPLIT byte order so the top table stays slot-ordered
    # (the prestep16 slab consumer is layout-agnostic this way).
    qbytes = (row[OFF_QBOX : OFF_QBOX + 24].view(np.uint8)
              .reshape(6, 16)[:, PERM_Q].reshape(96).astype(np.float32))
    out[6:54] = qbytes[:48]
    out[54:102] = qbytes[48:]
    out[102:118] = row[OFF_PTRS : OFF_PTRS + 16].view(np.int32)


def derive_top3_limbs(nodes: np.ndarray, top: np.ndarray | None):
    """Level-3 slot table for the one-hot-matmul prestep: (3, 256, TOP_COLS)
    float32 carrying the 3 bf16 limbs (hi, mid, lo) of the decoded rows of
    every grandchild slot ``k1*16 + k2``.  The 3-limb split reconstructs
    f32 EXACTLY (8+8+8 mantissa bits cover f32's 24), so a bf16 one-hot
    matmul against the limbs is a bit-exact 256-row gather instead of a
    256-step select chain.  Returns None when the scene has no level-2
    inner rows."""
    if top is None:
        return None
    import ml_dtypes

    t3 = np.zeros((256, TOP_COLS), np.float32)
    t3[:, 118] = 1.0
    any_inner = False
    for k in range(16):
        if int(top[k, 118]) != 0:
            continue
        ptrs = top[k, 102:118].astype(np.int64)
        for j in range(16):
            p = int(ptrs[j])
            if p < 0:
                continue
            meta = int(nodes[p, OFF_META : OFF_META + 1].view(np.int32)[0])
            t3[k * 16 + j, 118] = float(meta)
            if meta != 0:
                continue
            _decode_top_row(nodes, p, t3[k * 16 + j])
            any_inner = True
    if not any_inner:
        return None

    def bf(x):
        return x.astype(ml_dtypes.bfloat16).astype(np.float32)

    hi = bf(t3)
    r1 = t3 - hi
    mid = bf(r1)
    lo = bf(r1 - mid)
    assert ((hi + (mid + lo)) == t3).all(), "3-limb split must be exact"
    return np.stack([hi, mid, lo])


def derive_top16(nodes: np.ndarray) -> np.ndarray | None:
    """Decode the root's 16 child rows into a slot-indexed (16, 119) float
    table for the gather-free traversal prestep (ops.traverse_wide16.
    prestep16): [anchor 3 | scale 3 | qlo 48 | qhi 48 | ptrs 16 | meta 1],
    all plain f32 values (ints exact below 2^24) so a select chain can
    reassemble any slot's fields without bitcasts.  Returns None when the
    root is not an inner node (tiny scenes).  Slots that are absent or not
    inner get meta=1 so the prestep's level-2 never descends them."""
    if nodes.shape[0] < 2 or int(nodes[0, OFF_META : OFF_META + 1].view(np.int32)[0]) != 0:
        return None
    if nodes.shape[0] >= (1 << 24):   # ptrs must stay exact as f32
        return None
    root_ptrs = nodes[0, OFF_PTRS : OFF_PTRS + 16].view(np.int32)
    top = np.zeros((WIDTH, TOP_COLS), np.float32)
    top[:, 118] = 1.0
    for k in range(WIDTH):
        p = int(root_ptrs[k])
        if p < 0:
            continue
        meta = int(nodes[p, OFF_META : OFF_META + 1].view(np.int32)[0])
        top[k, 118] = float(meta)
        if meta != 0:
            continue
        _decode_top_row(nodes, p, top[k])
    return top


def build_scene_wide16(positions: np.ndarray, tri_records: np.ndarray,
                       leaf_size: int = 4, quality: int | None = None,
                       leaf8: bool | None = None) -> Wide16:
    """``quality`` 1 (default) = SBVH spatial splits in the native builder
    (tinybvh ``BuildHQ`` family — fewer overlapping nodes, fewer arrivals
    per ray); 0 = plain binned SAH.  The numpy fallback is always binned.
    With SBVH the returned ``order`` is a reference list (length >= tri
    count, duplicate triangle ids allowed); hosts permute attribute tables
    by it, which handles repeats naturally.  ``UWPT_BVH_QUALITY`` overrides
    the default (A/B harness knob).

    ``leaf8`` selects the 48-float-row variant (8-triangle leaves, half
    the gather traffic and leaf arithmetic per arrival — see the ROW8 block
    comment); ``UWPT_WIDE16_LEAF8`` overrides the default.

    ``UWPT_COLLAPSE=dp|greedy`` selects the wide-collapse strategy in the
    native builder (quality bit 2): ``dp`` = the SAH-optimal
    Ylitie-style dynamic program minimizing SA-weighted expected
    arrivals (fuller leaves, higher fan-out), ``greedy`` = the
    largest-area expansion.
    """
    import os

    from unity_webgpu_pathtracer_tpu.accel.native import native_wide16_or_none

    if quality is None:
        quality = int(os.environ.get("UWPT_BVH_QUALITY", "1"))
    if quality in (0, 1) and os.environ.get("UWPT_COLLAPSE", "greedy") == "dp":
        quality |= 2
    if leaf8 is None:
        leaf8 = os.environ.get("UWPT_WIDE16_LEAF8", "0") == "1"
    cache_path = _bvh_cache_path(positions, tri_records, leaf_size, quality,
                                 leaf8)
    if cache_path is not None and os.path.exists(cache_path):
        try:
            z = np.load(cache_path)
            w = Wide16(nodes=z["nodes"], depth=int(z["depth"]),
                       order=z["order"])
            CACHE_STATS["hit"] += 1
            return w
        except Exception:
            pass  # corrupt/partial file: rebuild and overwrite below
    CACHE_STATS["miss"] += 1
    native = native_wide16_or_none(positions, tri_records, leaf_size,
                                   quality=quality, leaf8=leaf8)
    if native is not None:
        rows, depth, order = native
        assert depth < MAX_DEPTH, f"tree depth {depth} >= {MAX_DEPTH}"
        w = Wide16(nodes=rows, depth=depth, order=order)
    else:
        bvh = build_bvh2(positions, leaf_size=leaf_size)
        attr_index = np.arange(positions.shape[0], dtype=np.int32)
        w = build_wide16(bvh, tri_records, attr_index, leaf8=leaf8)
    if cache_path is not None:
        _bvh_cache_store(cache_path, w)
    return w


# Bump when the emitted row format or builder semantics change so stale
# cache entries can never be loaded into a newer consumer.
_BVH_CACHE_VERSION = 1

# Observability: build_scene_wide16 counts disk-cache hits/misses here so
# bench.py can report `bvh_cache` in its JSON line (a silently cold cache
# otherwise reads as a scene-build regression).
CACHE_STATS = {"hit": 0, "miss": 0}


def _bvh_cache_path(positions, tri_records, leaf_size, quality, leaf8):
    """Content-keyed disk-cache path for built wide16 tables, or None.

    The SBVH+collapse+emit of a 1M-tri scene runs ~5s single-threaded (the
    reference pays the same in tinybvh and Unity hides it in the Library
    cache); repeated startups of the same scene load in ~0.2s instead.
    The key covers every build input: geometry bytes, build options, env
    knobs the native builder reads internally (UWPT_COLLAPSE_CNODE — the
    DP collapse cost weight, bvh_builder.cpp:1491 — changes the emitted
    table, so sweeping it with a warm cache must miss), the builder
    version, and the native builder's SOURCE content (bvh_builder.cpp
    sha1) since its code determines the output — keying on source rather
    than the .so's size+mtime makes cached tables portable across
    environments (the lib is rebuilt per machine; a committed cache would
    otherwise never hit).  ``UWPT_BVH_CACHE=0`` disables;
    ``UWPT_BVH_CACHE_DIR`` relocates (default ``<checkout>/.bvh_cache``,
    listed in ``.gitignore``).
    """
    import hashlib
    import os

    if os.environ.get("UWPT_BVH_CACHE", "1") == "0":
        return None
    # Every env var bvh_builder.cpp resolves at build time must be part of
    # the key; grep the C++ for getenv when adding knobs.
    c_node = os.environ.get("UWPT_COLLAPSE_CNODE", "")
    from unity_webgpu_pathtracer_tpu.compile_cache import CHECKOUT_DIR

    cache_dir = os.environ.get("UWPT_BVH_CACHE_DIR") or os.path.join(
        CHECKOUT_DIR, ".bvh_cache")
    try:
        os.makedirs(cache_dir, exist_ok=True)
    except OSError:
        return None
    from unity_webgpu_pathtracer_tpu.accel.native import _LIB_PATH, _SRC_PATH

    try:
        os.stat(_LIB_PATH)  # native lib present?
        with open(_SRC_PATH, "rb") as f:
            lib_id = "src:" + hashlib.sha1(f.read()).hexdigest()[:16]
    except OSError:
        lib_id = "numpy-fallback"
    h = hashlib.sha1()
    h.update(np.ascontiguousarray(positions, np.float32).tobytes())
    h.update(np.ascontiguousarray(tri_records, np.float32).tobytes())
    h.update(f"v{_BVH_CACHE_VERSION}|{leaf_size}|{quality}|{int(leaf8)}|"
             f"cnode={c_node}|{lib_id}".encode())
    return os.path.join(cache_dir, f"wide16-{h.hexdigest()}.npz")


def _bvh_cache_store(path, w: "Wide16"):
    import os
    import tempfile

    try:
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path),
                                   suffix=".tmp")
        os.close(fd)
        np.savez(tmp, nodes=w.nodes, depth=np.int32(w.depth), order=w.order)
        # np.savez appends .npz to names without it.
        src = tmp + ".npz" if os.path.exists(tmp + ".npz") else tmp
        os.replace(src, path)
        if os.path.exists(tmp):
            os.unlink(tmp)
    except OSError:
        pass


# ---------------------------------------------------------------------- TLAS
def emit_tlas_rows16(instances, blas_bounds, blas_root: dict, tlas_cap: int,
                     row_f: int = ROW):
    """Emit the 16-wide TLAS rows, zero-padded to ``tlas_cap``.
    Returns (rows, depth, l2w, w2l). Mirrors wide8's
    ``emit_tlas_rows`` (reference role: ``BVHScene.cs:671-757``).
    ``row_f`` selects the row width (96 classic / 48 leaf8); instance and
    inner TLAS rows use only words < 48 either way."""
    ni = len(instances)
    inst_aabb_min = np.zeros((ni, 3), np.float32)
    inst_aabb_max = np.zeros((ni, 3), np.float32)
    l2w = np.zeros((ni, 12), np.float32)
    w2l = np.zeros((ni, 12), np.float32)
    for i, (mesh_id, transform, _mat) in enumerate(instances):
        t = np.asarray(transform, np.float32).reshape(4, 4)
        lo, hi = blas_bounds[mesh_id]
        corners = np.array(
            [[x, y, z] for x in (lo[0], hi[0]) for y in (lo[1], hi[1])
             for z in (lo[2], hi[2])], np.float32)
        wc = corners @ t[:3, :3].T + t[:3, 3]
        inst_aabb_min[i] = wc.min(0)
        inst_aabb_max[i] = wc.max(0)
        l2w[i] = t[:3, :4].reshape(-1)
        w2l[i] = np.linalg.inv(t)[:3, :4].reshape(-1)

    fake_tris = np.stack(
        [inst_aabb_min, inst_aabb_max, (inst_aabb_min + inst_aabb_max) * 0.5],
        axis=1,
    )
    tb = build_bvh2(fake_tris, leaf_size=1)
    starts, counts = _subtree_ranges(tb)

    rows: list[np.ndarray] = []
    max_depth = [0]

    def emit_inst(inst_i: int) -> int:
        my = len(rows)
        row = np.zeros(row_f, np.float32)
        rows.append(row)
        mesh_id = instances[inst_i][0]
        row[OFF_META] = _f32(-(inst_i + 1))
        row[OFF_W2L : OFF_W2L + 12] = w2l[inst_i]
        row[OFF_BLAS] = _f32(blas_root[mesh_id])
        return my

    def sa(c):
        d = np.maximum(tb.nmax[c] - tb.nmin[c], 0.0)
        return float(d[0] * d[1] + d[1] * d[2] + d[2] * d[0])

    def emit(node: int, depth: int) -> int:
        max_depth[0] = max(max_depth[0], depth)
        if counts[node] == 1:
            return emit_inst(int(tb.order[starts[node]]))
        my = len(rows)
        row = np.zeros(row_f, np.float32)
        rows.append(row)
        kids = _collapse16(tb, node, counts)
        # Every instance needs its own row: expand inner children fully
        # while slots remain.
        changed = True
        while changed:
            changed = False
            for i, c in enumerate(list(kids)):
                if tb.left[c] >= 0 and len(kids) < WIDTH:
                    kids.pop(i)
                    kids.extend([tb.left[c], tb.left[c] + 1])
                    changed = True
                    break
        slots = sorted(kids, key=sa, reverse=True) + [None] * (WIDTH - len(kids))
        boxes = [None if c is None else (tb.nmin[c], tb.nmax[c]) for c in slots]
        _quantize_node(row, tb.nmin[node], tb.nmax[node], boxes)
        ptrs = np.full(WIDTH, -1, np.int32)
        for k, c in enumerate(slots):
            if c is not None:
                ptrs[k] = emit(c, depth + 1)
        row[OFF_PTRS : OFF_PTRS + 16] = ptrs.view(np.float32)
        return my

    emit(0, 1)
    assert len(rows) <= tlas_cap, f"TLAS rows {len(rows)} > cap {tlas_cap}"
    out = np.zeros((tlas_cap, row_f), np.float32)
    out[: len(rows)] = np.stack(rows)
    return out, max_depth[0], l2w, w2l


def build_tlas_wide16(blas: list, blas_bounds, instances,
                      attr_bases: list[int] | None = None):
    """Two-level unified table (16-wide TLAS over instance AABBs, BLAS
    tables rebased at immutable offsets after it — transform-only updates
    re-emit only the TLAS rows, as in wide8). Returns
    ``(Wide16, l2w, w2l, TlasLayout)``."""
    from unity_webgpu_pathtracer_tpu.accel.wide8 import TlasLayout, tlas_capacity

    cap = tlas_capacity(len(instances))
    ref_meshes = []
    for mesh_id, _t, _m in instances:
        if mesh_id not in ref_meshes:
            ref_meshes.append(mesh_id)
    blas_root: dict[int, int] = {}
    offset = cap
    blas_depth = 0
    tables = []
    row_f = ROW
    for mesh_id in ref_meshes:
        t = np.array(blas[mesh_id].nodes)
        row_f = t.shape[1]
        slots = WIDTH if row_f == ROW else LEAF8
        off_idx = OFF_IDX if row_f == ROW else OFF_IDX8
        meta = t[:, OFF_META].view(np.int32)
        inner = meta == 0
        ptrs = t[:, OFF_PTRS : OFF_PTRS + 16].view(np.int32)
        ptrs[inner] = np.where(ptrs[inner] >= 0, ptrs[inner] + offset, -1)
        t[:, OFF_PTRS : OFF_PTRS + 16] = ptrs.view(np.float32)
        if attr_bases is not None:
            idx = t[:, off_idx : off_idx + slots].view(np.int32)
            leaf = meta > 0
            idx[leaf] = np.where(
                idx[leaf] >= 0, idx[leaf] + attr_bases[mesh_id], -1
            )
            t[:, off_idx : off_idx + slots] = idx.view(np.float32)
        blas_root[mesh_id] = offset
        blas_depth = max(blas_depth, blas[mesh_id].depth)
        tables.append(t)
        offset += t.shape[0]
    assert all(t.shape[1] == row_f for t in tables), \
        "mixed wide16 row widths across BLAS tables"

    tlas_rows, tdepth, l2w, w2l = emit_tlas_rows16(
        instances, blas_bounds, blas_root, cap, row_f=row_f)
    nodes = np.concatenate([tlas_rows] + tables, axis=0)
    depth = tdepth + blas_depth + 1
    assert depth < MAX_DEPTH, f"TLAS+BLAS depth {depth} >= {MAX_DEPTH}"
    layout = TlasLayout(tlas_cap=cap, blas_root=blas_root,
                        blas_depth=blas_depth, tlas_depth0=tdepth)
    return Wide16(nodes=nodes, depth=depth), l2w, w2l, layout


# ----------------------------------------------------------------- validation
def decode_leaf_tris(row: np.ndarray):
    """Host-side decode of one leaf row -> (cnt, recs (cnt,9), idx (cnt,)).
    Dispatches on row width (96 = classic 16-slot, 48 = leaf8)."""
    slots = WIDTH if row.shape[0] == ROW else LEAF8
    off_idx = OFF_IDX if slots == WIDTH else OFF_IDX8
    cnt = int(row[OFF_META : OFF_META + 1].view(np.int32)[0])
    nw = 9 * slots // 2
    words = row[OFF_TRIS : OFF_TRIS + nw].view(np.uint32).reshape(9, slots // 2)
    # SPLIT slot order: word w = (slot w | slot w+slots/2 << 16).
    halves = np.concatenate(
        [(words & 0xFFFF).astype(np.uint16), (words >> 16).astype(np.uint16)],
        axis=-1,
    )                                                   # (9, slots)
    comps = halves.view(np.float16).astype(np.float32)
    comps[6:9] += row[0:3][:, None]
    idx = row[off_idx : off_idx + slots].view(np.int32)
    return cnt, comps[:, :cnt].T, idx[:cnt]


def validate_wide16(w: Wide16, tri_count: int):
    """Leaf coverage, quantized containment, stack-depth bound.

    SBVH trees (``order`` longer than ``tri_count``) duplicate straddling
    triangles across leaves: coverage becomes >= 1 per triangle (counted in
    original-id space via ``order``) and whole-triangle containment in the
    child box no longer holds (leaf boxes bound clipped *fragments*), so
    the containment check is skipped for them.
    """
    spatial = w.order is not None and w.order.shape[0] != tri_count
    nodes = w.nodes
    meta = nodes[:, OFF_META].view(np.int32)
    seen = np.zeros(tri_count, np.int32)
    stack = [0]
    while stack:
        r = stack.pop()
        m = meta[r]
        if m > 0:
            cnt, _recs, idx = decode_leaf_tris(nodes[r])
            if spatial:
                seen[w.order[idx]] += 1
            else:
                seen[idx] += 1
        elif m < 0:
            blas = int(nodes[r, OFF_BLAS].view(np.int32))
            stack.append(blas)
        else:
            anchor = nodes[r, 0:3]
            e = int(nodes[r, OFF_EXPS : OFF_EXPS + 1].view(np.int32)[0])
            ex = np.array([e & 255, (e >> 8) & 255, (e >> 16) & 255]) - 127
            scale = np.ldexp(np.ones(3, np.float32), ex)
            qb = (nodes[r, OFF_QBOX : OFF_QBOX + 24].view(np.uint8)
                  .reshape(6, 16)[:, PERM_Q])   # SPLIT order -> slot order
            ptrs = nodes[r, OFF_PTRS : OFF_PTRS + 16].view(np.int32)
            for k in range(WIDTH):
                if ptrs[k] < 0:
                    continue
                lo = anchor + qb[0:3, k] * scale
                hi = anchor + qb[3:6, k] * scale
                child = ptrs[k]
                cm = meta[child]
                if cm > 0 and not spatial:
                    _cnt, recs, _idx = decode_leaf_tris(nodes[child])
                    v0 = recs[:, 6:9]
                    v1 = v0 + recs[:, 3:6]
                    v2 = v0 + recs[:, 0:3]
                    pts = np.concatenate([v0, v1, v2])
                    assert (pts >= lo - 1e-2 - 1e-3 * np.abs(pts)).all(), \
                        "leaf not contained"
                    assert (pts <= hi + 1e-2 + 1e-3 * np.abs(pts)).all(), \
                        "leaf not contained"
                stack.append(child)
    if spatial:
        assert (seen >= 1).all(), "leaf coverage broken (SBVH refs)"
    else:
        assert (seen == 1).all(), "leaf coverage broken"
    assert w.depth < MAX_DEPTH
