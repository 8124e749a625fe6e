"""CWBVH: the reference's compressed 8-wide format (parity artifact).

Emits the exact 80-byte / 5×float4 node records the reference traverses
(``tiny_bvh.h:5844-5968`` writes them, ``util/bvh.hlsl:61-124`` decodes):

* n0 = [p.x, p.y, p.z, bits(e_x | e_y<<8 | e_z<<16 | imask<<24)] — node
  origin, per-axis power-of-two quantization exponents
  ``e = ceil(log2((hi-lo)/255))`` (:5909-5911), inner-child mask;
* n1 = [childBase(uint), triBase(uint), meta(bytes 0-3), meta(bytes 4-7)]
  with meta = ``(1<<5)|(24+slot)`` for inner children and
  ``(unary(count)<<5)|firstTri`` for leaves (:5936-5951);
* n2..n4 = the 8 children's AABBs quantized to uint8 per axis, packed
  bytewise: n2=[qlox0-3, qlox4-7, qloy0-3, qloy4-7], n3=[qloz x8, qhix x8],
  n4=[qhiy x8, qhiz x8] (:5919-5931);
* triangles as ``[e2-v0? no: e2, e1, v0|bits(triIdx)]`` float4 triples
  (:5963-5968) — the same records the renderer's flat ``tris`` hold.

The byte-unpack decode trades arithmetic for 2.4x fewer bytes than the
fat-row format; this module serves as (a) the byte-exact reference-format exporter, (b) the
quantization-correctness oracle (decoded child bounds must conservatively
contain the exact bounds).
"""

from __future__ import annotations

import numpy as np

from unity_webgpu_pathtracer_tpu.accel.mbvh import LEAF_CNT_BITS, WIDTH


def _unary(count: int) -> int:
    # tinybvh stores leaf triangle counts in unary inside meta bits 5-7.
    return (1 << count) - 1


def build_cwbvh(bounds: np.ndarray, child: np.ndarray):
    """MBVH8 (accel.mbvh arrays, built with leaf_size ≤ 3) -> CWBVH nodes.

    Returns ``(nodes (N, 20) float32, tri_order (F',))``: node rows in the
    5xfloat4 layout above, plus the triangle permutation the format
    requires — like the reference conversion, each node's leaf triangles
    are re-emitted consecutively so the 5-bit meta offsets stay in range
    (``tiny_bvh.h:5952-5968``).  Leaf counts must be ≤ 3 (unary meta bits);
    the reference enforces this with ``SplitLeafs(3)``.
    """
    n = bounds.shape[0]
    nodes = np.zeros((n, 20), np.float32)
    iview = nodes.view(np.uint32)
    tri_order: list[int] = []

    for i in range(n):
        row = bounds[i].reshape(6, WIDTH)
        kids = child[i]
        used = kids != 0
        lo = np.where(used, row[0:3], np.inf).min(axis=1)
        hi = np.where(used, row[3:6], -np.inf).max(axis=1)
        ext = np.maximum(hi - lo, 0.0)
        # Per-axis power-of-two exponent: ceil(log2(ext/255)) (:5909-5911).
        with np.errstate(divide="ignore"):
            e = np.where(ext > 0, np.ceil(np.log2(ext / 255.0)), -80.0)
        e = np.clip(e, -80, 127).astype(np.int32)
        scale = np.exp2(e.astype(np.float64))

        nodes[i, 0:3] = lo
        imask = 0
        meta = np.zeros(8, np.uint8)
        inner_slots = [k for k in range(WIDTH) if kids[k] > 0]
        child_base = min((kids[k] - 1 for k in inner_slots), default=0)
        tri_base = len(tri_order)
        rel = 0
        for k in range(WIDTH):
            c = kids[k]
            if c > 0:
                slot = k
                imask |= 1 << slot
                meta[k] = (1 << 5) | (24 + slot)
            elif c < 0:
                off = (-c) // LEAF_CNT_BITS
                cnt = (-c) % LEAF_CNT_BITS
                if cnt > 3:
                    raise ValueError("CWBVH requires leaves of <=3 triangles "
                                     "(build the MBVH with leaf_size=3)")
                meta[k] = (_unary(cnt) << 5) | rel
                tri_order.extend(range(off, off + cnt))
                rel += cnt
        iview[i, 3] = (
            (np.uint32(e[0]) & 0xFF)
            | ((np.uint32(e[1]) & 0xFF) << 8)
            | ((np.uint32(e[2]) & 0xFF) << 16)
            | (np.uint32(imask) << 24)
        )
        iview[i, 4] = child_base
        iview[i, 5] = tri_base
        iview[i, 6] = int.from_bytes(meta[0:4].tobytes(), "little")
        iview[i, 7] = int.from_bytes(meta[4:8].tobytes(), "little")

        qlo = np.zeros((3, 8), np.uint8)
        qhi = np.zeros((3, 8), np.uint8)
        for a in range(3):
            s = scale[a] if scale[a] > 0 else 1.0
            ql = np.floor((row[a] - lo[a]) / s)
            qh = np.ceil((row[3 + a] - lo[a]) / s)
            qlo[a] = np.clip(np.where(used, ql, 0), 0, 255).astype(np.uint8)
            qhi[a] = np.clip(np.where(used, qh, 0), 0, 255).astype(np.uint8)
        packed = np.concatenate([qlo[0], qlo[1], qlo[2], qhi[0], qhi[1], qhi[2]])
        iview[i, 8:20] = np.frombuffer(packed.tobytes(), dtype=np.uint32)
    return nodes, np.asarray(tri_order, np.int32)


def build_cwbvh_from_positions(positions: np.ndarray):
    """Convenience: full reference-format pipeline from a triangle soup
    (BVH2 leaf<=3 -> MBVH8 -> CWBVH + reordered [e2,e1,v0|triIdx] records,
    mirroring ``BVH8_CWBVH::Build``)."""
    from unity_webgpu_pathtracer_tpu.accel import bvh2, mbvh

    tree = bvh2.build_bvh2(positions, leaf_size=3)
    bounds, child, order = mbvh.collapse_to_mbvh8(tree)
    nodes, local_order = build_cwbvh(bounds, child)
    final_order = order[local_order]
    pos = positions[final_order]
    v0 = pos[:, 0]
    recs = np.zeros((pos.shape[0], 12), np.float32)
    recs[:, 0:3] = pos[:, 2] - v0
    recs[:, 4:7] = pos[:, 1] - v0
    recs[:, 8:11] = v0
    recs[:, 11:12] = final_order[:, None].astype(np.int32).view(np.float32)
    return nodes, recs, final_order


def decode_child_bounds(nodes: np.ndarray):
    """Decode quantized child AABBs back to floats (the ``GetNodeInvDir`` /
    ``ExtractBytes`` path, ``bvh.hlsl:61-104``).  Returns (lo, hi) with
    shape (N, 3, 8)."""
    n = nodes.shape[0]
    iview = nodes.view(np.uint32)
    e = np.stack([
        (iview[:, 3] >> 0) & 0xFF,
        (iview[:, 3] >> 8) & 0xFF,
        (iview[:, 3] >> 16) & 0xFF,
    ], axis=1).astype(np.int32)
    e = (e ^ 0x80) - 0x80  # sign extend like bvh.hlsl:66-68
    scale = np.exp2(e.astype(np.float64)).astype(np.float32)
    origin = nodes[:, 0:3]
    bytes_ = np.frombuffer(
        np.ascontiguousarray(iview[:, 8:20]).tobytes(), dtype=np.uint8
    ).reshape(n, 48)
    qlo = bytes_[:, 0:24].reshape(n, 3, 8).astype(np.float32)
    qhi = bytes_[:, 24:48].reshape(n, 3, 8).astype(np.float32)
    lo = origin[:, :, None] + qlo * scale[:, :, None]
    hi = origin[:, :, None] + qhi * scale[:, :, None]
    return lo, hi


def validate_cwbvh(nodes: np.ndarray, bounds: np.ndarray, child: np.ndarray):
    """Quantization must be conservative: decoded boxes contain exact ones."""
    lo, hi = decode_child_bounds(nodes)
    for i in range(bounds.shape[0]):
        row = bounds[i].reshape(6, WIDTH)
        used = child[i] != 0
        if not used.any():
            continue
        exact_lo = row[0:3][:, used]
        exact_hi = row[3:6][:, used]
        assert (lo[i][:, used] <= exact_lo + 1e-4).all(), f"node {i} lo not conservative"
        assert (hi[i][:, used] >= exact_hi - 1e-4).all(), f"node {i} hi not conservative"
