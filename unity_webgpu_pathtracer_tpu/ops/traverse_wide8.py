"""8-wide quantized stack traversal (consumes ``accel.wide8``).

One gather per arrival, like the 4-ary skip backend — but a small per-lane
stack of ``(row << 8) | remaining-children-bitmask`` entries replaces the
DFS skip chain, so subtrees whose quantized boxes missed are never gathered
at all (the reference's CWBVH traversal keeps the same nodeGroup bitmask in
registers, ``util/bvh.hlsl:141-197``; here the "registers" are (B, D)
arrays and push/pop are one-hot selects — no per-lane dynamic scatters).

Children are visited in ``k ^ ray_octant`` slot order (the builder assigns
slots by centroid octant), giving near-first ordering for every ray
direction from ONE table — the 4-ary format needed 8 octant-specialized
copies of the whole table to approximate this.

A revisit pops ``(row, mask)`` and re-gathers the row, re-testing the
surviving children against the CURRENT best t — stale subtrees are pruned
for one cheap arrival instead of being descended.

Instancing (TLAS): instance rows switch the lane into instance space
(unnormalized direction transform keeps t world-valid, the reference's
trick in ``tlas.hlsl:131-135``); the lane records the stack height at
entry and reverts to world space when a pop crosses below it.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from unity_webgpu_pathtracer_tpu.accel.wide8 import MAX_DEPTH
from unity_webgpu_pathtracer_tpu.ops.intersect import DET_EPS, T_MIN
from unity_webgpu_pathtracer_tpu.utils.math import FAR_PLANE, safe_rcp

DONE = -1


class Wide8State(NamedTuple):
    ptr: jnp.ndarray       # (B,) int32 current row; DONE when finished
    pend: jnp.ndarray      # (B,) int32 pending-children mask (0xFF = fresh)
    sp: jnp.ndarray        # (B,) int32 stack height
    stack: jnp.ndarray     # (MAX_DEPTH, B) int32 (row << 8) | mask — level-major
                           # so each level is a full (B,) lane row (a (B, D)
                           # layout pads D=24 to 128 lanes: 5x bandwidth)
    t: jnp.ndarray         # (B,) best hit distance
    u: jnp.ndarray
    v: jnp.ndarray
    tri: jnp.ndarray       # (B,) int32 attribute row of best hit (-1 none)
    found: jnp.ndarray     # (B,) bool
    inst: jnp.ndarray      # (B,) int32 current instance (-1 = world space)
    hit_inst: jnp.ndarray  # (B,) int32 instance of the best hit
    sp_enter: jnp.ndarray  # (B,) int32 stack height at instance entry
    local_o: jnp.ndarray   # (B,3)
    local_d: jnp.ndarray   # (B,3)
    local_inv: jnp.ndarray # (B,3)


def init_state8(b, t_max, ptr0: int = 0, depth: int = MAX_DEPTH) -> Wide8State:
    """``depth`` sizes the (D, B) stack; pass the scene's actual tree depth
    (``scene.stack_levels.shape[0]``) — every arrival reads/writes all D
    planes, so the format cap (24) costs ~2x over a real ~11-deep tree."""
    z3 = jnp.zeros((b, 3), jnp.float32)
    return Wide8State(
        ptr=jnp.full((b,), ptr0, jnp.int32),
        pend=jnp.full((b,), 0xFF, jnp.int32),
        sp=jnp.zeros((b,), jnp.int32),
        stack=jnp.zeros((depth, b), jnp.int32),
        t=jnp.broadcast_to(t_max, (b,)).astype(jnp.float32),
        u=jnp.zeros((b,), jnp.float32),
        v=jnp.zeros((b,), jnp.float32),
        tri=jnp.full((b,), -1, jnp.int32),
        found=jnp.zeros((b,), bool),
        inst=jnp.full((b,), -1, jnp.int32),
        hit_inst=jnp.full((b,), -1, jnp.int32),
        sp_enter=jnp.zeros((b,), jnp.int32),
        local_o=z3,
        local_d=z3,
        local_inv=z3,
    )


def _u32(x):
    return jax.lax.bitcast_convert_type(x, jnp.uint32)


def _i32(x):
    return jax.lax.bitcast_convert_type(x, jnp.int32)


def _unpack_u8x8(words: jnp.ndarray) -> jnp.ndarray:
    """(B, 2) uint32 -> (B, 8) float32 bytes (little-endian)."""
    parts = [
        ((words[:, w] >> (8 * i)) & 0xFF).astype(jnp.float32)
        for w in range(2)
        for i in range(4)
    ]
    return jnp.stack(parts, axis=-1)


def _unpack_f16x8(words: jnp.ndarray) -> jnp.ndarray:
    """(B, 4) uint32 -> (B, 8) float32 from packed float16 halves."""
    halves = jnp.stack(
        [
            ((words[:, w] >> (16 * i)) & 0xFFFF).astype(jnp.uint16)
            for w in range(4)
            for i in range(2)
        ],
        axis=-1,
    )
    return jax.lax.bitcast_convert_type(halves, jnp.float16).astype(jnp.float32)


def octant_index(d):
    return (
        (d[..., 0] < 0).astype(jnp.int32)
        + 2 * (d[..., 1] < 0).astype(jnp.int32)
        + 4 * (d[..., 2] < 0).astype(jnp.int32)
    )


def arrival_step8(nodes, o, d, inv, s: Wide8State, active=None,
                  has_instances: bool = True) -> Wide8State:
    """One arrival for every lane: gather the current row, process it by
    kind (inner / leaf / instance), and advance ptr via descend or pop."""
    b = s.ptr.shape[0]
    live = s.ptr >= 0
    if active is not None:
        live = live & active
    idx = jnp.where(live, s.ptr, 0)
    row = nodes[idx]                                             # (B, 48)
    meta = _i32(row[:, 3])
    is_leaf = live & (meta > 0)
    is_inst = live & (meta < 0)
    is_inner = live & (meta == 0)

    if has_instances:
        in_blas = s.inst >= 0
        o_ = jnp.where(in_blas[:, None], s.local_o, o)
        d_ = jnp.where(in_blas[:, None], s.local_d, d)
        inv_ = jnp.where(in_blas[:, None], s.local_inv, inv)
    else:
        o_, d_, inv_ = o, d, inv
    oct_ = octant_index(d_)

    anchor = row[:, 0:3]

    # ---- inner: decode 8 quantized child boxes, slab-test, mask ----
    eword = _i32(row[:, 4])
    scale = jnp.stack(
        [
            jax.lax.bitcast_convert_type(
                (((eword >> (8 * c)) & 0xFF) << 23), jnp.float32
            )
            for c in range(3)
        ],
        axis=-1,
    )                                                            # (B, 3)
    # Whole-slice bitcast + reshape: per-column extracts of the (B, 48)
    # gather result can lower to strided slice-loops; one bitcast of the
    # contiguous slice is cheap.
    qbytes = jax.lax.bitcast_convert_type(
        row[:, 8:20], jnp.uint8).reshape(b, 48).astype(jnp.float32)
    t_near = jnp.zeros((b, 8), jnp.float32)
    t_far = jnp.broadcast_to(s.t[:, None], (b, 8))
    for c in range(3):
        qlo = qbytes[:, 8 * c : 8 * c + 8]
        qhi = qbytes[:, 24 + 8 * c : 32 + 8 * c]
        lo = anchor[:, c : c + 1] + qlo * scale[:, c : c + 1]
        hi = anchor[:, c : c + 1] + qhi * scale[:, c : c + 1]
        tl = (lo - o_[:, c : c + 1]) * inv_[:, c : c + 1]
        th = (hi - o_[:, c : c + 1]) * inv_[:, c : c + 1]
        t_near = jnp.maximum(t_near, jnp.minimum(tl, th))
        t_far = jnp.minimum(t_far, jnp.maximum(tl, th))
    hit = t_near <= t_far                                        # (B, 8)
    # Empty slots must be masked explicitly: the min/max slab test is
    # symmetric, so an inverted sentinel box tests like a full box.
    ptrs = _i32(row[:, 20:28])                                   # (B, 8)
    hit = hit & (ptrs >= 0)
    bits8 = (1 << jnp.arange(8, dtype=jnp.int32))[None, :]
    mask = jnp.sum(jnp.where(hit, bits8, 0), axis=1)             # row reduce
    mask = mask & s.pend

    # Nearest-first pick: visit slots in (k ^ octant) order (builder put
    # children in octant slots), descending k so k=0 wins the select chain.
    first_slot = jnp.full((b,), -1, jnp.int32)
    for k in range(7, -1, -1):
        slot = k ^ oct_
        has_bit = ((mask >> slot) & 1) > 0
        first_slot = jnp.where(has_bit, slot, first_slot)
    found_child = is_inner & (first_slot >= 0)

    onehot_first = jnp.arange(8, dtype=jnp.int32)[None, :] == first_slot[:, None]
    child_ptr = jnp.sum(jnp.where(onehot_first, ptrs, 0), axis=1)
    remaining = mask & ~(1 << jnp.maximum(first_slot, 0))

    # Push with a one-hot select over the stack levels. Two entry kinds:
    # several children remain -> (row << 8) | mask, popped as a revisit
    # (re-gather + re-test with the improved t); exactly ONE remains (the
    # common case) -> its row pointer directly with mask 0, so the pop
    # skips the parent re-gather entirely.
    push = found_child & (remaining > 0)
    iota8b = (remaining[:, None] >> jnp.arange(8, dtype=jnp.int32)[None, :]) & 1
    one_left = jnp.sum(iota8b, axis=1) == 1
    direct_ptr = jnp.sum(ptrs * iota8b, axis=1)
    entry = jnp.where(one_left, direct_ptr << 8, (idx << 8) | remaining)
    levels = jnp.arange(s.stack.shape[0], dtype=jnp.int32)[:, None]
    stack = jnp.where(
        (levels == s.sp[None, :]) & push[None, :], entry[None, :], s.stack
    )
    sp = s.sp + push.astype(jnp.int32)

    # ---- leaf: decode f16 anchored triangle records, Möller-Trumbore ----
    halves = jax.lax.bitcast_convert_type(
        row[:, 4:40], jnp.float16).reshape(b, 72).astype(jnp.float32)
    comp = [halves[:, 8 * c : 8 * c + 8] for c in range(9)]
    e2x, e2y, e2z = comp[0], comp[1], comp[2]
    e1x, e1y, e1z = comp[3], comp[4], comp[5]
    v0x = comp[6] + anchor[:, 0:1]
    v0y = comp[7] + anchor[:, 1:2]
    v0z = comp[8] + anchor[:, 2:3]
    dx, dy, dz = d_[:, 0:1], d_[:, 1:2], d_[:, 2:3]
    ox, oy, oz = o_[:, 0:1], o_[:, 1:2], o_[:, 2:3]

    rx = dy * e2z - dz * e2y
    ry = dz * e2x - dx * e2z
    rz = dx * e2y - dy * e2x
    a = e1x * rx + e1y * ry + e1z * rz                           # (B, 8)
    finv = 1.0 / jnp.where(jnp.abs(a) < DET_EPS, 1.0, a)
    sx, sy, sz = ox - v0x, oy - v0y, oz - v0z
    uu = finv * (sx * rx + sy * ry + sz * rz)
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    vv = finv * (dx * qx + dy * qy + dz * qz)
    tt = finv * (e2x * qx + e2y * qy + e2z * qz)
    lanes = jnp.arange(8)
    cnt = meta
    valid = (
        is_leaf[:, None]
        & (lanes[None, :] < cnt[:, None])
        & (jnp.abs(a) > DET_EPS)
        & (uu >= 0.0) & (uu <= 1.0)
        & (vv >= 0.0) & (uu + vv <= 1.0)
        & (tt > T_MIN) & (tt < s.t[:, None])
    )
    tt = jnp.where(valid, tt, FAR_PLANE)
    attrs = _i32(row[:, 40:48])
    # Lane-wise best hit via argmin + one-hot row reductions (column
    # extracts tt[:, k] would each materialize a strided slice-loop).
    best = jnp.argmin(tt, axis=1)
    onehot_b = jnp.arange(8, dtype=jnp.int32)[None, :] == best[:, None]
    t_cand = jnp.sum(jnp.where(onehot_b, tt, 0.0), axis=1)
    improved = t_cand < s.t
    t_new = jnp.where(improved, t_cand, s.t)
    u_new = jnp.where(improved, jnp.sum(jnp.where(onehot_b, uu, 0.0), axis=1), s.u)
    v_new = jnp.where(improved, jnp.sum(jnp.where(onehot_b, vv, 0.0), axis=1), s.v)
    tri_new = jnp.where(improved, jnp.sum(jnp.where(onehot_b, attrs, 0), axis=1), s.tri)
    found_new = s.found | improved
    hit_inst = jnp.where(improved, s.inst, s.hit_inst)

    # ---- instance: enter instance space, jump to the BLAS root ----
    if not has_instances:
        need_pop = (is_inner & ~found_child) | is_leaf
        has = sp > 0
        top = jnp.sum(
            jnp.where(levels == (sp - 1)[None, :], stack, 0), axis=0
        )
        pop_ptr = jnp.where(has, top >> 8, DONE)
        pop_pend = jnp.where((top & 0xFF) == 0, 0xFF, top & 0xFF)  # 0 = direct entry
        sp_after = jnp.where(need_pop & has, sp - 1, sp)
        new_ptr = jnp.where(found_child, child_ptr,
                            jnp.where(need_pop, pop_ptr, s.ptr))
        new_pend = jnp.where(found_child, 0xFF,
                             jnp.where(need_pop, jnp.where(has, pop_pend, 0xFF),
                                       s.pend))
        return s._replace(
            ptr=jnp.where(live, new_ptr, s.ptr),
            pend=jnp.where(live, new_pend, s.pend),
            sp=jnp.where(live, sp_after, s.sp),
            stack=stack,
            t=t_new, u=u_new, v=v_new, tri=tri_new, found=found_new,
        )

    inst_id = jnp.where(is_inst, -meta - 1, 0)
    w2l = row[:, 4:16]
    lo3 = jnp.stack(
        [
            w2l[:, 0] * o[:, 0] + w2l[:, 1] * o[:, 1] + w2l[:, 2] * o[:, 2] + w2l[:, 3],
            w2l[:, 4] * o[:, 0] + w2l[:, 5] * o[:, 1] + w2l[:, 6] * o[:, 2] + w2l[:, 7],
            w2l[:, 8] * o[:, 0] + w2l[:, 9] * o[:, 1] + w2l[:, 10] * o[:, 2] + w2l[:, 11],
        ],
        axis=-1,
    )
    ld3 = jnp.stack(
        [
            w2l[:, 0] * d[:, 0] + w2l[:, 1] * d[:, 1] + w2l[:, 2] * d[:, 2],
            w2l[:, 4] * d[:, 0] + w2l[:, 5] * d[:, 1] + w2l[:, 6] * d[:, 2],
            w2l[:, 8] * d[:, 0] + w2l[:, 9] * d[:, 1] + w2l[:, 10] * d[:, 2],
        ],
        axis=-1,
    )
    e3 = is_inst[:, None]
    local_o = jnp.where(e3, lo3, s.local_o)
    local_d = jnp.where(e3, ld3, s.local_d)
    local_inv = jnp.where(e3, safe_rcp(ld3), s.local_inv)
    inst = jnp.where(is_inst, inst_id, s.inst)
    sp_enter = jnp.where(is_inst, sp, s.sp_enter)
    blas_root = _i32(row[:, 16])

    # ---- advance: descend, enter BLAS, or pop ----
    need_pop = (is_inner & ~found_child) | is_leaf
    has = sp > 0
    top = jnp.sum(
        jnp.where(levels == (sp - 1)[None, :], stack, 0), axis=0
    )
    pop_ptr = jnp.where(has, top >> 8, DONE)
    pop_pend = jnp.where((top & 0xFF) == 0, 0xFF, top & 0xFF)  # 0 = direct entry
    sp_after = jnp.where(need_pop & has, sp - 1, sp)
    # Popping below the instance-entry height returns the lane to world
    # space (all entries at or above it are BLAS-local).
    exited = need_pop & (s.inst >= 0) & (sp_after < sp_enter)
    inst = jnp.where(exited | (need_pop & ~has), -1, inst)

    new_ptr = jnp.where(
        is_inst, blas_root,
        jnp.where(found_child, child_ptr,
                  jnp.where(need_pop, pop_ptr, s.ptr)),
    )
    new_pend = jnp.where(
        is_inst | found_child, 0xFF,
        jnp.where(need_pop, jnp.where(has, pop_pend, 0xFF), s.pend),
    )

    return Wide8State(
        ptr=jnp.where(live, new_ptr, s.ptr),
        pend=jnp.where(live, new_pend, s.pend),
        sp=jnp.where(live, sp_after, s.sp),
        stack=stack,
        t=t_new, u=u_new, v=v_new, tri=tri_new, found=found_new,
        inst=jnp.where(live, inst, s.inst),
        hit_inst=hit_inst,
        sp_enter=jnp.where(live, sp_enter, s.sp_enter),
        local_o=local_o, local_d=local_d, local_inv=local_inv,
    )


def _traverse(scene, origins, directions, t_max, any_hit: bool):
    b = origins.shape[0]
    nodes = scene.wide8_nodes                                    # (N, 48)
    inv = safe_rcp(directions)
    lv = getattr(scene, "stack_levels", None)   # test FakeScenes lack it
    init = init_state8(b, t_max, depth=MAX_DEPTH if lv is None else lv.shape[0])
    has_inst = scene.inst_w2l.shape[0] > 0

    def cond(s):
        live = s.ptr >= 0
        if any_hit:
            live = live & ~s.found
        return jnp.any(live)

    def body(s):
        active = None if not any_hit else ~s.found
        return arrival_step8(nodes, origins, directions, inv, s, active,
                             has_instances=has_inst)

    return jax.lax.while_loop(cond, body, init)


def closest_hit(scene, origins, directions):
    """Returns ``(t, bary (B,2), attr_row, instance)``."""
    s = _traverse(scene, origins, directions, jnp.float32(FAR_PLANE), False)
    return s.t, jnp.stack([s.u, s.v], axis=-1), s.tri, s.hit_inst


def occluded(scene, origins, directions, t_max):
    s = _traverse(scene, origins, directions, t_max, True)
    return s.found
