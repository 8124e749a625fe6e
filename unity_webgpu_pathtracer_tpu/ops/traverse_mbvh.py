"""Batched 8-wide MBVH traversal as a ``lax.while_loop`` over a ray batch.

The batched re-architecture of the reference's per-thread CWBVH stack traversal
(``util/bvh.hlsl:126-215``): every ray in the batch carries a short stack of
child codes; one loop iteration pops an entry per ray and — fully masked, no
divergence — either slab-tests the 8 children of an inner node (one (B, 48)
row gather feeding an 8-lane test) or intersects the ≤4 triangles of a leaf
(one (B, 4, 9) gather + Möller-Trumbore).  Children are pushed far-to-near
(sorted by entry distance) so the LIFO pop order front-to-back culls like
the reference's octant ordering trick (``bvh.hlsl:158-160``).

Leaf codes: see ``accel.mbvh`` (inner = idx+1, leaf = -(off*16+cnt)).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from unity_webgpu_pathtracer_tpu.accel.mbvh import LEAF_CNT_BITS, WIDTH
from unity_webgpu_pathtracer_tpu.ops.intersect import DET_EPS, T_MIN
from unity_webgpu_pathtracer_tpu.utils.math import FAR_PLANE, safe_rcp

STACK_DEPTH = 64
MAX_LEAF = 4


class _TravState(NamedTuple):
    stack: jnp.ndarray   # (B, STACK_DEPTH) int32 child codes
    sp: jnp.ndarray      # (B,) int32 stack pointer
    t: jnp.ndarray       # (B,)
    u: jnp.ndarray       # (B,)
    v: jnp.ndarray       # (B,)
    slot: jnp.ndarray    # (B,) int32 best tri row (-1 = miss)
    found: jnp.ndarray   # (B,) bool (for any-hit early out)


def _init_state(b, t_max):
    stack = jnp.zeros((b, STACK_DEPTH), jnp.int32)
    stack = stack.at[:, 0].set(1)  # inner code for root node 0
    return _TravState(
        stack=stack,
        sp=jnp.ones((b,), jnp.int32),
        t=jnp.broadcast_to(t_max, (b,)).astype(jnp.float32),
        u=jnp.zeros((b,), jnp.float32),
        v=jnp.zeros((b,), jnp.float32),
        slot=jnp.full((b,), -1, jnp.int32),
        found=jnp.zeros((b,), bool),
    )


def _step(scene, origins, directions, inv_dir, s: _TravState, any_hit: bool):
    b = origins.shape[0]
    rows = jnp.arange(b)
    active = s.sp > 0
    if any_hit:
        active = active & ~s.found
    sp_pop = jnp.where(active, s.sp - 1, 0)
    code = jnp.where(active, s.stack[rows, sp_pop], 0)

    is_inner = code > 0
    is_leaf = code < 0

    # ---------------- inner: 8-wide slab test ----------------
    node = jnp.where(is_inner, code - 1, 0)
    bb = scene.bvh_bounds[node].reshape(b, 6, WIDTH)      # [lox,loy,loz,hix,hiy,hiz]
    kids = scene.bvh_child[node]                          # (B, 8)

    o = origins[:, :, None]
    inv = inv_dir[:, :, None]
    t_lo = (bb[:, 0:3] - o) * inv                         # (B, 3, 8)
    t_hi = (bb[:, 3:6] - o) * inv
    t_near = jnp.max(jnp.minimum(t_lo, t_hi), axis=1)     # (B, 8)
    t_far = jnp.min(jnp.maximum(t_lo, t_hi), axis=1)
    t_near = jnp.maximum(t_near, 0.0)
    t_far = jnp.minimum(t_far, s.t[:, None])
    hitmask = (t_near <= t_far) & (kids != 0) & is_inner[:, None]

    # Push far-to-near: ascending sort of (-entry distance for hits).
    sort_key = jnp.where(hitmask, t_near, -jnp.inf)
    order = jnp.argsort(sort_key, axis=-1, descending=True)   # far first, misses last
    kids_sorted = jnp.take_along_axis(kids, order, axis=-1)
    hit_sorted = jnp.take_along_axis(hitmask, order, axis=-1)
    push_pos = sp_pop[:, None] + jnp.cumsum(hit_sorted.astype(jnp.int32), axis=-1) - 1
    push_pos = jnp.where(hit_sorted, push_pos, STACK_DEPTH)   # dropped when masked
    stack = s.stack.at[rows[:, None], push_pos].set(kids_sorted, mode="drop")
    # STACK_DEPTH=64 covers an 8-wide tree of depth 9 (≥2^27 tris) pushing
    # 7 siblings per level; clamp defensively so sp can't run past the array.
    sp_inner = jnp.minimum(
        sp_pop + jnp.sum(hit_sorted, axis=-1).astype(jnp.int32), STACK_DEPTH
    )

    # ---------------- leaf: ≤4-wide Möller-Trumbore ----------------
    neg = jnp.where(is_leaf, -code, 0)
    off = neg // LEAF_CNT_BITS
    cnt = neg % LEAF_CNT_BITS
    lanes = jnp.arange(MAX_LEAF)
    tri_idx = jnp.clip(off[:, None] + lanes[None, :], 0, scene.tris.shape[0] - 1)
    lane_ok = (lanes[None, :] < cnt[:, None]) & is_leaf[:, None]
    recs = scene.tris[tri_idx]                            # (B, 4, 9)
    e2 = recs[..., 0:3]
    e1 = recs[..., 3:6]
    v0 = recs[..., 6:9]
    d4 = directions[:, None, :]
    o4 = origins[:, None, :]
    r = jnp.cross(d4, e2)
    a = jnp.sum(e1 * r, axis=-1)
    finv = 1.0 / jnp.where(jnp.abs(a) < DET_EPS, 1.0, a)
    sv = o4 - v0
    uu = finv * jnp.sum(sv * r, axis=-1)
    q = jnp.cross(sv, e1)
    vv = finv * jnp.sum(d4 * q, axis=-1)
    tt = finv * jnp.sum(e2 * q, axis=-1)
    valid = (
        lane_ok
        & (jnp.abs(a) > DET_EPS)
        & (uu >= 0.0) & (uu <= 1.0)
        & (vv >= 0.0) & (uu + vv <= 1.0)
        & (tt > T_MIN) & (tt < s.t[:, None])
    )
    tt = jnp.where(valid, tt, FAR_PLANE)
    # Select-chain reduction instead of per-row dynamic indexing (which
    # would lower to one more gather).
    t_new, u_new, v_new, slot_new = s.t, s.u, s.v, s.slot
    for kk in range(MAX_LEAF):
        better_k = tt[:, kk] < t_new
        t_new = jnp.where(better_k, tt[:, kk], t_new)
        u_new = jnp.where(better_k, uu[:, kk], u_new)
        v_new = jnp.where(better_k, vv[:, kk], v_new)
        slot_new = jnp.where(better_k, tri_idx[:, kk], slot_new)
    found = s.found | (is_leaf & (t_new < s.t))

    sp = jnp.where(active & is_inner, sp_inner, sp_pop)
    sp = jnp.where(active, sp, s.sp)
    return _TravState(
        stack=stack, sp=sp, t=t_new, u=u_new, v=v_new, slot=slot_new, found=found
    )


def _traverse(scene, origins, directions, t_max, any_hit: bool):
    b = origins.shape[0]
    inv_dir = safe_rcp(directions)
    init = _init_state(b, t_max)
    # Hard iteration backstop; geometric bound is node count + leaf visits.
    max_iters = 4 * int(scene.bvh_bounds.shape[0]) + 64

    def cond(s):
        live = s.sp > 0
        if any_hit:
            live = live & ~s.found
        return jnp.any(live)

    def body(s):
        return _step(scene, origins, directions, inv_dir, s, any_hit)

    del max_iters  # cond() terminates: sp strictly decreases once subtrees drain
    return jax.lax.while_loop(cond, body, init)


def closest_hit(scene, origins, directions):
    """Closest hit; returns ``(t, bary (B,2), slot, inst=-1)``."""
    s = _traverse(scene, origins, directions, jnp.float32(FAR_PLANE), any_hit=False)
    bary = jnp.stack([s.u, s.v], axis=-1)
    return s.t, bary, s.slot, jnp.full_like(s.slot, -1)


def occluded(scene, origins, directions, t_max):
    """Any-hit within t_max (shadow rays) with early termination."""
    s = _traverse(scene, origins, directions, t_max, any_hit=True)
    return s.found
