"""Stackless skip-pointer BVH traversal — a frozen backend.

Avoids the stack-based MBVH traversal's per-iteration argsort +
arbitrary-index scatter (see ops/traverse_mbvh.py, kept as the reference
backend).  Here each ray carries only an int32 DFS pointer:

    row  = nodes[octant, ptr]          # one contiguous 32 B gather
    hit  = slab(row, ray, t_best)
    ptr  = hit ? (leaf ? skip : ptr+1) : skip
    leaf & hit -> intersect ≤4 tris    # one (4, 9) row-block gather

Front-to-back order comes from 8 octant-specialized linearizations
(accel.linearize); ``t_best`` still culls, so the skip variant visits more
nodes than a perfectly ordered stack but each step is far cheaper.

The leaf phase is decoupled: rays that reach a leaf "park" (pending leaf
register) while others keep stepping; every LEAF_EVERY node steps one
intersection step serves all parked rays, amortizing the 144 B/lane
triangle gather over several cheap 32 B node steps.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from unity_webgpu_pathtracer_tpu.ops.intersect import DET_EPS, T_MIN
from unity_webgpu_pathtracer_tpu.utils.math import FAR_PLANE, safe_rcp

LEAF_CNT_BITS = 16
MAX_LEAF = 4
LEAF_EVERY = 4  # node-stepping iterations per leaf-intersection step


class _SkipState(NamedTuple):
    ptr: jnp.ndarray       # (B,) int32 DFS position (N = done)
    pending: jnp.ndarray   # (B,) int32 parked leaf code (0 = none)
    t: jnp.ndarray
    u: jnp.ndarray
    v: jnp.ndarray
    slot: jnp.ndarray
    found: jnp.ndarray     # any-hit early out


def _octant_index(directions):
    return (
        (directions[..., 0] < 0).astype(jnp.int32)
        + 2 * (directions[..., 1] < 0).astype(jnp.int32)
        + 4 * (directions[..., 2] < 0).astype(jnp.int32)
    )


def _node_step(nodes_flat, n_nodes, base, o, inv, s: _SkipState):
    """One skip-pointer step for rays that are not parked at a leaf."""
    stepping = (s.ptr < n_nodes) & (s.pending == 0)
    row = nodes_flat[base + jnp.minimum(s.ptr, n_nodes - 1)]       # (B, 8)
    lo = row[:, 0:3]
    hi = row[:, 3:6]
    leaf_code = jax.lax.bitcast_convert_type(row[:, 6], jnp.int32)
    skip = jax.lax.bitcast_convert_type(row[:, 7], jnp.int32)

    t0 = (lo - o) * inv
    t1 = (hi - o) * inv
    t_near = jnp.max(jnp.minimum(t0, t1), axis=-1)
    t_far = jnp.min(jnp.maximum(t0, t1), axis=-1)
    box_hit = (jnp.maximum(t_near, 0.0) <= jnp.minimum(t_far, s.t))

    is_leaf = leaf_code != 0
    enter = box_hit & ~is_leaf
    park = box_hit & is_leaf

    new_ptr = jnp.where(enter, s.ptr + 1, skip)
    ptr = jnp.where(stepping, new_ptr, s.ptr)
    pending = jnp.where(stepping & park, leaf_code, s.pending)
    return s._replace(ptr=ptr, pending=pending)


def _leaf_step(scene, o, d, s: _SkipState):
    """Intersect parked rays' pending leaves (≤4 tris), then unpark."""
    has_leaf = s.pending != 0
    off = s.pending // LEAF_CNT_BITS
    cnt = s.pending % LEAF_CNT_BITS
    lanes = jnp.arange(MAX_LEAF)
    tri_idx = jnp.clip(off[:, None] + lanes[None, :], 0, scene.tris.shape[0] - 1)
    lane_ok = (lanes[None, :] < cnt[:, None]) & has_leaf[:, None]
    recs = scene.tris[tri_idx]                     # (B, 4, 9)
    e2 = recs[..., 0:3]
    e1 = recs[..., 3:6]
    v0 = recs[..., 6:9]
    d4 = d[:, None, :]
    o4 = o[:, None, :]
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
    for k in range(MAX_LEAF):
        better_k = tt[:, k] < t_new
        t_new = jnp.where(better_k, tt[:, k], t_new)
        u_new = jnp.where(better_k, uu[:, k], u_new)
        v_new = jnp.where(better_k, vv[:, k], v_new)
        slot_new = jnp.where(better_k, tri_idx[:, k], slot_new)
    return s._replace(
        t=t_new,
        u=u_new,
        v=v_new,
        slot=slot_new,
        found=s.found | (t_new < s.t),
        pending=jnp.zeros_like(s.pending),
    )


def _traverse(scene, origins, directions, t_max, any_hit: bool):
    b = origins.shape[0]
    nodes = scene.skip_nodes                       # (O, N, 8)
    n_orders = nodes.shape[0]
    n_nodes = nodes.shape[1]
    nodes_flat = nodes.reshape(n_orders * n_nodes, 8)
    octant = _octant_index(directions) % n_orders
    base = octant * n_nodes
    inv = safe_rcp(directions)

    init = _SkipState(
        ptr=jnp.zeros((b,), jnp.int32),
        pending=jnp.zeros((b,), jnp.int32),
        t=jnp.broadcast_to(t_max, (b,)).astype(jnp.float32),
        u=jnp.zeros((b,), jnp.float32),
        v=jnp.zeros((b,), jnp.float32),
        slot=jnp.full((b,), -1, jnp.int32),
        found=jnp.zeros((b,), bool),
    )

    def live(s):
        l = (s.ptr < n_nodes) | (s.pending != 0)
        if any_hit:
            l = l & ~s.found
        return l

    def cond(s):
        return jnp.any(live(s))

    def body(s):
        for _ in range(LEAF_EVERY):
            s = _node_step(nodes_flat, n_nodes, base, origins, inv, s)
        return _leaf_step(scene, origins, directions, s)

    return jax.lax.while_loop(cond, body, init)


def closest_hit(scene, origins, directions):
    s = _traverse(scene, origins, directions, jnp.float32(FAR_PLANE), any_hit=False)
    return s.t, jnp.stack([s.u, s.v], axis=-1), s.slot, jnp.full_like(s.slot, -1)


def occluded(scene, origins, directions, t_max):
    s = _traverse(scene, origins, directions, t_max, any_hit=True)
    return s.found
