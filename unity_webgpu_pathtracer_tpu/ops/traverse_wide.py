"""Fat-row 4-ary stackless traversal — one gather per arrival.

Consumes the ``accel.wide`` format: every traversal step gathers ONE 192-byte
row which is either an internal node (four child AABBs + DFS pointers) or a
leaf (four inline SoA triangle records).  A lane's state is a single int32
DFS pointer; arrival at an internal row slab-tests all four children and
jumps to the nearest-ordered first hit (octant-specialized DFS order makes
"first" ≈ "nearest"), or to ``skip``.  Arrival at a leaf intersects the
inline triangles and jumps to ``skip``.  No stacks, no sorts, no scatters.

Sibling subtrees hit at an arrival are reached later through the DFS skip
chain (unconditional sibling arrivals cost one wasted gather when their box
would have missed — the price of statelessness, bought back ~3x over by the
4-wide fan-out and inline leaves).

This module exposes both the barrier-style API (`closest_hit`/`occluded`,
used for correctness tests and the megakernel integrator) and the
single-step primitive `arrival_step` consumed by the fused wavefront
integrator (render/fused.py) where the only barrier is end-of-pass.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from unity_webgpu_pathtracer_tpu.ops.intersect import DET_EPS, T_MIN
from unity_webgpu_pathtracer_tpu.utils.math import FAR_PLANE, safe_rcp


class WideState(NamedTuple):
    ptr: jnp.ndarray     # (B,) int32 DFS position; >= N means done
    t: jnp.ndarray       # (B,) best distance (init: t_max)
    u: jnp.ndarray
    v: jnp.ndarray
    tri: jnp.ndarray     # (B,) int32 attribute row of best hit (-1 none)
    found: jnp.ndarray   # (B,) bool
    # --- instancing registers (identity/no-op when the scene has no TLAS;
    # `t` stays space-invariant because local directions are unnormalized,
    # the reference's trick in tlas.hlsl:131-135) ---
    inst: jnp.ndarray       # (B,) int32 current instance (-1 = world space)
    hit_inst: jnp.ndarray   # (B,) int32 instance of the best hit
    resume: jnp.ndarray     # (B,) int32 TLAS position to resume at
    blas_end: jnp.ndarray   # (B,) int32 end of the current BLAS region
    local_o: jnp.ndarray    # (B,3)
    local_d: jnp.ndarray    # (B,3)
    local_inv: jnp.ndarray  # (B,3)


def octant_index(directions):
    return (
        (directions[..., 0] < 0).astype(jnp.int32)
        + 2 * (directions[..., 1] < 0).astype(jnp.int32)
        + 4 * (directions[..., 2] < 0).astype(jnp.int32)
    )


def init_state(b, t_max) -> WideState:
    z3 = jnp.zeros((b, 3), jnp.float32)
    return WideState(
        ptr=jnp.zeros((b,), jnp.int32),
        t=jnp.broadcast_to(t_max, (b,)).astype(jnp.float32),
        u=jnp.zeros((b,), jnp.float32),
        v=jnp.zeros((b,), jnp.float32),
        tri=jnp.full((b,), -1, jnp.int32),
        found=jnp.zeros((b,), bool),
        inst=jnp.full((b,), -1, jnp.int32),
        hit_inst=jnp.full((b,), -1, jnp.int32),
        resume=jnp.zeros((b,), jnp.int32),
        blas_end=jnp.zeros((b,), jnp.int32),
        local_o=z3,
        local_d=z3,
        local_inv=z3,
    )


def arrival_step(nodes_flat, n_nodes, base, o, d, inv, s: WideState,
                 active=None, inst_w2l=None) -> WideState:
    """One arrival for every lane (masked by ``active`` and ptr bounds).

    With ``inst_w2l`` given (TLAS scenes), instance rows switch the lane
    into instance space and BLAS exits restore it (see accel.tlas).
    """
    live = s.ptr < n_nodes
    if active is not None:
        live = live & active
    row = nodes_flat[base + jnp.where(live, s.ptr, 0)]           # (B, 48)
    bits = jax.lax.bitcast_convert_type(row[:, 44:46], jnp.int32)
    skip = bits[:, 0]
    cnt = bits[:, 1]
    is_leaf = cnt > 0

    if inst_w2l is not None:
        in_blas = s.inst >= 0
        o = jnp.where(in_blas[:, None], s.local_o, o)
        d = jnp.where(in_blas[:, None], s.local_d, d)
        inv = jnp.where(in_blas[:, None], s.local_inv, inv)

    # ---- internal: 4-wide slab test on contiguous SoA slices ----
    t_near = jnp.full_like(row[:, 0:4], 0.0)
    t_far = jnp.broadcast_to(s.t[:, None], row[:, 0:4].shape)
    for ax in range(3):
        lo = (row[:, 4 * ax : 4 * ax + 4] - o[:, ax : ax + 1]) * inv[:, ax : ax + 1]
        hi = (row[:, 12 + 4 * ax : 16 + 4 * ax] - o[:, ax : ax + 1]) * inv[:, ax : ax + 1]
        t_near = jnp.maximum(t_near, jnp.minimum(lo, hi))
        t_far = jnp.minimum(t_far, jnp.maximum(lo, hi))
    hit = t_near <= t_far
    ptrs = jax.lax.bitcast_convert_type(row[:, 24:28], jnp.int32)
    nxt = skip
    for k in (3, 2, 1, 0):  # first-hit child wins (stored near-first)
        nxt = jnp.where(hit[:, k] & (ptrs[:, k] > 0), ptrs[:, k], nxt)

    # ---- leaf: 4-wide inline Möller-Trumbore on contiguous SoA slices ----
    def comp(i):  # i-th of the 9 packed components, contiguous (B, 4)
        return row[:, 4 * i : 4 * i + 4]

    e2x, e2y, e2z = comp(0), comp(1), comp(2)
    e1x, e1y, e1z = comp(3), comp(4), comp(5)
    v0x, v0y, v0z = comp(6), comp(7), comp(8)
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]

    rx = dy * e2z - dz * e2y
    ry = dz * e2x - dx * e2z
    rz = dx * e2y - dy * e2x
    a = e1x * rx + e1y * ry + e1z * rz                           # (B, 4)
    finv = 1.0 / jnp.where(jnp.abs(a) < DET_EPS, 1.0, a)
    sx, sy, sz = ox - v0x, oy - v0y, oz - v0z
    uu = finv * (sx * rx + sy * ry + sz * rz)
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    vv = finv * (dx * qx + dy * qy + dz * qz)
    tt = finv * (e2x * qx + e2y * qy + e2z * qz)
    lanes = jnp.arange(4)
    valid = (
        is_leaf[:, None] & live[:, None]
        & (lanes[None, :] < cnt[:, None])
        & (jnp.abs(a) > DET_EPS)
        & (uu >= 0.0) & (uu <= 1.0)
        & (vv >= 0.0) & (uu + vv <= 1.0)
        & (tt > T_MIN) & (tt < s.t[:, None])
    )
    tt = jnp.where(valid, tt, FAR_PLANE)
    # Lane-wise best-hit reduction via selects: per-row dynamic indexing
    # (tt[rows, argmin]) would each lower to another gather op.
    attrs = jax.lax.bitcast_convert_type(row[:, 36:40], jnp.int32)
    t_new, u_new, v_new, tri_new = s.t, s.u, s.v, s.tri
    for k in range(4):
        better_k = tt[:, k] < t_new
        t_new = jnp.where(better_k, tt[:, k], t_new)
        u_new = jnp.where(better_k, uu[:, k], u_new)
        v_new = jnp.where(better_k, vv[:, k], v_new)
        tri_new = jnp.where(better_k, attrs[:, k], tri_new)
    improved = t_new < s.t
    found_new = s.found | improved

    new_ptr = jnp.where(is_leaf, skip, nxt)

    if inst_w2l is None:
        return s._replace(
            ptr=jnp.where(live, new_ptr, s.ptr),
            t=t_new, u=u_new, v=v_new, tri=tri_new, found=found_new,
        )

    # ---- instance rows: enter instance space, jump into the BLAS ----
    is_inst = cnt < 0
    inst_id = jnp.where(is_inst, -cnt - 1, 0)
    ptrs_i = jax.lax.bitcast_convert_type(row[:, 24:27], jnp.int32)
    blas_ptr, blas_len = ptrs_i[:, 0], ptrs_i[:, 1]
    w2l = inst_w2l[inst_id]                                       # (B, 12)
    lo3 = jnp.stack(
        [
            w2l[:, 0] * o[:, 0] + w2l[:, 1] * o[:, 1] + w2l[:, 2] * o[:, 2] + w2l[:, 3],
            w2l[:, 4] * o[:, 0] + w2l[:, 5] * o[:, 1] + w2l[:, 6] * o[:, 2] + w2l[:, 7],
            w2l[:, 8] * o[:, 0] + w2l[:, 9] * o[:, 1] + w2l[:, 10] * o[:, 2] + w2l[:, 11],
        ],
        axis=-1,
    )
    # Direction transformed WITHOUT normalization -> t is space-invariant.
    ld3 = jnp.stack(
        [
            w2l[:, 0] * d[:, 0] + w2l[:, 1] * d[:, 1] + w2l[:, 2] * d[:, 2],
            w2l[:, 4] * d[:, 0] + w2l[:, 5] * d[:, 1] + w2l[:, 6] * d[:, 2],
            w2l[:, 8] * d[:, 0] + w2l[:, 9] * d[:, 1] + w2l[:, 10] * d[:, 2],
        ],
        axis=-1,
    )
    enter = live & is_inst
    e3 = enter[:, None]
    local_o = jnp.where(e3, lo3, s.local_o)
    local_d = jnp.where(e3, ld3, s.local_d)
    local_inv = jnp.where(e3, safe_rcp(ld3), s.local_inv)
    inst = jnp.where(enter, inst_id, s.inst)
    resume = jnp.where(enter, skip, s.resume)
    blas_end = jnp.where(enter, blas_ptr + blas_len, s.blas_end)
    new_ptr = jnp.where(is_inst, blas_ptr, new_ptr)

    # ---- BLAS exit: pointer crossed the BLAS region -> back to TLAS ----
    exited = live & (inst >= 0) & (new_ptr >= blas_end)
    new_ptr = jnp.where(exited, resume, new_ptr)
    inst = jnp.where(exited, -1, inst)

    return s._replace(
        ptr=jnp.where(live, new_ptr, s.ptr),
        t=t_new, u=u_new, v=v_new, tri=tri_new, found=found_new,
        inst=jnp.where(live, inst, s.inst),
        hit_inst=jnp.where(improved, s.inst, s.hit_inst),
        resume=resume,
        blas_end=blas_end,
        local_o=local_o,
        local_d=local_d,
        local_inv=local_inv,
    )


def _traverse(scene, origins, directions, t_max, any_hit: bool):
    b = origins.shape[0]
    nodes = scene.wide_nodes                       # (O, N, 48)
    n_orders, n_nodes = nodes.shape[0], nodes.shape[1]
    nodes_flat = nodes.reshape(n_orders * n_nodes, 48)
    base = (octant_index(directions) % n_orders) * n_nodes
    inv = safe_rcp(directions)
    init = init_state(b, t_max)
    inst_w2l = scene.inst_w2l if scene.inst_w2l.shape[0] > 0 else None

    def cond(s):
        live = s.ptr < n_nodes
        if any_hit:
            live = live & ~s.found
        return jnp.any(live)

    def body(s):
        active = None if not any_hit else ~s.found
        return arrival_step(nodes_flat, n_nodes, base, origins, directions,
                            inv, s, active, inst_w2l)

    return jax.lax.while_loop(cond, body, init)


def closest_hit(scene, origins, directions):
    """Returns ``(t, bary (B,2), attr_row, instance)`` — note: unlike the
    other backends, ``slot`` here is directly the attribute row (inline
    storage dereferences ``tri_index`` at build time)."""
    s = _traverse(scene, origins, directions, jnp.float32(FAR_PLANE), False)
    return s.t, jnp.stack([s.u, s.v], axis=-1), s.tri, s.hit_inst


def occluded(scene, origins, directions, t_max):
    s = _traverse(scene, origins, directions, t_max, True)
    return s.found
