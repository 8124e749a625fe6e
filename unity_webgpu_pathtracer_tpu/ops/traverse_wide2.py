"""Split-table stackless traversal (accel.wide2 format) — cache-hot arrivals.

Same algorithm as ops/traverse_wide but over the split tables: internal
steps gather 128-byte rows from the small hot ``inner`` table; lanes that
reach a leaf *park* and an amortized leaf phase gathers the cold 192-byte
``leaf_geo`` rows + the tiny per-octant ``leaf_skip`` continuation.  On the
1M-tri benchmark this moves most gathers from an 87 MB table to a ~19 MB
one.

Position codes are signed: ``pos > 0`` inner row ``pos-1``, ``pos < 0``
parked leaf ``-pos-1``, ``0`` end.  TLAS instance rows live in the inner
table (kind < 0) with the BLAS region recorded as (entry code, inner-end,
leaf-end) so BLAS exit works across both index spaces.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from unity_webgpu_pathtracer_tpu.ops.intersect import DET_EPS, T_MIN
from unity_webgpu_pathtracer_tpu.ops.traverse_wide import octant_index
from unity_webgpu_pathtracer_tpu.utils.math import FAR_PLANE, safe_rcp

LEAF_EVERY = 4


class Wide2State(NamedTuple):
    ptr: jnp.ndarray       # (B,) signed position code
    pending: jnp.ndarray   # (B,) parked leaf id + 1 (0 = none)
    t: jnp.ndarray
    u: jnp.ndarray
    v: jnp.ndarray
    tri: jnp.ndarray
    found: jnp.ndarray
    inst: jnp.ndarray
    hit_inst: jnp.ndarray
    resume: jnp.ndarray        # signed code to resume at after BLAS exit
    blas_inner_end: jnp.ndarray  # exclusive inner-id bound + 1 (code space)
    blas_leaf_end: jnp.ndarray   # exclusive leaf-id bound + 1
    local_o: jnp.ndarray
    local_d: jnp.ndarray
    local_inv: jnp.ndarray


def init_state2(b, t_max, entry) -> Wide2State:
    z3 = jnp.zeros((b, 3), jnp.float32)
    return Wide2State(
        ptr=jnp.broadcast_to(entry, (b,)).astype(jnp.int32),
        pending=jnp.zeros((b,), jnp.int32),
        t=jnp.broadcast_to(t_max, (b,)).astype(jnp.float32),
        u=jnp.zeros((b,), jnp.float32),
        v=jnp.zeros((b,), jnp.float32),
        tri=jnp.full((b,), -1, jnp.int32),
        found=jnp.zeros((b,), bool),
        inst=jnp.full((b,), -1, jnp.int32),
        hit_inst=jnp.full((b,), -1, jnp.int32),
        resume=jnp.zeros((b,), jnp.int32),
        blas_inner_end=jnp.zeros((b,), jnp.int32),
        blas_leaf_end=jnp.zeros((b,), jnp.int32),
        local_o=z3, local_d=z3, local_inv=z3,
    )


def live2(s: Wide2State):
    return (s.ptr != 0) | (s.pending != 0)


def _beyond(s, code):
    """Did `code` leave the lane's BLAS region? (code space bounds)."""
    return jnp.where(
        code > 0, code >= s.blas_inner_end,
        jnp.where(code < 0, -code >= s.blas_leaf_end, True),
    )


def _apply_exit(s, in_blas, code):
    exited = in_blas & _beyond(s, code)
    new_code = jnp.where(exited, s.resume, code)
    inst = jnp.where(exited, -1, s.inst)
    return new_code, inst


def node_step2(inner_flat, n_inner, base, o, d, inv, s: Wide2State,
               active=None, inst_w2l=None) -> Wide2State:
    stepping = (s.ptr > 0) & (s.pending == 0)
    if active is not None:
        stepping = stepping & active

    if inst_w2l is not None:
        in_blas = s.inst >= 0
        o = jnp.where(in_blas[:, None], s.local_o, o)
        d = jnp.where(in_blas[:, None], s.local_d, d)
        inv = jnp.where(in_blas[:, None], s.local_inv, inv)

    row = inner_flat[base + jnp.where(stepping, s.ptr - 1, 0)]   # (B, 32)
    meta = jax.lax.bitcast_convert_type(row[:, 28:30], jnp.int32)
    skip = meta[:, 0]
    kind = meta[:, 1]
    ptrs = jax.lax.bitcast_convert_type(row[:, 24:28], jnp.int32)

    t_near = jnp.zeros_like(row[:, 0:4])
    t_far = jnp.broadcast_to(s.t[:, None], row[:, 0:4].shape)
    for ax in range(3):
        lo = (row[:, 4 * ax : 4 * ax + 4] - o[:, ax : ax + 1]) * inv[:, ax : ax + 1]
        hi = (row[:, 12 + 4 * ax : 16 + 4 * ax] - o[:, ax : ax + 1]) * inv[:, ax : ax + 1]
        t_near = jnp.maximum(t_near, jnp.minimum(lo, hi))
        t_far = jnp.minimum(t_far, jnp.maximum(lo, hi))
    hit = t_near <= t_far

    nxt = skip
    for k in (3, 2, 1, 0):
        nxt = jnp.where(hit[:, k] & (ptrs[:, k] != 0), ptrs[:, k], nxt)
    # Internal rows only; instance rows jump into their BLAS.
    is_inst_row = kind < 0

    inst = s.inst
    resume = s.resume
    bie, ble = s.blas_inner_end, s.blas_leaf_end
    local_o, local_d, local_inv = s.local_o, s.local_d, s.local_inv
    if inst_w2l is not None:
        inst_id = jnp.where(is_inst_row, -kind - 1, 0)
        w2l = inst_w2l[inst_id]
        lo3 = jnp.stack([
            w2l[:, 0] * o[:, 0] + w2l[:, 1] * o[:, 1] + w2l[:, 2] * o[:, 2] + w2l[:, 3],
            w2l[:, 4] * o[:, 0] + w2l[:, 5] * o[:, 1] + w2l[:, 6] * o[:, 2] + w2l[:, 7],
            w2l[:, 8] * o[:, 0] + w2l[:, 9] * o[:, 1] + w2l[:, 10] * o[:, 2] + w2l[:, 11],
        ], axis=-1)
        ld3 = jnp.stack([
            w2l[:, 0] * d[:, 0] + w2l[:, 1] * d[:, 1] + w2l[:, 2] * d[:, 2],
            w2l[:, 4] * d[:, 0] + w2l[:, 5] * d[:, 1] + w2l[:, 6] * d[:, 2],
            w2l[:, 8] * d[:, 0] + w2l[:, 9] * d[:, 1] + w2l[:, 10] * d[:, 2],
        ], axis=-1)
        enter = stepping & is_inst_row
        e3 = enter[:, None]
        local_o = jnp.where(e3, lo3, local_o)
        local_d = jnp.where(e3, ld3, local_d)
        local_inv = jnp.where(e3, safe_rcp(ld3), local_inv)
        inst = jnp.where(enter, inst_id, inst)
        resume = jnp.where(enter, skip, resume)
        bie = jnp.where(enter, ptrs[:, 1], bie)
        ble = jnp.where(enter, ptrs[:, 2], ble)
        nxt = jnp.where(is_inst_row, ptrs[:, 0], nxt)
        nxt, inst = _apply_exit(
            s._replace(resume=resume, blas_inner_end=bie, blas_leaf_end=ble,
                       inst=inst),
            stepping & (inst >= 0), nxt,
        )

    park = stepping & (nxt < 0)
    pending = jnp.where(park, -nxt, s.pending)
    new_ptr = jnp.where(stepping, jnp.where(park, s.ptr, nxt), s.ptr)
    new_ptr = jnp.where(park, 0, new_ptr)
    return s._replace(
        ptr=new_ptr, pending=pending, inst=inst, resume=resume,
        blas_inner_end=bie, blas_leaf_end=ble,
        local_o=local_o, local_d=local_d, local_inv=local_inv,
    )


def leaf_step2(leaf_geo, leaf_skip_flat, n_leaf, skip_base, o, d,
               s: Wide2State, active=None, inst_w2l=None) -> Wide2State:
    has = s.pending > 0
    if active is not None:
        has = has & active
    leaf = jnp.where(has, s.pending - 1, 0)
    row = leaf_geo[leaf]                                  # (B, 48)
    cnt = jax.lax.bitcast_convert_type(row[:, 45], jnp.int32)

    if inst_w2l is not None:
        in_blas = s.inst >= 0
        o = jnp.where(in_blas[:, None], s.local_o, o)
        d = jnp.where(in_blas[:, None], s.local_d, d)

    def comp(i):
        return row[:, 4 * i : 4 * i + 4]

    e2x, e2y, e2z = comp(0), comp(1), comp(2)
    e1x, e1y, e1z = comp(3), comp(4), comp(5)
    v0x, v0y, v0z = comp(6), comp(7), comp(8)
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]
    rx = dy * e2z - dz * e2y
    ry = dz * e2x - dx * e2z
    rz = dx * e2y - dy * e2x
    a = e1x * rx + e1y * ry + e1z * rz
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
        has[:, None]
        & (lanes[None, :] < cnt[:, None])
        & (jnp.abs(a) > DET_EPS)
        & (uu >= 0.0) & (uu <= 1.0)
        & (vv >= 0.0) & (uu + vv <= 1.0)
        & (tt > T_MIN) & (tt < s.t[:, None])
    )
    tt = jnp.where(valid, tt, FAR_PLANE)
    attrs = jax.lax.bitcast_convert_type(row[:, 36:40], jnp.int32)
    t_new, u_new, v_new, tri_new = s.t, s.u, s.v, s.tri
    for k in range(4):
        better_k = tt[:, k] < t_new
        t_new = jnp.where(better_k, tt[:, k], t_new)
        u_new = jnp.where(better_k, uu[:, k], u_new)
        v_new = jnp.where(better_k, vv[:, k], v_new)
        tri_new = jnp.where(better_k, attrs[:, k], tri_new)
    improved = t_new < s.t

    cont = leaf_skip_flat[skip_base + leaf]               # tiny gather
    inst = s.inst
    if inst_w2l is not None:
        cont, inst = _apply_exit(s, has & (s.inst >= 0), cont)
    park_again = has & (cont < 0)
    pending = jnp.where(has, jnp.where(park_again, -cont, 0), s.pending)
    ptr = jnp.where(has, jnp.where(park_again, 0, cont), s.ptr)
    return s._replace(
        ptr=ptr, pending=pending,
        t=t_new, u=u_new, v=v_new, tri=tri_new,
        found=s.found | improved,
        hit_inst=jnp.where(improved, s.inst, s.hit_inst),
        inst=inst,
    )


def _tables(scene):
    inner = scene.wide2_inner
    n_orders, n_inner = inner.shape[0], inner.shape[1]
    inner_flat = inner.reshape(n_orders * n_inner, 32)
    leaf_geo = scene.wide2_leaf
    n_leaf = leaf_geo.shape[0]
    skip_flat = scene.wide2_leaf_skip.reshape(-1)
    return inner_flat, n_inner, n_orders, leaf_geo, n_leaf, skip_flat


def _traverse(scene, origins, directions, t_max, any_hit: bool):
    b = origins.shape[0]
    inner_flat, n_inner, n_orders, leaf_geo, n_leaf, skip_flat = _tables(scene)
    oct_ = octant_index(directions) % n_orders
    base = oct_ * n_inner
    skip_base = oct_ * n_leaf
    inv = safe_rcp(directions)
    inst_w2l = scene.inst_w2l if scene.inst_w2l.shape[0] > 0 else None
    entry = scene.wide2_entry
    init = init_state2(b, t_max, entry)

    def cond(s):
        l = live2(s)
        if any_hit:
            l = l & ~s.found
        return jnp.any(l)

    def body(s):
        active = None if not any_hit else ~s.found
        for _ in range(LEAF_EVERY):
            s = node_step2(inner_flat, n_inner, base, origins, directions,
                           inv, s, active, inst_w2l)
        return leaf_step2(leaf_geo, skip_flat, n_leaf, skip_base, origins,
                          directions, s, active, inst_w2l)

    return jax.lax.while_loop(cond, body, init)


def closest_hit(scene, origins, directions):
    s = _traverse(scene, origins, directions, jnp.float32(FAR_PLANE), False)
    return s.t, jnp.stack([s.u, s.v], axis=-1), s.tri, s.hit_inst


def occluded(scene, origins, directions, t_max):
    s = _traverse(scene, origins, directions, t_max, True)
    return s.found
