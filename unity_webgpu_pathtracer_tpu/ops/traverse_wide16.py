"""16-wide quantized stack traversal (consumes ``accel.wide16``).

Identical machinery to :mod:`ops.traverse_wide8` — one row gather per
arrival, per-lane register stacks with revisit masks, direct-pointer pops,
TLAS instance rows with the unnormalized-direction trick
(``tlas.hlsl:131-135``) — with two upgrades:

* **16 children / 16 leaf triangles per row** (384-byte rows): each
  arrival advances a ray twice as far as a 192-byte wide8 row, so
  arrivals per ray drop accordingly.
* **True nearest-first descent**: the next child is the hit child with the
  smallest slab entry t (argmin over the 16 lanes), replacing wide8's
  octant-slot approximation.  Reference analogue: CWBVH's ordered
  nodeGroup extraction, ``util/bvh.hlsl:141-197``.

Stack entries are (row, remaining-children mask) pairs held in TWO
level-major (MAX_DEPTH, B) int32 planes — a 16-bit mask no longer packs
next to a row index in one int32.  A mask of 0 marks a direct-pointer
entry (single surviving child pushed as its own row pointer, skipping the
parent re-gather on pop).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from unity_webgpu_pathtracer_tpu.accel.wide16 import (
    MAX_DEPTH,
    PERM_H8_POS,
    PERM_H_POS,
    PERM_Q,
    ROW,
)
from unity_webgpu_pathtracer_tpu.ops.intersect import DET_EPS, T_MIN
from unity_webgpu_pathtracer_tpu.utils.math import FAR_PLANE, safe_rcp

DONE = -1
FULL = 0xFFFF


class Wide16State(NamedTuple):
    ptr: jnp.ndarray       # (B,) int32 current row; DONE when finished
    pend: jnp.ndarray      # (B,) int32 pending-children mask (FULL = fresh)
    sp: jnp.ndarray        # (B,) int32 stack height
    stack_row: jnp.ndarray   # (MAX_DEPTH, B) int32 row (or direct child ptr)
    stack_mask: jnp.ndarray  # (MAX_DEPTH, B) int32 remaining mask (0 = direct)
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


def init_state16(b, t_max, ptr0: int = 0,
                 depth: int = MAX_DEPTH) -> Wide16State:
    """``depth`` sizes the (D, B) stacks; pass the scene's actual tree
    depth (``scene.stack_levels.shape[0]``) — every arrival reads/writes
    all D planes, so the format cap costs ~2x over a real ~8-deep tree."""
    z3 = jnp.zeros((b, 3), jnp.float32)
    return Wide16State(
        ptr=jnp.full((b,), ptr0, jnp.int32),
        pend=jnp.full((b,), FULL, jnp.int32),
        sp=jnp.zeros((b,), jnp.int32),
        stack_row=jnp.zeros((depth, b), jnp.int32),
        stack_mask=jnp.zeros((depth, b), jnp.int32),
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


def _i32(x):
    return jax.lax.bitcast_convert_type(x, jnp.int32)


def arrival_step16(nodes, o, d, inv, s: Wide16State, active=None,
                   has_instances: bool = True) -> Wide16State:
    """One arrival for every lane: gather the current row, process it by
    kind (inner / leaf / instance), and advance ptr via descend or pop."""
    b = s.ptr.shape[0]
    live = s.ptr >= 0
    if active is not None:
        live = live & active
    idx = jnp.where(live, s.ptr, 0)
    row = nodes[idx]                                             # (B, 96)
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

    anchor = row[:, 0:3]

    # ---- inner: decode 16 quantized child boxes, slab-test, mask ----
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
    # Whole-slice bitcast + reshape (per-column extracts can lower to
    # strided slice-loops — same rule as wide8), then a STATIC column
    # permutation from the SPLIT byte order back to slot order
    # (accel.wide16.PERM_Q).
    qbytes = jax.lax.bitcast_convert_type(
        row[:, 8:32], jnp.uint8).reshape(b, 96).astype(jnp.float32)
    perm_q = jnp.asarray(PERM_Q, jnp.int32)
    t_near = jnp.zeros((b, 16), jnp.float32)
    t_far = jnp.broadcast_to(s.t[:, None], (b, 16))
    for c in range(3):
        qlo = qbytes[:, 16 * c : 16 * c + 16][:, perm_q]
        qhi = qbytes[:, 48 + 16 * c : 64 + 16 * c][:, perm_q]
        lo = anchor[:, c : c + 1] + qlo * scale[:, c : c + 1]
        hi = anchor[:, c : c + 1] + qhi * scale[:, c : c + 1]
        tl = (lo - o_[:, c : c + 1]) * inv_[:, c : c + 1]
        th = (hi - o_[:, c : c + 1]) * inv_[:, c : c + 1]
        t_near = jnp.maximum(t_near, jnp.minimum(tl, th))
        t_far = jnp.minimum(t_far, jnp.maximum(tl, th))
    ptrs = _i32(row[:, 32:48])                                   # (B, 16)
    # Empty slots masked explicitly (inverted sentinel boxes test like full
    # boxes under the symmetric min/max slab test); pend masks revisits.
    pbits = (s.pend[:, None] >> jnp.arange(16, dtype=jnp.int32)[None, :]) & 1
    hit = (t_near <= t_far) & (ptrs >= 0) & (pbits > 0)          # (B, 16)

    # True nearest-first pick: argmin slab-entry t over hit children.
    tn = jnp.where(hit, t_near, jnp.float32(jnp.inf))
    first_slot = jnp.argmin(tn, axis=1).astype(jnp.int32)
    found_child = is_inner & hit.any(axis=1)

    onehot_first = jnp.arange(16, dtype=jnp.int32)[None, :] == first_slot[:, None]
    child_ptr = jnp.sum(jnp.where(onehot_first, ptrs, 0), axis=1)
    rembits = hit & ~onehot_first                                # (B, 16) bool
    bits16 = (1 << jnp.arange(16, dtype=jnp.int32))[None, :]
    remaining = jnp.sum(jnp.where(rembits, bits16, 0), axis=1)

    # Push: several children remain -> (row, mask), popped as a revisit
    # (re-gather + re-test against the improved t); exactly ONE remains ->
    # its pointer directly with mask 0 (pop skips the parent re-gather).
    push = found_child & (remaining > 0)
    one_left = jnp.sum(rembits.astype(jnp.int32), axis=1) == 1
    direct_ptr = jnp.sum(jnp.where(rembits, ptrs, 0), axis=1)
    entry_row = jnp.where(one_left, direct_ptr, idx)
    entry_mask = jnp.where(one_left, 0, remaining)
    levels = jnp.arange(s.stack_row.shape[0], dtype=jnp.int32)[:, None]
    at_top = (levels == s.sp[None, :]) & push[None, :]
    stack_row = jnp.where(at_top, entry_row[None, :], s.stack_row)
    stack_mask = jnp.where(at_top, entry_mask[None, :], s.stack_mask)
    sp = s.sp + push.astype(jnp.int32)

    # ---- leaf: decode f16 anchored triangle records, Möller-Trumbore ----
    # SPLIT halfword order (word w = slots w, w+slots/2): static per-comp
    # column permutation back to slot order (accel.wide16.PERM_H*_POS).
    # ``slots`` dispatches on the row width: 96-float rows carry 16
    # triangle lanes, 48-float leaf8 rows carry 8.
    slots = 16 if nodes.shape[-1] == ROW else 8
    nw = 9 * slots // 2
    halves = jax.lax.bitcast_convert_type(
        row[:, 4 : 4 + nw], jnp.float16).reshape(b, 2 * nw).astype(jnp.float32)
    perm_h = jnp.asarray(PERM_H_POS if slots == 16 else PERM_H8_POS,
                         jnp.int32)
    comp = [halves[:, slots * c : slots * c + slots][:, perm_h]
            for c in range(9)]
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
    a = e1x * rx + e1y * ry + e1z * rz                           # (B, 16)
    finv = 1.0 / jnp.where(jnp.abs(a) < DET_EPS, 1.0, a)
    sx, sy, sz = ox - v0x, oy - v0y, oz - v0z
    uu = finv * (sx * rx + sy * ry + sz * rz)
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    vv = finv * (dx * qx + dy * qy + dz * qz)
    tt = finv * (e2x * qx + e2y * qy + e2z * qz)
    lanes = jnp.arange(slots)
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
    attrs = (_i32(row[:, 76:92]) if slots == 16 else _i32(row[:, 40:48]))
    best = jnp.argmin(tt, axis=1)
    onehot_b = jnp.arange(slots, dtype=jnp.int32)[None, :] == best[:, None]
    t_cand = jnp.sum(jnp.where(onehot_b, tt, 0.0), axis=1)
    improved = t_cand < s.t
    t_new = jnp.where(improved, t_cand, s.t)
    u_new = jnp.where(improved, jnp.sum(jnp.where(onehot_b, uu, 0.0), axis=1), s.u)
    v_new = jnp.where(improved, jnp.sum(jnp.where(onehot_b, vv, 0.0), axis=1), s.v)
    tri_new = jnp.where(improved, jnp.sum(jnp.where(onehot_b, attrs, 0), axis=1), s.tri)
    found_new = s.found | improved
    hit_inst = jnp.where(improved, s.inst, s.hit_inst)

    # ---- pop plumbing (shared by the instance and no-instance paths) ----
    need_pop = (is_inner & ~found_child) | is_leaf
    has = sp > 0
    at_pop = levels == (sp - 1)[None, :]
    top_row = jnp.sum(jnp.where(at_pop, stack_row, 0), axis=0)
    top_mask = jnp.sum(jnp.where(at_pop, stack_mask, 0), axis=0)
    pop_ptr = jnp.where(has, top_row, DONE)
    pop_pend = jnp.where(top_mask == 0, FULL, top_mask)   # 0 = direct entry
    sp_after = jnp.where(need_pop & has, sp - 1, sp)

    if not has_instances:
        new_ptr = jnp.where(found_child, child_ptr,
                            jnp.where(need_pop, pop_ptr, s.ptr))
        new_pend = jnp.where(found_child, FULL,
                             jnp.where(need_pop, jnp.where(has, pop_pend, FULL),
                                       s.pend))
        return s._replace(
            ptr=jnp.where(live, new_ptr, s.ptr),
            pend=jnp.where(live, new_pend, s.pend),
            sp=jnp.where(live, sp_after, s.sp),
            stack_row=stack_row,
            stack_mask=stack_mask,
            t=t_new, u=u_new, v=v_new, tri=tri_new, found=found_new,
        )

    # ---- instance: enter instance space, jump to the BLAS root ----
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
        is_inst | found_child, FULL,
        jnp.where(need_pop, jnp.where(has, pop_pend, FULL), s.pend),
    )

    return Wide16State(
        ptr=jnp.where(live, new_ptr, s.ptr),
        pend=jnp.where(live, new_pend, s.pend),
        sp=jnp.where(live, sp_after, s.sp),
        stack_row=stack_row,
        stack_mask=stack_mask,
        t=t_new, u=u_new, v=v_new, tri=tri_new, found=found_new,
        inst=jnp.where(live, inst, s.inst),
        hit_inst=hit_inst,
        sp_enter=jnp.where(live, sp_enter, s.sp_enter),
        local_o=local_o, local_d=local_d, local_inv=local_inv,
    )


def prestep16(nodes, top, o, d, inv, s: Wide16State, mask,
              top3=None) -> Wide16State:
    """Gather-free first arrival(s) for fresh lanes.

    Every ray segment — regenerated path, bounce continuation, NEE shadow
    ray — starts its traversal at row 0, so the first one or two arrivals
    of every segment fetch rows the whole pool shares.  This runs exactly
    ``arrival_step16``'s inner-node logic for those levels without touching
    HBM: level 1 slab-tests the root's children from the broadcast root row
    (``nodes[0]``); level 2 reassembles the chosen child's decoded fields
    from the slot-indexed host table ``top`` (``accel.wide16.derive_top16``)
    with a 16-step select chain (bitwise-exact, fully fusable — a plain f32
    one-hot matmul is not guaranteed bit-exact and a 16-row gather still
    pays the per-row gather price).  These levels cost arithmetic only, no
    row gathers.

    ``mask`` must select only fresh lanes (ptr==0, pend==FULL, sp==0,
    world space).  Lanes whose root is not an inner node are left alone.
    Level 2 is skipped statically when ``top`` is a placeholder (shape
    (1, _)), e.g. for instanced scenes whose TLAS can be refreshed in
    place.
    """
    b = s.ptr.shape[0]
    bits16 = (1 << jnp.arange(16, dtype=jnp.int32))[None, :]
    iota16 = jnp.arange(16, dtype=jnp.int32)[None, :]
    levels = jnp.arange(s.stack_row.shape[0], dtype=jnp.int32)[:, None]

    # ---- level 1: the root row, broadcast ----
    # The row's integer-bearing words (meta, exponents, ptrs) are arbitrary
    # bit patterns that are DENORMAL as f32 (ptr values < 2^23); a backend
    # that flushes denormals in some f32 lowering would zero them, so the
    # whole row is bitcast to int32 FIRST and every field is extracted in
    # integer space.  Anchor floats are normal values and safe.
    row0 = nodes[0]
    row0_i = jax.lax.bitcast_convert_type(row0, jnp.int32)       # (96,)
    mask = mask & (row0_i[3] == 0)
    anchor0 = row0[0:3]
    eword0 = row0_i[4]
    qwords = row0_i[8:32]                                        # (24,) i32
    qb0 = jnp.stack(
        [(qwords >> (8 * i)) & 0xFF for i in range(4)], axis=-1
    ).reshape(6, 16)[:, jnp.asarray(PERM_Q, jnp.int32)]   # SPLIT -> slot
    qb0 = qb0.reshape(96).astype(jnp.float32)
    ptrs0 = row0_i[32:48][None, :]                               # (1, 16)

    def slab(anchor, scale, qlo, qhi, t_cap):
        t_near = jnp.zeros((b, 16), jnp.float32)
        t_far = jnp.broadcast_to(t_cap[:, None], (b, 16))
        for c in range(3):
            lo = anchor[..., c : c + 1] + qlo[..., 16 * c : 16 * c + 16] * scale[..., c : c + 1]
            hi = anchor[..., c : c + 1] + qhi[..., 16 * c : 16 * c + 16] * scale[..., c : c + 1]
            tl = (lo - o[:, c : c + 1]) * inv[:, c : c + 1]
            th = (hi - o[:, c : c + 1]) * inv[:, c : c + 1]
            t_near = jnp.maximum(t_near, jnp.minimum(tl, th))
            t_far = jnp.minimum(t_far, jnp.maximum(tl, th))
        return t_near, t_far

    scale0 = jnp.stack(
        [jax.lax.bitcast_convert_type((((eword0 >> (8 * c)) & 0xFF) << 23),
                                      jnp.float32) for c in range(3)])
    t_near, t_far = slab(anchor0[None, :], scale0[None, :],
                         qb0[None, :48], qb0[None, 48:], s.t)
    hit = (t_near <= t_far) & (ptrs0 >= 0)
    tn = jnp.where(hit, t_near, jnp.float32(jnp.inf))
    slot1 = jnp.argmin(tn, axis=1).astype(jnp.int32)
    found1 = mask & hit.any(axis=1)
    onehot1 = iota16 == slot1[:, None]
    child_ptr = jnp.sum(jnp.where(onehot1, ptrs0, 0), axis=1)
    rembits = hit & ~onehot1
    remaining = jnp.sum(jnp.where(rembits, bits16, 0), axis=1)
    push1 = found1 & (remaining > 0)
    one_left = jnp.sum(rembits.astype(jnp.int32), axis=1) == 1
    direct_ptr = jnp.sum(jnp.where(rembits, ptrs0, 0), axis=1)
    entry_row = jnp.where(one_left, direct_ptr, 0)
    entry_mask = jnp.where(one_left, 0, remaining)
    at0 = (levels == 0) & push1[None, :]
    stack_row = jnp.where(at0, entry_row[None, :], s.stack_row)
    stack_mask = jnp.where(at0, entry_mask[None, :], s.stack_mask)
    sp = jnp.where(mask, push1.astype(jnp.int32), s.sp)
    ptr = jnp.where(mask, jnp.where(found1, child_ptr, DONE), s.ptr)

    # ---- level 2: the chosen child's fields via a slot select chain ----
    if top.shape[0] == 16:
        acc = jnp.zeros((b, top.shape[1]), jnp.float32)
        for k in range(16):
            acc = jnp.where((slot1 == k)[:, None], top[k][None, :], acc)
        cmeta = acc[:, 118]
        l2 = found1 & (cmeta == 0.0)
        t_near, t_far = slab(acc[:, 0:3], acc[:, 3:6],
                             acc[:, 6:54], acc[:, 54:102], s.t)
        cptrs = acc[:, 102:118].astype(jnp.int32)                # (B, 16)
        hit2 = (t_near <= t_far) & (cptrs >= 0)
        tn2 = jnp.where(hit2, t_near, jnp.float32(jnp.inf))
        slot2 = jnp.argmin(tn2, axis=1).astype(jnp.int32)
        found2 = l2 & hit2.any(axis=1)
        onehot2 = iota16 == slot2[:, None]
        gchild = jnp.sum(jnp.where(onehot2, cptrs, 0), axis=1)
        rembits2 = hit2 & ~onehot2
        remaining2 = jnp.sum(jnp.where(rembits2, bits16, 0), axis=1)
        push2 = found2 & (remaining2 > 0)
        one_left2 = jnp.sum(rembits2.astype(jnp.int32), axis=1) == 1
        direct2 = jnp.sum(jnp.where(rembits2, cptrs, 0), axis=1)
        entry_row2 = jnp.where(one_left2, direct2, child_ptr)
        entry_mask2 = jnp.where(one_left2, 0, remaining2)
        at_l2 = (levels == sp[None, :]) & (push2 & l2)[None, :]
        stack_row = jnp.where(at_l2, entry_row2[None, :], stack_row)
        stack_mask = jnp.where(at_l2, entry_mask2[None, :], stack_mask)
        sp = sp + (push2 & l2).astype(jnp.int32)
        # No grandchild hit: leave the lane at the child row — the normal
        # arrival repeats the test and pops correctly (rare; conservative).
        ptr = jnp.where(l2 & found2, gchild, ptr)

        # ---- level 3: grandchild fields via a bit-exact one-hot
        # matmul over the 256 (slot1, slot2) combinations ----
        # Instead of a 256-step select chain, the host pre-splits the
        # decoded slot table into 3 bf16 limbs (exact: 8+8+8 mantissa bits
        # cover f32's 24) and a bf16 one-hot matmul gathers each limb —
        # one nonzero per row, so every product and the f32 accumulation
        # are exact.
        if top3 is not None and top3.shape[-2] == 256:
            slot12 = slot1 * 16 + slot2                  # (B,)
            onehot = (slot12[:, None] == jnp.arange(256, dtype=jnp.int32)[None, :])
            oh_bf = onehot.astype(jnp.bfloat16)
            def mm(limb):
                return jax.lax.dot_general(
                    oh_bf, limb.astype(jnp.bfloat16),
                    (((1,), (0,)), ((), ())),
                    preferred_element_type=jnp.float32)
            acc3 = mm(top3[0]) + (mm(top3[1]) + mm(top3[2]))  # (B, 119)
            cmeta3 = acc3[:, 118]
            l3 = l2 & found2 & (cmeta3 == 0.0)
            t_near, t_far = slab(acc3[:, 0:3], acc3[:, 3:6],
                                 acc3[:, 6:54], acc3[:, 54:102], s.t)
            cptrs3 = acc3[:, 102:118].astype(jnp.int32)
            hit3 = (t_near <= t_far) & (cptrs3 >= 0)
            tn3 = jnp.where(hit3, t_near, jnp.float32(jnp.inf))
            slot3 = jnp.argmin(tn3, axis=1).astype(jnp.int32)
            found3 = l3 & hit3.any(axis=1)
            onehot3 = iota16 == slot3[:, None]
            ggchild = jnp.sum(jnp.where(onehot3, cptrs3, 0), axis=1)
            rembits3 = hit3 & ~onehot3
            remaining3 = jnp.sum(jnp.where(rembits3, bits16, 0), axis=1)
            push3 = found3 & (remaining3 > 0)
            one_left3 = jnp.sum(rembits3.astype(jnp.int32), axis=1) == 1
            direct3 = jnp.sum(jnp.where(rembits3, cptrs3, 0), axis=1)
            entry_row3 = jnp.where(one_left3, direct3, gchild)
            entry_mask3 = jnp.where(one_left3, 0, remaining3)
            at_l3 = (levels == sp[None, :]) & (push3 & l3)[None, :]
            stack_row = jnp.where(at_l3, entry_row3[None, :], stack_row)
            stack_mask = jnp.where(at_l3, entry_mask3[None, :], stack_mask)
            sp = sp + (push3 & l3).astype(jnp.int32)
            ptr = jnp.where(l3 & found3, ggchild, ptr)

    return s._replace(ptr=ptr, sp=sp, stack_row=stack_row,
                      stack_mask=stack_mask)


def _traverse(scene, origins, directions, t_max, any_hit: bool):
    b = origins.shape[0]
    nodes = scene.wide16_nodes                                   # (N, 96)
    inv = safe_rcp(directions)
    lv = getattr(scene, "stack_levels", None)   # test FakeScenes lack it
    init = init_state16(b, t_max, depth=MAX_DEPTH if lv is None else lv.shape[0])
    has_inst = scene.inst_w2l.shape[0] > 0

    def cond(s):
        live = s.ptr >= 0
        if any_hit:
            live = live & ~s.found
        return jnp.any(live)

    def body(s):
        active = None if not any_hit else ~s.found
        return arrival_step16(nodes, origins, directions, inv, s, active,
                              has_instances=has_inst)

    return jax.lax.while_loop(cond, body, init)


def closest_hit(scene, origins, directions):
    """Returns ``(t, bary (B,2), attr_row, instance)``."""
    s = _traverse(scene, origins, directions, jnp.float32(FAR_PLANE), False)
    return s.t, jnp.stack([s.u, s.v], axis=-1), s.tri, s.hit_inst


def occluded(scene, origins, directions, t_max):
    s = _traverse(scene, origins, directions, t_max, True)
    return s.found
