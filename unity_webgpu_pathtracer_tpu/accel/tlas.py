"""Two-level acceleration: TLAS over instanced BLASes, single fat-row table.

The reference builds per-mesh CWBVH BLASes plus a separate 2-wide
Aila-Laine TLAS walked with its own stack and a per-instance world->local
ray transform (``plugin.cpp:111-118``, ``util/tlas.hlsl:249-331``,
``BLASInstance`` 64-byte records ``tiny_bvh.h:1442-1457``).  This
redesign keeps the *semantics* but flattens both levels into ONE
``accel.wide`` row table so the fused integrator's single arrival loop
handles instancing without nested traversals:

* rows ``[0 .. tlas_len)``     — TLAS internal rows (4-ary, 4 instance
  AABBs per row) and *instance rows*;
* rows ``[tlas_len .. )``      — each mesh's BLAS emitted once, DFS indices
  offset by its placement.

An instance row (kind = count < 0) carries the instance id, its BLAS's
entry pointer/length, and a skip pointer.  Arrival at it switches the lane
into instance space: the ray is transformed by ``world_to_local`` with an
**unnormalized** direction, which makes the hit parameter ``t`` invariant
between spaces (the reference's trick, ``tlas.hlsl:131-135``) so hits from
different instances compare directly.  When the lane's pointer crosses the
BLAS's end, traversal resumes at the instance row's skip in world space.

Instance transforms live in small side tables (cache-resident), gathered
only on instance entry.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from unity_webgpu_pathtracer_tpu.accel import bvh2 as ubvh2

ROW = 48
OFF_PTRS = 24       # internal: child ptrs; instance: blas_ptr/len/material
OFF_SKIP = 44
OFF_KIND = 45       # 0 internal, >0 leaf count, <0 -(instance_id+1)


@dataclasses.dataclass
class TlasScene:
    """Host-side two-level build result."""

    nodes: np.ndarray        # (1, N, 48) combined table
    inst_l2w: np.ndarray     # (I, 12) row-major 3x4
    inst_w2l: np.ndarray     # (I, 12)
    inst_material: np.ndarray  # (I,) int32, -1 = use per-triangle material


def _affine_rows(m: np.ndarray) -> np.ndarray:
    return np.asarray(m, np.float32)[:3, :4].reshape(-1)


def transform_aabb(lo, hi, m):
    """World AABB of a transformed local AABB (8 corners)."""
    corners = np.array(
        [[x, y, z] for x in (lo[0], hi[0]) for y in (lo[1], hi[1]) for z in (lo[2], hi[2])]
    )
    w = corners @ np.asarray(m)[:3, :3].T + np.asarray(m)[:3, 3]
    return w.min(axis=0), w.max(axis=0)


def build_tlas_wide(blas_tables: list[np.ndarray], blas_bounds: list[tuple],
                    instances: list[tuple]) -> TlasScene:
    """Assemble the combined table.

    Args:
        blas_tables: per-mesh ``(1, Nk, 48)`` wide tables (local space).
        blas_bounds: per-mesh (lo, hi) local AABBs.
        instances: list of ``(mesh_id, transform_4x4, material_override)``.
    """
    n_inst = len(instances)
    # World AABBs per instance.
    lo = np.zeros((n_inst, 3), np.float32)
    hi = np.zeros((n_inst, 3), np.float32)
    for i, (mesh_id, m, _mat) in enumerate(instances):
        lo[i], hi[i] = transform_aabb(*blas_bounds[mesh_id], m)

    # BLAS placement after a worst-case TLAS region: a 4-ary tree over I
    # leaves has at most I internal rows + I instance rows.
    # Build the TLAS BVH2 over instance AABBs (leaf size 1 -> instance rows).
    centers = ((lo + hi) * 0.5).reshape(n_inst, 1, 3)
    fake_tris = np.concatenate([lo.reshape(n_inst, 1, 3), hi.reshape(n_inst, 1, 3),
                                centers], axis=1)
    tl = ubvh2.build_bvh2(fake_tris, leaf_size=1)

    blas_offsets = []
    rows_out = []

    # First emit TLAS rows via recursive DFS (4-ary collapse, fixed order).
    axis = np.zeros(tl.node_count, np.int32)
    inner = tl.left >= 0
    li = tl.left[inner]
    c_l = (tl.nmin[li] + tl.nmax[li]) * 0.5
    c_r = (tl.nmin[li + 1] + tl.nmax[li + 1]) * 0.5
    axis[inner] = np.argmax(np.abs(c_r - c_l), axis=-1)

    # Two-pass: emit TLAS with placeholder BLAS pointers, then append BLASes.
    inst_rows = []  # (row_index, mesh_id)

    def children4(node):
        l = tl.left[node]
        out = []
        for c in (l, l + 1):
            if tl.count[c] > 0:
                out.append(c)
            else:
                cl = tl.left[c]
                out.extend([cl, cl + 1])
        return out

    def emit(node) -> int:
        my = len(rows_out)
        row = np.zeros(ROW, np.float32)
        rows_out.append(row)
        if tl.count[node] > 0:
            inst_id = int(tl.order[tl.start[node]])
            mesh_id, _m, mat = instances[inst_id]
            row[OFF_KIND] = np.asarray([-(inst_id + 1)], np.int32).view(np.float32)[0]
            row[OFF_PTRS + 2] = np.asarray(
                [mat if mat is not None else -1], np.int32
            ).view(np.float32)[0]
            inst_rows.append((my, mesh_id))
        else:
            kids = children4(node)
            ptrs = np.zeros(4, np.int32)
            boxes = np.zeros((6, 4), np.float32)
            boxes[0:3] = np.inf
            boxes[3:6] = -np.inf
            for k, c in enumerate(kids):
                boxes[0:3, k] = tl.nmin[c]
                boxes[3:6, k] = tl.nmax[c]
                ptrs[k] = emit(c)
            row[0:24] = boxes.reshape(-1)
            row[OFF_PTRS : OFF_PTRS + 4] = ptrs.view(np.float32)
        row[OFF_SKIP] = np.asarray([len(rows_out)], np.int32).view(np.float32)[0]
        return my

    if tl.count[0] > 0:
        emit(0)
    else:
        emit(0)
    tlas_len = len(rows_out)

    # Append BLAS tables (dedup by mesh), fixing DFS pointers by offset.
    mesh_offset = {}
    appended = []
    cursor = tlas_len
    for mesh_id, table in enumerate(blas_tables):
        t = np.array(table[0], np.float32)  # (Nk, 48) copy
        n_k = t.shape[0]
        ints = t[:, 44:46].view(np.int32)
        kinds = ints[:, 1]
        skips = ints[:, 0] + cursor
        t[:, 44] = skips.view(np.float32)
        ptrs = t[:, 24:28].view(np.int32)
        internal = kinds == 0
        adj = np.where((ptrs > 0) & internal[:, None], ptrs + cursor, ptrs)
        t[:, 24:28] = adj.view(np.float32)
        mesh_offset[mesh_id] = (cursor, n_k)
        cursor += n_k
        appended.append(t)

    # Patch instance rows with BLAS entry/len.
    for row_idx, mesh_id in inst_rows:
        off, ln = mesh_offset[mesh_id]
        rows_out[row_idx][OFF_PTRS + 0] = np.asarray([off], np.int32).view(np.float32)[0]
        rows_out[row_idx][OFF_PTRS + 1] = np.asarray([ln], np.int32).view(np.float32)[0]

    table = np.concatenate([np.stack(rows_out)] + appended, axis=0)

    inst_l2w = np.zeros((n_inst, 12), np.float32)
    inst_w2l = np.zeros((n_inst, 12), np.float32)
    inst_material = np.full((n_inst,), -1, np.int32)
    for i, (mesh_id, m, mat) in enumerate(instances):
        m = np.asarray(m, np.float64)
        inst_l2w[i] = _affine_rows(m.astype(np.float32))
        inst_w2l[i] = _affine_rows(np.linalg.inv(m).astype(np.float32))
        inst_material[i] = -1 if mat is None else mat
    return TlasScene(
        nodes=table[None],
        inst_l2w=inst_l2w,
        inst_w2l=inst_w2l,
        inst_material=inst_material,
    )


def export_aila_laine(instances: list[tuple], blas_bounds: list[tuple]):
    """Reference-format TLAS export (parity artifact).

    Emits the 64-byte 2-wide Aila-Laine nodes + instance index array the
    reference uploads (``BVH_GPU`` node layout ``{lmin,left, lmax,right,
    rmin,instCount, rmax,firstInst}``, ``tiny_bvh.h:1094-1105``; consumed by
    ``util/tlas.hlsl:249-331``).  The batched traversal uses the flattened
    fat-row structure instead; this exporter documents/checks the contract.

    Returns ``(nodes (N, 16) float32 with ints bitcast, index (I,) int32)``.
    """
    n_inst = len(instances)
    lo = np.zeros((n_inst, 3), np.float32)
    hi = np.zeros((n_inst, 3), np.float32)
    for i, (mesh_id, m, _mat) in enumerate(instances):
        lo[i], hi[i] = transform_aabb(*blas_bounds[mesh_id], m)
    centers = ((lo + hi) * 0.5).reshape(n_inst, 1, 3)
    fake = np.concatenate([lo.reshape(n_inst, 1, 3), hi.reshape(n_inst, 1, 3),
                           centers], axis=1)
    tl = ubvh2.build_bvh2(fake, leaf_size=2)

    # One 16-float node per BVH2 node. Inner nodes carry both children's
    # boxes + indices (instanceCount lane = 0); leaves carry
    # (instanceCount, firstInstance) and are dereferenced through the
    # instance index array (tlas.hlsl:314-328).
    nodes = np.zeros((tl.node_count, 16), np.float32)
    iv = nodes.view(np.int32)
    mapping = {}
    stack = [0]
    while stack:  # assign output indices in DFS order
        nd = stack.pop()
        mapping[nd] = len(mapping)
        if tl.count[nd] == 0:
            stack.append(tl.left[nd] + 1)
            stack.append(tl.left[nd])
    for nd, my in mapping.items():
        if tl.count[nd] > 0:
            iv[my, 11] = int(tl.count[nd])
            iv[my, 15] = int(tl.start[nd])
        else:
            l = tl.left[nd]
            nodes[my, 0:3] = tl.nmin[l]
            nodes[my, 4:7] = tl.nmax[l]
            nodes[my, 8:11] = tl.nmin[l + 1]
            nodes[my, 12:15] = tl.nmax[l + 1]
            iv[my, 3] = mapping[l]
            iv[my, 7] = mapping[l + 1]
            iv[my, 11] = 0
    return nodes, tl.order.astype(np.int32)


def refit_tlas(tlas: TlasScene, blas_tables, blas_bounds, instances) -> TlasScene:
    """Rebuild after transform changes (the reference rebuilds its TLAS every
    dirty frame, ``BVHScene.cs:823-838``); BLAS rows are reused unchanged."""
    return build_tlas_wide(blas_tables, blas_bounds, instances)
