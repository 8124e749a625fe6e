"""DFS linearization of the BVH2 with skip pointers (threaded BVH).

Per-ray stacks need scatter writes and sorted pushes — both costly in a
batched program (arbitrary-index scatters may serialize; an 8-lane argsort
per ray per step dominates the traversal loop).  A threaded BVH removes the stack entirely:
nodes are laid out in depth-first order and every node stores the index to
jump to when its subtree is skipped.  Per traversal step each ray does ONE
contiguous 32-byte row gather and advances ``ptr -> ptr+1`` (enter) or
``ptr -> skip`` (miss/leaf-done).  No scatter, no sort, no stack.

Node row layout ((N, 8) float32, ints bitcast into lanes 6-7)::

    [lo.x, lo.y, lo.z, hi.x, hi.y, hi.z, leaf_code, skip]

* ``leaf_code`` (int32 bitcast): 0 for inner nodes, else ``off*16 + cnt``
  (same packing as accel.mbvh leaves).
* ``skip`` (int32 bitcast): next DFS index when this subtree is skipped or a
  leaf has been processed; ``N`` terminates.

Front-to-back ordering is approximated with 8 octant-specialized
linearizations (children swapped so the near child for that ray octant
comes first in DFS order), selected per ray from its direction signs —
the stackless analogue of the reference's octant traversal-order trick
(``bvh.hlsl:129``, ``tlas.hlsl:289-297``).
"""

from __future__ import annotations

import numpy as np

from unity_webgpu_pathtracer_tpu.accel.bvh2 import BVH2

LEAF_CNT_BITS = 16


def linearize_bvh2(bvh: BVH2, octant_orders: bool = True) -> np.ndarray:
    """Emit skip-pointer arrays.

    Returns (8, N, 8) float32 when ``octant_orders`` (one DFS order per ray
    octant), else (1, N, 8).
    """
    n = bvh.node_count
    # Split axis per inner node: the dominant extent of its child centroids
    # decides which octant bit picks the near child.
    axis = np.zeros(n, np.int32)
    inner = bvh.left >= 0
    li = bvh.left[inner]
    c_l = (bvh.nmin[li] + bvh.nmax[li]) * 0.5
    c_r = (bvh.nmin[li + 1] + bvh.nmax[li + 1]) * 0.5
    axis[inner] = np.argmax(np.abs(c_r - c_l), axis=-1)

    orders = range(8) if octant_orders else (0,)
    out = np.zeros((len(list(orders)), n, 8), np.float32)
    for oi, octant in enumerate(range(8) if octant_orders else (0,)):
        rows = np.zeros((n, 8), np.float32)
        ints = np.zeros((n, 2), np.int32)
        cursor = 0
        # Iterative DFS: stack holds (bvh2_node, resolved_on_exit list).
        # We need skip = index after the subtree; do a two-pass: first assign
        # DFS indices, then compute skip = dfs_index + subtree_size.
        dfs_index = np.zeros(n, np.int32)
        subtree = np.zeros(n, np.int32)
        stack = [(0, False)]
        seq = []
        while stack:
            node, done = stack.pop()
            if done:
                if bvh.count[node] > 0:
                    subtree[node] = 1
                else:
                    l = bvh.left[node]
                    subtree[node] = 1 + subtree[l] + subtree[l + 1]
                continue
            dfs_index[node] = cursor
            cursor += 1
            seq.append(node)
            stack.append((node, True))
            if bvh.count[node] == 0:
                l = bvh.left[node]
                first, second = l, l + 1
                # Near-child-first for this octant: ray with negative sign
                # on the split axis enters the right (greater) child first.
                if (octant >> axis[node]) & 1:
                    first, second = second, first
                stack.append((second, False))
                stack.append((first, False))
        for node in seq:
            i = dfs_index[node]
            rows[i, 0:3] = bvh.nmin[node]
            rows[i, 3:6] = bvh.nmax[node]
            if bvh.count[node] > 0:
                ints[i, 0] = bvh.start[node] * LEAF_CNT_BITS + bvh.count[node]
            ints[i, 1] = i + subtree[node]
        rows[:, 6:8] = ints.view(np.float32)
        out[oi] = rows
    return out
