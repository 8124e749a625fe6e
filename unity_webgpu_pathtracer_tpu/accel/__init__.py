"""Acceleration structures: BVH2 binned-SAH build, 8-wide MBVH collapse,
CWBVH quantized format, TLAS over instances.

Builders run on the host once per scene (like the reference's tinybvh C
plugin, ``Assets/Plugins/Web/plugin.cpp``) and emit flat arrays consumed by
the device traversal ops.  A C++ builder (``native/``) accelerates large
scenes; the numpy implementation is the always-available reference.
"""

from __future__ import annotations

import numpy as np


def build_scene_bvh(positions: np.ndarray, leaf_size: int = 4):
    """Build the 8-wide MBVH for a triangle soup.

    Args:
        positions: (F, 3, 3) triangle vertices.
    Returns:
        (bounds (N, 48) f32, child (N, 8) i32, order (F,) — triangle
        permutation to apply to the flat arrays).
    """
    from unity_webgpu_pathtracer_tpu.accel import bvh2, mbvh
    from unity_webgpu_pathtracer_tpu.accel.native import native_build_or_none

    native = native_build_or_none(positions, leaf_size)
    if native is not None:
        return native
    nodes = bvh2.build_bvh2(positions, leaf_size=leaf_size)
    return mbvh.collapse_to_mbvh8(nodes)


def build_scene_skip_bvh(positions: np.ndarray, leaf_size: int = 4):
    """Build the octant skip-pointer arrays (ops.traverse_skip format).

    Returns ``(skip_nodes (8, N, 8) f32, order (F,))``.
    """
    from unity_webgpu_pathtracer_tpu.accel import bvh2, linearize
    from unity_webgpu_pathtracer_tpu.accel.native import native_linearize_or_none

    native = native_linearize_or_none(positions, leaf_size)
    if native is not None:
        return native
    nodes = bvh2.build_bvh2(positions, leaf_size=leaf_size)
    return linearize.linearize_bvh2(nodes), nodes.order.copy()


def build_scene_wide_bvh(positions: np.ndarray, tri_records: np.ndarray,
                         leaf_size: int = 4, octants: int = 1):
    """Build the fat-row 4-ary arrays (accel.wide / ops.traverse_wide).

    ``tri_records`` are the (F, 9) [e2,e1,v0] rows in *original* order;
    leaf rows inline them together with the original attribute index.
    ``octants`` ∈ {1, 8}: 8 gives near-first DFS per ray octant (fewer
    arrivals/ray) at 8x the table bytes.
    Returns ``(octants, N, 48)`` float32.
    """
    from unity_webgpu_pathtracer_tpu.accel import bvh2, wide
    from unity_webgpu_pathtracer_tpu.accel.native import native_wide_or_none

    native = native_wide_or_none(positions, tri_records, leaf_size, octants)
    if native is not None:
        return native
    nodes = bvh2.build_bvh2(positions, leaf_size=leaf_size)
    return wide.build_wide(nodes, tri_records[nodes.order], nodes.order,
                           octant_orders=octants == 8)
