"""Compute-path ops: intersection and BVH traversal backends.  The fused
integrator steps 16-wide traversal one arrival at a time through
``ops.traverse_wide16.arrival_step16``.

``get_intersectors(config)`` dispatches on ``RenderConfig.traversal`` and
returns ``(closest_hit_fn, any_hit_fn)`` with the uniform signatures::

    closest(scene, origins (B,3), directions (B,3)) -> (t, bary, slot)
    occluded(scene, origins, directions, t_max) -> bool (B,)

``slot`` indexes rows of ``scene.tris`` (BVH build order); attribute rows are
``scene.tri_index[slot]``.  ``t`` is FAR_PLANE on miss.
"""

from __future__ import annotations

from unity_webgpu_pathtracer_tpu.ops import intersect as _bf


def get_intersectors(config):
    if config.traversal == "bruteforce":
        return _bf.closest_hit_bruteforce, _bf.occluded_bruteforce
    if config.traversal in ("bvh2", "mbvh"):
        from unity_webgpu_pathtracer_tpu.ops import traverse_mbvh

        return traverse_mbvh.closest_hit, traverse_mbvh.occluded
    if config.traversal == "skip":
        from unity_webgpu_pathtracer_tpu.ops import traverse_skip

        return traverse_skip.closest_hit, traverse_skip.occluded
    if config.traversal == "wide":
        from unity_webgpu_pathtracer_tpu.ops import traverse_wide

        return traverse_wide.closest_hit, traverse_wide.occluded
    if config.traversal == "wide2":
        from unity_webgpu_pathtracer_tpu.ops import traverse_wide2

        return traverse_wide2.closest_hit, traverse_wide2.occluded
    if config.traversal == "wide8":
        from unity_webgpu_pathtracer_tpu.ops import traverse_wide8

        return traverse_wide8.closest_hit, traverse_wide8.occluded
    if config.traversal == "wide16":
        from unity_webgpu_pathtracer_tpu.ops import traverse_wide16

        return traverse_wide16.closest_hit, traverse_wide16.occluded
    raise ValueError(f"unknown traversal backend {config.traversal!r}")


def build_scene_bvh(positions):
    """Host-side BVH build entry used by Scene.build (accel package)."""
    from unity_webgpu_pathtracer_tpu.accel import build_scene_bvh as _b

    return _b(positions)
