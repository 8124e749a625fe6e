"""Camera: matrix construction + batched primary-ray generation.

Ray generation matches ``Assets/Resources/util/camera.hlsl:13-42``: NDC
coordinates through the inverse projection, rotated into world by the
camera-to-world matrix, with optional thin-lens depth of field via a
concentric disk sample.  Conventions are OpenGL/Unity-style: camera space
looks down **-Z**, ``cam_to_world`` columns are (right, up, back, eye).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from unity_webgpu_pathtracer_tpu.config import RenderConfig, RenderParams
from unity_webgpu_pathtracer_tpu.utils import rng as urng
from unity_webgpu_pathtracer_tpu.utils.math import (
    concentric_sample_disk,
    matmul_f32,
    normalize,
)

# AA jitter stddev in pixels: 1/sqrt(8 ln 2) so the Gaussian reaches half
# maximum at orthogonally adjacent pixel midpoints (PathTracer.compute:25-31).
ANTIALIASING_STD = 0.4246609


def look_at(eye, target, up=(0.0, 1.0, 0.0)) -> np.ndarray:
    """Camera-to-world matrix with -Z forward (Unity ``cameraToWorldMatrix``)."""
    eye = np.asarray(eye, np.float64)
    fwd = np.asarray(target, np.float64) - eye
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, np.asarray(up, np.float64))
    right /= np.linalg.norm(right)
    true_up = np.cross(right, fwd)
    m = np.eye(4)
    m[:3, 0] = right
    m[:3, 1] = true_up
    m[:3, 2] = -fwd
    m[:3, 3] = eye
    return m.astype(np.float32)


def perspective_inverse(fov_y_deg: float, aspect: float) -> np.ndarray:
    """Inverse projection mapping NDC ``(u, v, 0, 1)`` to a -Z camera ray.

    Only the direction reconstruction path of ``CamInvProj`` (camera.hlsl:19)
    is needed: ``dir_cam = (u·tanθ·aspect, v·tanθ, -1)``.
    """
    t = float(np.tan(np.radians(fov_y_deg) * 0.5))
    m = np.zeros((4, 4), np.float32)
    m[0, 0] = t * aspect
    m[1, 1] = t
    m[2, 3] = -1.0
    m[3, 3] = 1.0
    return m


def make_camera_params(eye, target, fov_y_deg, width, height, up=(0, 1, 0),
                       aperture=0.0, focal_length=0.0, **kw) -> RenderParams:
    """Convenience constructor for RenderParams' camera block."""
    c2w = look_at(eye, target, up)
    inv_proj = perspective_inverse(fov_y_deg, width / height)
    return RenderParams(
        cam_to_world=jnp.asarray(c2w),
        cam_inv_proj=jnp.asarray(inv_proj),
        aperture=jnp.asarray(aperture, jnp.float32),
        focal_length=jnp.asarray(focal_length, jnp.float32),
        **kw,
    )


def get_screen_ray(pixel_coords: jnp.ndarray, config: RenderConfig,
                   params: RenderParams, state: jnp.ndarray):
    """Generate world-space rays for jittered pixel coordinates ``(B, 2)``.

    Port of ``GetScreenRay`` (camera.hlsl:13-42). Returns
    ``(origin (B,3), direction (B,3), new_state)``.
    """
    c2w = params.cam_to_world
    origin = jnp.broadcast_to(c2w[:3, 3], pixel_coords.shape[:-1] + (3,))

    wh = jnp.asarray([config.width, config.height], dtype=jnp.float32)
    uv = pixel_coords / wh * 2.0 - 1.0
    # dir_cam = CamInvProj @ (u, v, 0, 1)
    ip = params.cam_inv_proj
    dir_cam = (
        uv[..., 0:1] * ip[:3, 0] + uv[..., 1:2] * ip[:3, 1] + ip[:3, 3]
    )
    direction = normalize(matmul_f32(dir_cam, c2w[:3, :3].T))

    if config.use_depth_of_field:
        (u1, u2), state = urng.random_floats(state, 2)
        lens_u, lens_v = concentric_sample_disk(u1, u2)
        lens_radius = params.aperture * 0.5
        lens_u = lens_u * lens_radius
        lens_v = lens_v * lens_radius
        focal_point = origin + direction * params.focal_length
        lens_pos = (
            lens_u[..., None] * c2w[:3, 0]
            + lens_v[..., None] * c2w[:3, 1]
            + c2w[:3, 3]
        )
        dof_dir = normalize(focal_point - lens_pos)
        use = (params.aperture > 0.0) & (params.focal_length > 0.0)
        origin = jnp.where(use, lens_pos, origin)
        direction = jnp.where(use, dof_dir, direction)

    return origin, direction, state


def jittered_pixel_coords(pixel_index: jnp.ndarray, config: RenderConfig,
                          state: jnp.ndarray):
    """Pixel centers + Gaussian AA jitter (``PathTracer.compute:68-73``).

    ``pixel_index`` is the flat row-major index (y*W + x); returns
    ``(coords (B,2), new_state)``.
    """
    x = (pixel_index % config.width).astype(jnp.float32)
    y = (pixel_index // config.width).astype(jnp.float32)
    (u, v), state = urng.random_floats(state, 2)
    from unity_webgpu_pathtracer_tpu.render.sampling import sample_gaussian

    gx, gy = sample_gaussian(u, v)
    coords = jnp.stack(
        [x + 0.5 + ANTIALIASING_STD * gx, y + 0.5 + ANTIALIASING_STD * gy], axis=-1
    )
    return coords, state
