"""Temporal reprojection: warp accumulated radiance through a camera move.

BASELINE.md milestone 5 (stretch): "animated camera with temporal
reprojection + accumulation reset".  The reference resets accumulation on
every camera change (``PathTracer.cs:211-222``); this module instead
carries the converged history along with the camera, so a fly-cam keeps
most of its accumulated samples and only disoccluded pixels restart.

Method (standard backward reprojection, expressed as three dense device
dispatches — two primary-visibility passes and one gather):

1. ``primary_depth`` renders the hit distance ``t`` per pixel for BOTH
   cameras at exact pixel centers (no AA jitter, no DoF lens offset —
   the reprojection frame is the pinhole center ray).  Misses keep
   ``FAR_PLANE``, so sky history reprojects as a point at quasi-infinity
   (exact under pure rotation, and translation is negligible vs 1e5).
2. Each new pixel's world point ``P = o + d*t`` is projected into the OLD
   camera (the exact inverse of ``camera.get_screen_ray``: camera space
   via ``R^T (P - eye)``, perspective divide against the two diagonal
   ``cam_inv_proj`` entries, NDC -> pixel).
3. The old film is sampled with a 4-tap bilinear gather; each tap is
   validated by depth agreement ``|t_old - |P - eye_old|| <= tol * dist``
   (disocclusion/edge rejection) and in-bounds tests, weights are
   renormalized, and the surviving history count is carried per pixel
   (optionally clamped to ``max_history`` to bound stale-shading bias,
   like TAA history clamping).

The returned :class:`~..render.film.Film` has a PER-PIXEL ``sample_count``
``(H, W, 1)``; :func:`..render.film.accumulate` broadcasts over it
unchanged, so subsequent progressive passes blend new samples against
whatever history each pixel retained.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from unity_webgpu_pathtracer_tpu.config import RenderConfig, RenderParams
from unity_webgpu_pathtracer_tpu.ops import get_intersectors
from unity_webgpu_pathtracer_tpu.render.film import Film
from unity_webgpu_pathtracer_tpu.utils.math import matmul_f32


def _center_rays(config: RenderConfig, params: RenderParams):
    """Pinhole rays through exact pixel centers ((B,3), (B,3))."""
    pixels = jnp.arange(config.pixel_count(), dtype=jnp.int32)
    x = (pixels % config.width).astype(jnp.float32) + 0.5
    y = (pixels // config.width).astype(jnp.float32) + 0.5
    wh = jnp.asarray([config.width, config.height], jnp.float32)
    uv = jnp.stack([x, y], axis=-1) / wh * 2.0 - 1.0
    ip = params.cam_inv_proj
    dir_cam = uv[:, 0:1] * ip[:3, 0] + uv[:, 1:2] * ip[:3, 1] + ip[:3, 3]
    c2w = params.cam_to_world
    d = matmul_f32(dir_cam, c2w[:3, :3].T)
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    o = jnp.broadcast_to(c2w[:3, 3], d.shape)
    return o, d


def primary_depth(scene, config: RenderConfig, params: RenderParams):
    """(H*W,) primary hit distance at pixel centers; misses = FAR_PLANE."""
    o, d = _center_rays(config, params)
    closest_fn, _ = get_intersectors(config)
    t, _bary, _slot, _inst = closest_fn(scene, o, d)
    return t


def _project_to_camera(P, config: RenderConfig, params: RenderParams):
    """World points -> (pixel coords (B,2), in-front mask, distance to eye).

    Exact inverse of ``camera.get_screen_ray``'s pinhole path: camera
    space looks down -Z; ``cam_inv_proj`` holds (tan*aspect, tan) on its
    diagonal (``camera.perspective_inverse``).
    """
    c2w = params.cam_to_world
    eye = c2w[:3, 3]
    rel = P - eye
    cam = matmul_f32(rel, c2w[:3, :3])   # R^T @ rel, row-wise
    z = -cam[:, 2]
    front = z > 1e-6
    zs = jnp.where(front, z, 1.0)
    ip = params.cam_inv_proj
    u = cam[:, 0] / (zs * ip[0, 0])
    v = cam[:, 1] / (zs * ip[1, 1])
    wh = jnp.asarray([config.width, config.height], jnp.float32)
    coords = (jnp.stack([u, v], axis=-1) + 1.0) * 0.5 * wh
    dist = jnp.linalg.norm(rel, axis=-1)
    return coords, front, dist


@jax.jit
def _warp(accum, count, t_new, t_old, o_new, d_new,
          old_c2w, old_ip, wh, depth_rel_tol, max_history):
    H = accum.shape[0]
    W = accum.shape[1]
    flat = accum.reshape(H * W, 3)
    P = o_new + d_new * t_new[:, None]

    # inline _project_to_camera on raw matrices (jit-friendly signature)
    eye = old_c2w[:3, 3]
    rel = P - eye
    cam = matmul_f32(rel, old_c2w[:3, :3])
    z = -cam[:, 2]
    front = z > 1e-6
    zs = jnp.where(front, z, 1.0)
    u = cam[:, 0] / (zs * old_ip[0, 0])
    v = cam[:, 1] / (zs * old_ip[1, 1])
    coords = (jnp.stack([u, v], axis=-1) + 1.0) * 0.5 * wh
    dist = jnp.linalg.norm(rel, axis=-1)

    gx = coords[:, 0] - 0.5
    gy = coords[:, 1] - 0.5
    x0 = jnp.floor(gx)
    y0 = jnp.floor(gy)
    dx = gx - x0
    dy = gy - y0

    acc = jnp.zeros_like(flat)
    cnt = jnp.zeros((H * W,), jnp.float32)
    wsum = jnp.zeros((H * W,), jnp.float32)
    for ox, oy, wgt in ((0, 0, (1 - dx) * (1 - dy)), (1, 0, dx * (1 - dy)),
                        (0, 1, (1 - dx) * dy), (1, 1, dx * dy)):
        xi = x0.astype(jnp.int32) + ox
        yi = y0.astype(jnp.int32) + oy
        inb = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        idx = jnp.clip(yi, 0, H - 1) * W + jnp.clip(xi, 0, W - 1)
        t_tap = t_old[idx]
        agree = jnp.abs(t_tap - dist) <= depth_rel_tol * dist
        w = wgt * (inb & agree & front).astype(jnp.float32)
        acc = acc + w[:, None] * flat[idx]
        cnt = cnt + w * count[idx]
        wsum = wsum + w

    valid = wsum > 0.25
    ws = jnp.where(valid, wsum, 1.0)
    warped = jnp.where(valid[:, None], acc / ws[:, None], 0.0)
    hist = jnp.where(valid, cnt / ws, 0.0)
    hist = jnp.minimum(hist, max_history).astype(jnp.int32)
    return (warped.reshape(H, W, 3),
            hist.reshape(H, W, 1))


def reproject_film(scene, config: RenderConfig, film: Film,
                   old_params: RenderParams, new_params: RenderParams,
                   max_history: int | None = None,
                   depth_rel_tol: float = 0.03) -> Film:
    """Warp ``film`` (accumulated under ``old_params``) to ``new_params``.

    Returns a film with per-pixel ``sample_count`` (disoccluded or
    off-screen pixels drop to 0 and restart accumulation); pass it back
    into the normal progressive loop.
    """
    t_new = primary_depth(scene, config, new_params)
    t_old = primary_depth(scene, config, old_params)
    o_new, d_new = _center_rays(config, new_params)
    count = jnp.broadcast_to(
        jnp.asarray(film.sample_count, jnp.float32).reshape(-1),
        (config.pixel_count(),)) if film.sample_count.ndim == 0 else \
        film.sample_count.astype(jnp.float32).reshape(-1)
    wh = jnp.asarray([config.width, config.height], jnp.float32)
    mh = jnp.float32(max_history if max_history is not None else 2**30)
    accum, hist = _warp(film.accum, count, t_new, t_old, o_new, d_new,
                        old_params.cam_to_world, old_params.cam_inv_proj,
                        wh, jnp.float32(depth_rel_tol), mh)
    return Film(accum=accum, sample_count=hist)
