"""Megakernel-style batched integrator.

The correctness-reference integrator: the whole ray batch steps through the
bounce loop together inside one ``lax.while_loop``, masked by an ``alive``
lane predicate — the direct batched analogue of the reference megakernel
(``util/pathtrace.hlsl:10-131``).  The fused wavefront integrator
(:mod:`unity_webgpu_pathtracer_tpu.render.fused`) is the performance
path; both must agree within Monte-Carlo noise.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from unity_webgpu_pathtracer_tpu.config import (
    ALPHA_MODE_BLEND,
    ALPHA_MODE_MASK,
    RenderConfig,
    RenderParams,
)
from unity_webgpu_pathtracer_tpu.ops import get_intersectors
from unity_webgpu_pathtracer_tpu.render import bsdf as ubsdf
from unity_webgpu_pathtracer_tpu.render import camera as ucamera
from unity_webgpu_pathtracer_tpu.render.hitinfo import (
    INTERSECT_LIGHT,
    intersect_analytic_lights,
    shade_prep,
)
from unity_webgpu_pathtracer_tpu.render.lights import direct_light
from unity_webgpu_pathtracer_tpu.render.sampling import power_heuristic
from unity_webgpu_pathtracer_tpu.render.sky import sample_sky_radiance
from unity_webgpu_pathtracer_tpu.scene.material import derive_material
from unity_webgpu_pathtracer_tpu.utils import rng as urng
from unity_webgpu_pathtracer_tpu.utils.math import EPSILON, luminance

# Alpha passthrough re-continues a ray without consuming a bounce
# (pathtrace.hlsl:84-89); cap total loop iterations to bound compile size.
ALPHA_SLACK = 8


class PathState(NamedTuple):
    """Per-lane path state shared by the megakernel and wavefront integrators."""

    origin: jnp.ndarray
    direction: jnp.ndarray
    radiance: jnp.ndarray
    throughput: jnp.ndarray
    rng: jnp.ndarray
    alive: jnp.ndarray
    prev_pdf: jnp.ndarray
    max_roughness: jnp.ndarray
    depth: jnp.ndarray


def new_path_state(origins, directions, rng_state) -> PathState:
    b = origins.shape[0]
    return PathState(
        origin=origins,
        direction=directions,
        radiance=jnp.zeros((b, 3), origins.dtype),
        throughput=jnp.ones((b, 3), origins.dtype),
        rng=rng_state,
        alive=jnp.ones((b,), bool),
        prev_pdf=jnp.zeros((b,), origins.dtype),
        max_roughness=jnp.zeros((b,), origins.dtype),
        depth=jnp.zeros((b,), jnp.int32),
    )


def trace_bounce(scene, config: RenderConfig, params: RenderParams, s: PathState,
                 closest_fn, occluded_fn, with_stats: bool = False):
    """One bounce for all lanes (body of ``pathtrace.hlsl:25-128``).

    With ``with_stats=True`` returns ``(state, shade_mask)`` where
    ``shade_mask`` marks lanes that ran NEE this bounce (each fires one
    shadow ray per enabled NEE branch) — used for rays/sec accounting.
    """
    alive = s.alive

    t, bary, slot, inst = closest_fn(scene, s.origin, s.direction)
    hit = shade_prep(scene, s.origin, s.direction, t, bary, slot, inst)
    if config.has_lights:
        hit = intersect_analytic_lights(scene, s.origin, s.direction, hit)

    # --- Miss: sky radiance with MIS against the previous bounce's pdf.
    sky_color, sky_pdf = sample_sky_radiance(config, params, scene.env,
                                             s.direction, s.depth)
    mis = jnp.where(s.depth > 0, power_heuristic(s.prev_pdf, sky_pdf), 1.0)
    miss = alive & ~hit.valid
    radiance = s.radiance + jnp.where(
        (miss & (mis > 0.0))[:, None], mis[:, None] * sky_color * s.throughput, 0.0
    )
    alive = alive & hit.valid

    # --- Analytic light hit: add emission, terminate (pathtrace.hlsl:42-47).
    if config.has_lights:
        light_hit = alive & (hit.intersect_type == INTERSECT_LIGHT)
        l_em = scene.lights[jnp.maximum(hit.light_index, 0), 4:7]
        radiance = radiance + jnp.where(light_hit[:, None], l_em * s.throughput, 0.0)
        alive = alive & ~light_hit

    # --- Material fetch + roughness regularization (pathtrace.hlsl:63-68).
    mdata = scene.materials[jnp.maximum(hit.material, 0)]
    if config.has_normal_maps:
        from unity_webgpu_pathtracer_tpu.scene.material import apply_normal_map
        from unity_webgpu_pathtracer_tpu.utils.math import dot1

        nm = apply_normal_map(mdata, hit.uv, hit.normal, hit.tangent,
                              scene.texture_data, config.has_textures)
        hit = hit._replace(
            normal=nm,
            ffnormal=jnp.where(dot1(nm, s.direction) <= 0.0, nm, -nm),
        )
    mat = derive_material(
        mdata, hit.uv, s.direction, hit.normal,
        scene.texture_data, config.has_textures,
    )
    max_roughness = jnp.where(alive, jnp.maximum(s.max_roughness, mat.roughness),
                              s.max_roughness)
    mat = mat._replace(roughness=max_roughness,
                       ax=jnp.maximum(0.001, max_roughness / jnp.sqrt(1.0 - mat.anisotropic * 0.9)),
                       ay=jnp.maximum(0.001, max_roughness * jnp.sqrt(1.0 - mat.anisotropic * 0.9)))

    # --- Mesh emission (not importance sampled, pathtrace.hlsl:78).
    radiance = radiance + jnp.where(alive[:, None], mat.emission * s.throughput, 0.0)

    # --- Bounce budget (pathtrace.hlsl:80-81).
    alive = alive & (s.depth < config.max_bounces)

    # --- Alpha passthrough (pathtrace.hlsl:84-89). One uniform is always
    # drawn to keep lane streams aligned (batched-RNG deviation from the
    # reference's short-circuit draw).
    u_alpha, rng_state = urng.random_float(s.rng)
    passthrough = alive & (
        ((mat.alpha_mode == ALPHA_MODE_MASK) & (mat.opacity < mat.alpha_cutoff))
        | ((mat.alpha_mode == ALPHA_MODE_BLEND) & (u_alpha > mat.opacity))
    )

    # --- NEE (pathtrace.hlsl:93).
    ld, rng_state = direct_light(scene, config, params, hit, mat, s.direction,
                                 rng_state, occluded_fn)
    shade = alive & ~passthrough
    radiance = radiance + jnp.where(shade[:, None], ld * s.throughput, 0.0)

    # --- BSDF sample (pathtrace.hlsl:98-113).
    f, l, pdf, rng_state = ubsdf.sample_brdf(mat, -s.direction, hit.ffnormal, rng_state)
    nan_lane = jnp.isnan(f).any(axis=-1) | jnp.isnan(pdf)
    dead_sample = shade & (nan_lane | (pdf <= 0.0))
    if config.debug_nan_canary:
        # NaN-BSDF canary (pathtrace.hlsl:100-104): replace the sample's
        # radiance with pure green and stop the path.
        radiance = jnp.where((shade & nan_lane)[:, None],
                             jnp.array([0.0, 1.0, 0.0], jnp.float32), radiance)
    throughput = jnp.where(
        (shade & ~dead_sample)[:, None],
        s.throughput * f / jnp.maximum(pdf, 1e-20)[:, None],
        s.throughput,
    )
    alive = alive & ~dead_sample

    # --- Continue ray (pathtrace.hlsl:116-118); passthrough keeps direction.
    new_dir = jnp.where(passthrough[:, None], s.direction, l)
    new_origin = hit.position + new_dir * EPSILON
    origin = jnp.where(alive[:, None], new_origin, s.origin)
    direction = jnp.where(alive[:, None], new_dir, s.direction)
    depth = jnp.where(alive, jnp.where(passthrough, s.depth, s.depth + 1), s.depth)
    prev_pdf = jnp.where(shade, pdf, s.prev_pdf)

    # --- Russian roulette (pathtrace.hlsl:121-127).
    if config.use_russian_roulette:
        u_rr, rng_state = urng.random_float(rng_state)
        p_cont = jnp.minimum(jnp.max(throughput, axis=-1) + 0.001, 0.95)
        killed = alive & ~passthrough & (u_rr >= p_cont)
        throughput = jnp.where(
            (alive & ~passthrough & ~killed)[:, None], throughput / p_cont[:, None],
            throughput,
        )
        alive = alive & ~killed

    out = PathState(
        origin=origin,
        direction=direction,
        radiance=radiance,
        throughput=throughput,
        rng=rng_state,
        alive=alive,
        prev_pdf=prev_pdf,
        max_roughness=max_roughness,
        depth=depth,
    )
    if with_stats:
        return out, shade
    return out


def path_trace(scene, config: RenderConfig, params: RenderParams,
               origins, directions, rng_state):
    """Trace a ray batch to completion; returns ``(radiance (B,3), rng)``."""
    closest_fn, occluded_fn = get_intersectors(config)
    init = (new_path_state(origins, directions, rng_state), jnp.asarray(0, jnp.int32))
    max_iters = config.max_bounces + 1 + ALPHA_SLACK

    def cond(carry):
        s, it = carry
        return jnp.any(s.alive) & (it < max_iters)

    def body(carry):
        s, it = carry
        return trace_bounce(scene, config, params, s, closest_fn, occluded_fn), it + 1

    final, _ = jax.lax.while_loop(cond, body, init)
    return final.radiance, final.rng


def render_pass(scene, config: RenderConfig, params: RenderParams,
                current_sample, pixel_indices=None):
    """One progressive pass: ``samples_per_pass`` samples for every pixel.

    Mirrors the kernel driver loop (``PathTracer.compute:54-98``): seeds per
    (pixel, current_sample), Gaussian AA jitter, optional firefly clamp.
    Returns the radiance *sum* (B,3) over the pass.
    """
    if pixel_indices is None:
        pixel_indices = jnp.arange(config.pixel_count(), dtype=jnp.uint32)
    current_sample = jnp.asarray(current_sample, jnp.uint32)
    state = urng.seed(pixel_indices, current_sample, params.seed_root)

    def one_sample(carry, _):
        state, total = carry
        coords, state = ucamera.jittered_pixel_coords(pixel_indices, config, state)
        o, d, state = ucamera.get_screen_ray(coords, config, params, state)
        radiance, state = path_trace(scene, config, params, o, d, state)
        if config.use_firefly_filter:
            lum = luminance(radiance)
            scale = jnp.where(
                lum > params.max_firefly_luminance,
                params.max_firefly_luminance / jnp.maximum(lum, 1e-20),
                1.0,
            )
            radiance = radiance * scale[:, None]
        return (state, total + radiance), None

    init = (state, jnp.zeros(pixel_indices.shape + (3,), jnp.float32))
    (state, total), _ = jax.lax.scan(one_sample, init, None,
                                     length=config.samples_per_pass)
    return total
