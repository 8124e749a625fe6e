"""Wavefront path tracing with path regeneration — the staged integrator.

The reference started (and abandoned) a wavefront refactor
(``Assets/Resources/wavefront/`` — dead code, SURVEY.md §2.3); this module
realizes that design for batched execution, superseded in production by
:mod:`render.fused`.  The key observation: in a batched program a
masked-off lane still costs its share of every op, so *compaction alone
buys nothing* — the pool must be **refilled**.  A fixed-size ray pool steps through bounces;
every iteration, lanes whose path terminated (miss / light hit / absorbed /
Russian roulette / bounce budget) splat their radiance into the film with a
scatter-add and are immediately reloaded with the next (pixel, sample) from
the pass's work queue.  Occupancy therefore stays ~100% until the tail of
the pass, regardless of scene-dependent path-length variance — the analogue
of persistent-threads megakernels on GPUs, expressed as a jitted
``lax.while_loop``.

Radiometry is identical to the megakernel integrator (both call
``trace_bounce``); renders differ only in RNG pairing, agreeing within
Monte-Carlo noise (tested).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from unity_webgpu_pathtracer_tpu.config import RenderConfig, RenderParams
from unity_webgpu_pathtracer_tpu.ops import get_intersectors
from unity_webgpu_pathtracer_tpu.render import camera as ucamera
from unity_webgpu_pathtracer_tpu.render import film as ufilm
from unity_webgpu_pathtracer_tpu.render.integrator import ALPHA_SLACK, PathState, trace_bounce
from unity_webgpu_pathtracer_tpu.utils import rng as urng
from unity_webgpu_pathtracer_tpu.utils.math import luminance


class PoolState(NamedTuple):
    path: PathState
    pixel: jnp.ndarray        # (P,) int32 film pixel of each lane's path
    lane_depth_cap: jnp.ndarray  # (P,) int32 loop-iteration guard per path
    film_sum: jnp.ndarray     # (npix, 3) radiance sums
    queue_head: jnp.ndarray   # () int32 next work item
    alive_ticks: jnp.ndarray  # () int32 occupancy numerator (= closest rays)
    shade_ticks: jnp.ndarray  # () int32 lanes that ran NEE (shadow-ray count)
    ticks: jnp.ndarray        # () int32 occupancy denominator (iters * P)


def _splat(film_sum, pixel, radiance, mask, config, params):
    """Scatter-add finished paths into the film, with firefly clamp."""
    if config.use_firefly_filter:
        lum = luminance(radiance)
        scale = jnp.where(
            lum > params.max_firefly_luminance,
            params.max_firefly_luminance / jnp.maximum(lum, 1e-20),
            1.0,
        )
        radiance = radiance * scale[:, None]
    contrib = jnp.where(mask[:, None], radiance, 0.0)
    idx = jnp.where(mask, pixel, 0)
    return film_sum.at[idx].add(contrib)


def _regenerate(s: PoolState, config: RenderConfig, params: RenderParams,
                budget: int, current_sample):
    """Reload dead lanes with the next (pixel, sample) work items."""
    npix = config.pixel_count()
    dead = ~s.path.alive
    remaining = budget - s.queue_head
    rank = jnp.cumsum(dead.astype(jnp.int32)) - 1          # rank among dead lanes
    work_id = s.queue_head + rank
    take = dead & (rank < remaining)
    pixel_new = (work_id % npix).astype(jnp.uint32)
    sample_new = (work_id // npix).astype(jnp.uint32) + jnp.asarray(current_sample, jnp.uint32)

    rng_new = urng.seed(pixel_new, sample_new, params.seed_root)
    coords, rng_new = ucamera.jittered_pixel_coords(
        pixel_new.astype(jnp.int32).astype(jnp.uint32), config, rng_new
    )
    o_new, d_new, rng_new = ucamera.get_screen_ray(coords, config, params, rng_new)

    p = s.path
    tk = take[:, None]
    path = PathState(
        origin=jnp.where(tk, o_new, p.origin),
        direction=jnp.where(tk, d_new, p.direction),
        radiance=jnp.where(tk, 0.0, p.radiance),
        throughput=jnp.where(tk, 1.0, p.throughput),
        rng=jnp.where(take, rng_new, p.rng),
        alive=p.alive | take,
        prev_pdf=jnp.where(take, 0.0, p.prev_pdf),
        max_roughness=jnp.where(take, 0.0, p.max_roughness),
        depth=jnp.where(take, 0, p.depth),
    )
    pixel = jnp.where(take, pixel_new.astype(jnp.int32), s.pixel)
    cap = jnp.where(take, config.max_bounces + 1 + ALPHA_SLACK, s.lane_depth_cap)
    head = s.queue_head + jnp.minimum(jnp.sum(dead.astype(jnp.int32)), remaining)
    return s._replace(path=path, pixel=pixel, lane_depth_cap=cap, queue_head=head)


def wavefront_pass(scene, config: RenderConfig, params: RenderParams,
                   current_sample, pool_size: int | None = None):
    """One pass of ``samples_per_pass`` spp over the whole film.

    Returns ``(film_sum (npix, 3), occupancy scalar in [0,1])``.
    """
    film_sum, occupancy, _, _ = wavefront_pass_with_stats(
        scene, config, params, current_sample, pool_size
    )
    return film_sum, occupancy


def wavefront_pass_with_stats(scene, config, params, current_sample,
                              pool_size=None):
    """Like :func:`wavefront_pass` but also returns ray counts for benching.

    Returns ``(film_sum, occupancy, closest_rays, shadow_rays)`` where
    shadow_rays accounts for the NEE branches enabled by the config.
    """
    closest_fn, occluded_fn = get_intersectors(config)
    npix = config.pixel_count()
    budget = npix * config.samples_per_pass
    p = pool_size or config.pool_size or min(npix, 1 << 16)

    zeros3 = jnp.zeros((p, 3), jnp.float32)
    init = PoolState(
        path=PathState(
            origin=zeros3, direction=zeros3.at[:, 2].set(1.0),
            radiance=zeros3, throughput=zeros3,
            rng=jnp.zeros((p,), jnp.uint32),
            alive=jnp.zeros((p,), bool),
            prev_pdf=jnp.zeros((p,), jnp.float32),
            max_roughness=jnp.zeros((p,), jnp.float32),
            depth=jnp.zeros((p,), jnp.int32),
        ),
        pixel=jnp.zeros((p,), jnp.int32),
        lane_depth_cap=jnp.zeros((p,), jnp.int32),
        film_sum=jnp.zeros((npix, 3), jnp.float32),
        queue_head=jnp.asarray(0, jnp.int32),
        alive_ticks=jnp.asarray(0, jnp.int32),
        shade_ticks=jnp.asarray(0, jnp.int32),
        ticks=jnp.asarray(0, jnp.int32),
    )

    def cond(s: PoolState):
        return jnp.any(s.path.alive) | (s.queue_head < budget)

    def body(s: PoolState):
        s = _regenerate(s, config, params, budget, current_sample)
        was_alive = s.path.alive
        path, shade = trace_bounce(scene, config, params, s.path, closest_fn,
                                   occluded_fn, with_stats=True)
        cap = s.lane_depth_cap - 1
        path = path._replace(alive=path.alive & (cap > 0))
        died = was_alive & ~path.alive
        film_sum = _splat(s.film_sum, s.pixel, path.radiance, died, config, params)
        return PoolState(
            path=path, pixel=s.pixel, lane_depth_cap=cap, film_sum=film_sum,
            queue_head=s.queue_head,
            alive_ticks=s.alive_ticks + jnp.sum(was_alive.astype(jnp.int32)),
            shade_ticks=s.shade_ticks + jnp.sum(shade.astype(jnp.int32)),
            ticks=s.ticks + p,
        )

    final = jax.lax.while_loop(cond, body, init)
    occupancy = final.alive_ticks.astype(jnp.float32) / jnp.maximum(
        final.ticks.astype(jnp.float32), 1.0
    )
    from unity_webgpu_pathtracer_tpu.config import SKY_MODE_ENVIRONMENT

    nee_branches = (1 if config.sky_mode == SKY_MODE_ENVIRONMENT else 0) + (
        1 if config.has_lights else 0
    )
    return (
        final.film_sum,
        occupancy,
        final.alive_ticks,
        final.shade_ticks * nee_branches,
    )


@functools.partial(jax.jit, static_argnums=(1,))
def wavefront_pass_and_accumulate(scene, config: RenderConfig,
                                  params: RenderParams, film: ufilm.Film):
    total, _occ = wavefront_pass(scene, config, params,
                                 jnp.max(film.sample_count))
    total = total.reshape(config.height, config.width, 3)
    return ufilm.accumulate(film, total, config.samples_per_pass)
