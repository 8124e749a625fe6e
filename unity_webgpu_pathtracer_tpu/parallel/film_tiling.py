"""Multi-chip rendering over a ``jax.sharding.Mesh``.

The reference is single-GPU (SURVEY.md §2.4); this is the scaling layer
this rebuild adds.  Two orthogonal axes:

* ``tile``  — the film plane is row-sharded; each device traces only its
  own pixels.  Scene arrays (BVH, triangles, materials, env CDF) are
  replicated into every device's memory.  No communication until film
  assembly.
* ``spp``   — samples are sharded; each device renders the *whole* film
  with a disjoint sample-index range and the pass results are summed with
  a ``psum`` (NCCL between GPUs).

Both are expressed with ``shard_map`` so XLA sees single-chip programs plus
explicit collectives, following the mesh-first recipe (pick a mesh, shard,
let XLA insert the transfers).
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from unity_webgpu_pathtracer_tpu.config import RenderConfig, RenderParams
from unity_webgpu_pathtracer_tpu.render.integrator import render_pass


def make_mesh(n_tile: int, n_spp: int = 1, devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    need = n_tile * n_spp
    if len(devices) < need:
        raise ValueError(f"need {need} devices, have {len(devices)}")
    dev = np.asarray(devices[:need]).reshape(n_tile, n_spp)
    return Mesh(dev, axis_names=("tile", "spp"))


def multichip_render_pass(scene, config: RenderConfig, params: RenderParams,
                          current_sample, mesh: Mesh):
    """One progressive pass sharded over ``mesh`` axes (tile, spp).

    Returns the full-film radiance sum, replicated on every chip, summed
    over the pass's ``samples_per_pass * n_spp`` samples.  The caller's
    film-accumulation must count that many samples.
    """
    npix = config.pixel_count()
    n_tile = mesh.shape["tile"]
    n_spp = mesh.shape["spp"]
    if npix % n_tile:
        raise ValueError("pixel count must divide the tile axis")
    shard = npix // n_tile

    def per_chip(scene_rep, params_rep, current_sample_rep):
        t = jax.lax.axis_index("tile")
        s = jax.lax.axis_index("spp")
        pixels = (t * shard + jnp.arange(shard)).astype(jnp.uint32)
        # Disjoint sample ranges per spp-shard (reference counts samples
        # sequentially; each chip takes a stride-offset block).
        sample0 = current_sample_rep + s * config.samples_per_pass
        tile_sum = render_pass(scene_rep, config, params_rep, sample0,
                               pixel_indices=pixels)
        # Sum the spp axis (psum), then assemble tiles (all_gather).
        tile_sum = jax.lax.psum(tile_sum, axis_name="spp")
        return jax.lax.all_gather(tile_sum, axis_name="tile", axis=0).reshape(npix, 3)

    fn = shard_map(
        per_chip,
        mesh=mesh,
        in_specs=(P(), P(), P()),
        out_specs=P(),
        # The traversal while_loop carries become device-varying mid-loop;
        # skip the static varying-axes check (semantics unaffected).
        check_vma=False,
    )
    return fn(scene, params, jnp.asarray(current_sample, jnp.uint32))


def multichip_samples_per_pass(config: RenderConfig, mesh: Mesh) -> int:
    return config.samples_per_pass * mesh.shape["spp"]


def multichip_fused_pass(scene, config: RenderConfig, params: RenderParams,
                         current_sample, mesh: Mesh,
                         pool_size: int | None = None):
    """One fused-wavefront pass sharded over ``mesh`` (tile, spp) — the
    PRODUCTION integrator's multichip path.

    Each shard runs its own work queue over its pixel rows and sample
    block; seeds stay (global pixel, global sample) so the estimate is the
    single-chip one. Per-pass sample count is
    ``config.samples_per_pass * n_spp``. Returns the full film (replicated)
    plus pooled (occupancy, rays, arrivals).
    """
    from unity_webgpu_pathtracer_tpu.render.fused import fused_pass_with_stats

    npix = config.pixel_count()
    n_tile = mesh.shape["tile"]
    n_spp = mesh.shape["spp"]
    if npix % n_tile:
        raise ValueError("pixel count must divide the tile axis")
    npix_l = npix // n_tile
    spp_l = config.samples_per_pass

    def per_chip(scene_rep, params_rep, current_sample_rep):
        t = jax.lax.axis_index("tile")
        si = jax.lax.axis_index("spp")
        pixel_base = (t * npix_l).astype(jnp.uint32)
        sample_base = (si * spp_l).astype(jnp.uint32)
        film, occ, rays, arr = fused_pass_with_stats(
            scene_rep, config, params_rep, current_sample_rep,
            pool_size=pool_size,
            shard=(pixel_base, npix_l, sample_base, spp_l),
        )
        film = jax.lax.psum(film, axis_name="spp")
        full = jax.lax.all_gather(film, axis_name="tile", axis=0)
        occ = jax.lax.pmean(jax.lax.pmean(occ, "spp"), "tile")
        rays = jax.lax.psum(jax.lax.psum(rays, "spp"), "tile")
        arr = jax.lax.psum(jax.lax.psum(arr, "spp"), "tile")
        return full.reshape(npix, 3), occ, rays, arr

    fn = shard_map(
        per_chip,
        mesh=mesh,
        in_specs=(P(), P(), P()),
        out_specs=(P(), P(), P(), P()),
        check_vma=False,
    )
    return fn(scene, params, jnp.asarray(current_sample, jnp.uint32))
