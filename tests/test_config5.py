"""BASELINE.md config 5 (stretch), composed: multi-chip render + animated
camera + temporal reprojection on the SHARDED film.

The reference analogue is the moving-camera accumulation-reset loop
(``Assets/Scripts/PathTracer.cs:211-222``); this composition goes further —
the film accumulated by the multichip fused pass (parallel/film_tiling.py)
is warped through a camera move (render/reproject.py) and accumulation
continues on the mesh, and the whole flow must agree with the single-chip
flow over the identical (pixel, sample) set (seeds are global, so the
estimates are bit-comparable).

The 4K-shaped multichip shape/memory validation lives in
``__graft_entry__.dryrun_multichip`` (compile-level — executing 8.3M
samples on the virtual CPU mesh is not feasible; the compile validates
tracing, sharding, and buffer layouts at 3840x2160).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from unity_webgpu_pathtracer_tpu.config import RenderConfig
from unity_webgpu_pathtracer_tpu.models.cornell import cornell_box
from unity_webgpu_pathtracer_tpu.parallel.film_tiling import (
    make_mesh,
    multichip_fused_pass,
    multichip_samples_per_pass,
)
from unity_webgpu_pathtracer_tpu.render.camera import make_camera_params
from unity_webgpu_pathtracer_tpu.render.film import accumulate, new_film
from unity_webgpu_pathtracer_tpu.render.fused import fused_pass_with_stats
from unity_webgpu_pathtracer_tpu.render.reproject import reproject_film

SIZE = 24


def _flow(scene_data, config, params0, params1, pass_fn, spp_pass):
    """Accumulate one pass at cam0, warp to cam1, accumulate one more."""
    h = w = SIZE
    film = new_film(h, w)
    total0 = pass_fn(scene_data, config, params0, 0)
    film = accumulate(film, total0.reshape(h, w, 3), spp_pass)
    warped = reproject_film(scene_data, config, film, params0, params1)
    total1 = pass_fn(scene_data, config, params1, spp_pass)
    return accumulate(warped, total1.reshape(h, w, 3), spp_pass)


@pytest.mark.smoke
def test_config5_reprojection_on_sharded_film():
    scene, cam = cornell_box()
    config = RenderConfig(
        width=SIZE, height=SIZE, samples_per_pass=4, max_bounces=3,
        sky_mode=2, traversal="wide16", integrator="fused", pool_size=512)
    scene_data = scene.build(config.traversal)
    params0 = make_camera_params(width=SIZE, height=SIZE, **cam)
    eye = np.asarray(cam["eye"], np.float64)
    moved = dict(cam, eye=tuple(eye + np.array([0.02, 0.01, 0.0])))
    params1 = make_camera_params(width=SIZE, height=SIZE, **moved)

    mesh = make_mesh(n_tile=4, n_spp=2)
    spp_pass = multichip_samples_per_pass(config, mesh)  # 8

    def multi_pass(sd, cfg, p, cur):
        film, _occ, rays, _arr = multichip_fused_pass(sd, cfg, p, cur, mesh,
                                                      pool_size=512)
        assert int(rays) > 0
        return film

    multi = _flow(scene_data, config, params0, params1, multi_pass, spp_pass)

    # Single-chip flow over the IDENTICAL (pixel, sample) set: the mesh's
    # spp shards take sample blocks [0,4) and [4,8), which is exactly a
    # single-chip samples_per_pass=8 pass (global seeds).
    config1 = dataclasses.replace(config, samples_per_pass=8)

    def single_pass(sd, cfg, p, cur):
        film, *_ = fused_pass_with_stats(sd, config1, p, cur, pool_size=512)
        return film

    single = _flow(scene_data, config, params0, params1, single_pass,
                   spp_pass)

    # History survived the small move on most pixels, and the multichip
    # composition matches the single-chip one.
    counts = np.asarray(multi.sample_count)[..., 0]
    assert np.isfinite(np.asarray(multi.accum)).all()
    assert (counts > spp_pass).mean() > 0.7, "history lost on a tiny move"
    np.testing.assert_allclose(np.asarray(multi.accum),
                               np.asarray(single.accum),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(multi.sample_count),
                               np.asarray(single.sample_count))
