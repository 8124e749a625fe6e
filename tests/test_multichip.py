"""Multi-chip sharding on the 8-device virtual CPU mesh.

Key property (SURVEY.md §4): the RNG is keyed by (pixel, sample), so a
film-tiled multi-chip render is *bitwise identical* to the single-chip
render — sharding must never change the image.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from unity_webgpu_pathtracer_tpu.config import RenderConfig
from unity_webgpu_pathtracer_tpu.models.cornell import cornell_box
from unity_webgpu_pathtracer_tpu.parallel.film_tiling import (
    make_mesh,
    multichip_render_pass,
    multichip_samples_per_pass,
)
from unity_webgpu_pathtracer_tpu.render.camera import make_camera_params
from unity_webgpu_pathtracer_tpu.render.integrator import render_pass


SIZE = 32


def _setup(spp=2):
    scene, cam = cornell_box()
    config = RenderConfig(width=SIZE, height=SIZE, samples_per_pass=spp,
                          max_bounces=3, traversal="mbvh", sky_mode=2)
    params = make_camera_params(width=SIZE, height=SIZE, **cam)
    return scene.build(config.traversal), config, params


@pytest.mark.slow
@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_tile_sharded_bitwise_equals_single_chip():
    scene, config, params = _setup()
    mesh = make_mesh(n_tile=8, n_spp=1)
    multi = multichip_render_pass(scene, config, params, 0, mesh)
    single = render_pass(scene, config, params, 0)
    np.testing.assert_array_equal(np.asarray(multi), np.asarray(single))


@pytest.mark.slow
@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_tile_and_spp_sharded():
    scene, config, params = _setup(spp=1)
    mesh = make_mesh(n_tile=4, n_spp=2)
    multi = np.asarray(multichip_render_pass(scene, config, params, 0, mesh))
    assert multichip_samples_per_pass(config, mesh) == 2
    # spp axis sums two disjoint sample blocks: equals the sequential
    # single-chip sums for current_sample=0 and =1.
    s0 = np.asarray(render_pass(scene, config, params, 0))
    s1 = np.asarray(render_pass(scene, config, params, 1))
    np.testing.assert_allclose(multi, s0 + s1, rtol=1e-5, atol=1e-5)


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_mesh_validation():
    with pytest.raises(ValueError):
        make_mesh(n_tile=16, n_spp=1)


@pytest.mark.slow
def test_multichip_fused_equals_single_chip():
    """The PRODUCTION integrator (fused wavefront, wide8) sharded over a
    (tile=4, spp=2) mesh matches the single-chip pass with the same total
    sample count to 1 ulp (seeds are (global pixel, global sample), so
    every sample's radiance is bitwise identical; the only non-determinism
    left is film scatter-add DUPLICATE ordering when two samples of one
    pixel die in the same transition, which shard-local lane order can
    permute — a 1-ulp association difference)."""
    import jax
    import numpy as np

    from unity_webgpu_pathtracer_tpu.config import RenderConfig
    from unity_webgpu_pathtracer_tpu.models.cornell import cornell_box
    from unity_webgpu_pathtracer_tpu.parallel.film_tiling import (
        make_mesh,
        multichip_fused_pass,
    )
    from unity_webgpu_pathtracer_tpu.render.camera import make_camera_params
    from unity_webgpu_pathtracer_tpu.render.fused import fused_pass_with_stats

    size = 32
    scene, cam = cornell_box()
    sd = scene.build("wide8")
    params = make_camera_params(width=size, height=size, **cam)
    config = RenderConfig(width=size, height=size, samples_per_pass=2,
                          max_bounces=3, traversal="wide8", sky_mode=2,
                          integrator="fused", pool_size=2048)
    mesh = make_mesh(n_tile=4, n_spp=2)
    film_mc, occ, rays, arr = multichip_fused_pass(sd, config, params, 0,
                                                   mesh, pool_size=2048)
    cfg1 = RenderConfig(width=size, height=size, samples_per_pass=4,
                        max_bounces=3, traversal="wide8", sky_mode=2,
                        integrator="fused", pool_size=2048)
    film_1, *_ = jax.jit(
        fused_pass_with_stats, static_argnums=(1,),
        static_argnames=("pool_size",),
    )(sd, cfg1, params, 0, pool_size=2048)
    a, b = np.asarray(film_mc), np.asarray(film_1)
    np.testing.assert_allclose(a, b, rtol=3e-7, atol=0.0)
    assert (a == b).mean() > 0.99, (a == b).mean()
    assert int(rays) > 0 and float(occ) > 0


def test_multichip_fused_flagship_wide16():
    """The SHIPPED flagship config (fused + wide16 + prestep + record
    film, all config defaults) sharded over
    (tile, spp) must match the single-chip film to 1 ulp (sample radiance
    is bitwise; only scatter association differs across the psum)."""
    import jax
    import numpy as np

    from unity_webgpu_pathtracer_tpu.config import RenderConfig
    from unity_webgpu_pathtracer_tpu.models.cornell import cornell_box
    from unity_webgpu_pathtracer_tpu.parallel.film_tiling import (
        make_mesh,
        multichip_fused_pass,
    )
    from unity_webgpu_pathtracer_tpu.render.camera import make_camera_params
    from unity_webgpu_pathtracer_tpu.render.fused import fused_pass_with_stats

    size = 32
    scene, cam = cornell_box()
    sd = scene.build("wide16")
    params = make_camera_params(width=size, height=size, **cam)

    def cfg(spp):
        return RenderConfig(
            width=size, height=size, samples_per_pass=spp, max_bounces=3,
            traversal="wide16", sky_mode=2, integrator="fused",
            pool_size=1024, use_prestep=True,
        )

    mesh = make_mesh(n_tile=4, n_spp=2)
    film_mc, occ, rays, _ = multichip_fused_pass(
        sd, cfg(2), params, 0, mesh, pool_size=1024)
    film_1, *_ = jax.jit(
        fused_pass_with_stats, static_argnums=(1,),
        static_argnames=("pool_size",),
    )(sd, cfg(4), params, 0, pool_size=1024)
    a, b = np.asarray(film_mc), np.asarray(film_1)
    np.testing.assert_allclose(a, b, rtol=3e-7, atol=0.0)
    assert (a == b).mean() > 0.99, (a == b).mean()
    assert int(rays) > 0 and float(occ) > 0


def test_multichip_fused_record_film():
    """Record film (append buffer + end-of-pass sort resolve) sharded over
    (tile, spp): each shard's record buffer/resolve is shard-local, so the
    psum-reduced film must match single-chip to the same 1-ulp association
    tolerance as the other film modes."""
    import dataclasses

    import jax
    import numpy as np

    from unity_webgpu_pathtracer_tpu.config import RenderConfig
    from unity_webgpu_pathtracer_tpu.models.cornell import cornell_box
    from unity_webgpu_pathtracer_tpu.parallel.film_tiling import (
        make_mesh,
        multichip_fused_pass,
    )
    from unity_webgpu_pathtracer_tpu.render.camera import make_camera_params
    from unity_webgpu_pathtracer_tpu.render.fused import fused_pass_with_stats

    size = 32
    scene, cam = cornell_box()
    sd = scene.build("wide16")
    params = make_camera_params(width=size, height=size, **cam)

    def cfg(spp):
        return RenderConfig(
            width=size, height=size, samples_per_pass=spp, max_bounces=3,
            traversal="wide16", sky_mode=2, integrator="fused",
            pool_size=1024, use_prestep=True,
            use_record_film=True, film_k_shift=0,
        )

    mesh = make_mesh(n_tile=4, n_spp=2)
    film_mc, occ, rays, _ = multichip_fused_pass(
        sd, cfg(2), params, 0, mesh, pool_size=1024)
    film_1, *_ = jax.jit(
        fused_pass_with_stats, static_argnums=(1,),
        static_argnames=("pool_size",),
    )(sd, cfg(4), params, 0, pool_size=1024)
    a, b = np.asarray(film_mc), np.asarray(film_1)
    np.testing.assert_allclose(a, b, rtol=3e-7, atol=1e-7)
    assert int(rays) > 0 and float(occ) > 0
