"""The fused pass on the production shape (wide16 + HDRI env NEE + record
film, the bench config at a tiny size) with the XLA transition: pool
sizes that are not multiples of 1024, Russian roulette on and off, the
oct-normal attr rows, the firefly clamp and NaN canary, the other film
modes, and multi-pass accumulation through ``Renderer``."""

import dataclasses

import jax
import numpy as np
import pytest

from unity_webgpu_pathtracer_tpu.config import SKY_MODE_ENVIRONMENT, RenderConfig
from unity_webgpu_pathtracer_tpu.models.benchmark import million_triangle_scene
from unity_webgpu_pathtracer_tpu.render import fused
from unity_webgpu_pathtracer_tpu.render.camera import make_camera_params
from unity_webgpu_pathtracer_tpu.utils.math import luminance

W, H, SPP = 40, 24, 4


def bench_like(**overrides):
    kw = dict(
        width=W, height=H, samples_per_pass=SPP, max_bounces=5,
        traversal="wide16", sky_mode=SKY_MODE_ENVIRONMENT,
        has_environment_texture=True, use_russian_roulette=True,
        integrator="fused", pool_size=1024, bvh_octants=1,
        transition_every=4, attr_compact=2,
    )
    kw.update(overrides)
    return RenderConfig(**kw)


@pytest.fixture(scope="module")
def small_scene():
    scene, cam = million_triangle_scene(2000)
    return scene.build("wide16"), make_camera_params(width=W, height=H, **cam)


_step = jax.jit(fused.fused_pass_with_stats, static_argnums=(1,))


def run(small_scene, config, current_sample=0, params=None):
    sd, p = small_scene
    film, occ, rays, arr = _step(sd, config, params or p, current_sample)
    return np.asarray(film), int(rays), float(occ)


@pytest.fixture(scope="module")
def reference(small_scene):
    return run(small_scene, bench_like(pool_size=2048))


@pytest.mark.parametrize("pool", [1000, 1152, 1280, 4608])
def test_fused_film_any_pool_size(small_scene, reference, pool):
    """Per-sample radiance is keyed on (pixel, sample) seeds and each
    lane's RNG advances once per transition whatever the pool does, so
    any pool size gives the same rays and the same film up to the
    resolve's summation order."""
    film, rays, occ = run(small_scene, bench_like(pool_size=pool))
    ref_film, ref_rays, _ = reference
    assert rays == ref_rays
    assert 0.0 < occ <= 1.0
    np.testing.assert_allclose(film, ref_film, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("attr_compact", [2, 3])
def test_russian_roulette_on_off(small_scene, attr_compact):
    """RR trades rays for variance without bias: fewer rays, the same
    image within Monte-Carlo noise."""
    on = run(small_scene, bench_like(attr_compact=attr_compact,
                                     samples_per_pass=16))
    off = run(small_scene, bench_like(attr_compact=attr_compact,
                                      samples_per_pass=16,
                                      use_russian_roulette=False))
    assert np.isfinite(on[0]).all() and np.isfinite(off[0]).all()
    assert on[1] < off[1]
    assert abs(on[0].mean() - off[0].mean()) / off[0].mean() < 0.05


def test_oct_normal_rows_match_f16_rows(small_scene, reference):
    """attr_compact=3 (16-byte octahedral normals) shades like the f16
    rows up to normal quantization."""
    film, rays, _ = run(small_scene, bench_like(pool_size=2048,
                                                attr_compact=3))
    ref_film, ref_rays, _ = reference
    assert abs(rays - ref_rays) / ref_rays < 0.02
    assert abs(film.mean() - ref_film.mean()) / ref_film.mean() < 0.02


@pytest.mark.parametrize("firefly,canary", [(False, True), (True, False),
                                            (True, True)])
def test_firefly_clamp_and_canary(small_scene, reference, firefly, canary):
    """The canary only repaints NaN samples (none here): the film stays
    the same up to FMA contraction.  The firefly clamp bounds every
    sample's luminance."""
    sd, params = small_scene
    max_lum = 0.05
    params = dataclasses.replace(params,
                                 max_firefly_luminance=np.float32(max_lum))
    film, rays, _ = run(small_scene, bench_like(
        pool_size=2048, use_firefly_filter=firefly, debug_nan_canary=canary),
        params=params)
    ref_film, ref_rays, _ = reference
    assert rays == ref_rays
    if not firefly:
        np.testing.assert_allclose(film, ref_film, rtol=1e-6, atol=1e-7)
    else:
        lum = np.asarray(luminance(film)) / SPP
        assert lum.max() <= max_lum * (1 + 1e-5)
        assert film.mean() < ref_film.mean()


@pytest.mark.parametrize("film_kw", [
    dict(use_record_film=False, use_sorted_film=True, film_k_shift=1),
    dict(use_record_film=False, use_sorted_film=False),
    dict(use_lane_film=True),
], ids=["sorted", "scatter", "lane"])
def test_film_modes_match_record_film(small_scene, reference, film_kw):
    """Every film mode sums the same per-sample radiance; only the
    summation order differs."""
    film, rays, _ = run(small_scene, bench_like(pool_size=2048, **film_kw))
    ref_film, ref_rays, _ = reference
    assert rays == ref_rays
    np.testing.assert_allclose(film, ref_film, rtol=1e-5, atol=1e-6)


def test_multi_pass_accumulates(small_scene):
    """Two progressive passes through ``Renderer`` average two fused
    passes whose sample indices continue where the first stopped."""
    from unity_webgpu_pathtracer_tpu.api import Renderer

    sd, params = small_scene
    config = bench_like(pool_size=2048)
    r = Renderer(sd, config, params, compile_cache=False)
    r.render(2)
    f0, _, _ = run(small_scene, config, 0)
    f1, _, _ = run(small_scene, config, SPP)
    assert not np.array_equal(f0, f1)
    want = ((f0 + f1) / (2 * SPP)).reshape(H, W, 3)
    np.testing.assert_allclose(r.radiance(), want, rtol=1e-5, atol=1e-6)
    assert r.sample_count == 2 * SPP


def test_arrival_fori_matches_unrolled(small_scene, reference):
    """``arrival_fori`` iterates one arrival in a fori_loop instead of
    unrolling te of them: same rays, same film up to FMA contraction."""
    film, rays, _ = run(small_scene, bench_like(pool_size=2048,
                                                arrival_fori=True))
    ref_film, ref_rays, _ = reference
    assert rays == ref_rays
    np.testing.assert_allclose(film, ref_film, rtol=1e-5, atol=1e-6)
