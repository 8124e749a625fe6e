"""Wide (fat-row 4-ary) traversal + fused integrator tests."""

import jax.numpy as jnp
import numpy as np
import pytest

from unity_webgpu_pathtracer_tpu.accel import build_scene_wide_bvh
from unity_webgpu_pathtracer_tpu.accel.wide import validate_wide
from unity_webgpu_pathtracer_tpu.api import Renderer
from unity_webgpu_pathtracer_tpu.config import SKY_MODE_ENVIRONMENT, RenderConfig
from unity_webgpu_pathtracer_tpu.models import primitives as prim
from unity_webgpu_pathtracer_tpu.models.benchmark import procedural_hdri
from unity_webgpu_pathtracer_tpu.models.cornell import cornell_box
from unity_webgpu_pathtracer_tpu.ops import intersect as bf
from unity_webgpu_pathtracer_tpu.ops import traverse_wide as tw
from unity_webgpu_pathtracer_tpu.render.camera import make_camera_params
from unity_webgpu_pathtracer_tpu.scene.material import MaterialDesc
from unity_webgpu_pathtracer_tpu.scene.scene import Scene

from tests.test_bvh import _random_rays, _random_tris, _scene_from_positions


def _wide_scene(pos, octants):
    n = pos.shape[0]
    v0 = pos[:, 0]
    recs = np.concatenate([pos[:, 2] - v0, pos[:, 1] - v0, v0], -1).astype(np.float32)
    nodes = build_scene_wide_bvh(pos, recs, octants=octants)
    return _scene_from_positions(pos)._replace(
        tris=jnp.asarray(recs),
        tri_index=jnp.arange(n, dtype=jnp.int32),
        wide_nodes=jnp.asarray(nodes),
    ), nodes


@pytest.mark.parametrize("ntri,octants", [(1, 1), (50, 1), (800, 1), (800, 8)])
def test_wide_matches_bruteforce(ntri, octants):
    pos = _random_tris(ntri, seed=ntri + octants)
    scene, nodes = _wide_scene(pos, octants)
    validate_wide(nodes, ntri)
    o, d = _random_rays(512, seed=ntri)
    t1, b1, s1, _ = tw.closest_hit(scene, o, d)
    t2, b2, s2, _ = bf.closest_hit_bruteforce(scene, o, d)
    np.testing.assert_allclose(np.asarray(t1), np.asarray(t2), rtol=1e-4, atol=1e-4)
    hit = np.asarray(t2) < 1e5
    np.testing.assert_array_equal(np.asarray(s1)[hit], np.asarray(s2)[hit])
    occ1 = np.asarray(tw.occluded(scene, o, d, jnp.full((512,), 8.0)))
    occ2 = np.asarray(bf.occluded_bruteforce(scene, o, d, jnp.full((512,), 8.0)))
    np.testing.assert_array_equal(occ1, occ2)


@pytest.mark.slow
def test_fused_white_furnace():
    scene = Scene()
    m = scene.add_material(MaterialDesc(base_color=(1, 1, 1, 1), roughness=1.0))
    scene.add_mesh(prim.uv_sphere(radius=1.0, stacks=12, slices=24, material_index=m))
    size = 32
    config = RenderConfig(width=size, height=size, samples_per_pass=16, max_bounces=8,
                          traversal="wide", sky_mode=SKY_MODE_ENVIRONMENT,
                          integrator="fused", pool_size=2048)
    params = make_camera_params(eye=(0, 0, 3), target=(0, 0, 0), fov_y_deg=45,
                                width=size, height=size,
                                environment_color=np.array([1.0, 1.0, 1.0], np.float32))
    r = Renderer(scene, config, params)
    r.render(1)
    img = r.radiance()
    assert np.isfinite(img).all()
    assert img[:4, :4].mean() == pytest.approx(1.0, abs=1e-4)
    assert 0.95 < img.mean() < 1.12


@pytest.mark.slow
def test_fused_matches_megakernel_env_texture():
    scene = Scene()
    m = scene.add_material(MaterialDesc(base_color=(0.7, 0.4, 0.3, 1), roughness=0.4,
                                        metallic=0.3))
    scene.add_mesh(prim.uv_sphere(radius=1.0, stacks=12, slices=24, material_index=m))
    scene.set_environment(procedural_hdri(64))
    size = 32
    kw = dict(width=size, height=size, samples_per_pass=48, max_bounces=5,
              sky_mode=SKY_MODE_ENVIRONMENT, has_environment_texture=True)
    params = make_camera_params(eye=(0, 0, 3), target=(0, 0, 0), fov_y_deg=45,
                                width=size, height=size)
    rf = Renderer(scene, RenderConfig(traversal="wide", integrator="fused",
                                      pool_size=2048, **kw), params)
    rm = Renderer(scene, RenderConfig(traversal="bruteforce",
                                      integrator="megakernel", **kw), params)
    rf.render(1)
    rm.render(1)
    a, b = rf.radiance(), rm.radiance()
    k = 8
    ad = a.reshape(size // k, k, size // k, k, 3).mean((1, 3))
    bd = b.reshape(size // k, k, size // k, k, 3).mean((1, 3))
    rel = np.abs(ad - bd) / (bd + 0.05)
    assert rel.mean() < 0.05, rel.mean()


@pytest.mark.slow
def test_fused_cornell_statistics():
    scene, cam = cornell_box()
    size = 32
    kw = dict(width=size, height=size, samples_per_pass=64, max_bounces=4, sky_mode=2)
    params = make_camera_params(width=size, height=size, **cam)
    rf = Renderer(scene, RenderConfig(traversal="wide", integrator="fused",
                                      pool_size=2048, **kw), params)
    rm = Renderer(scene, RenderConfig(traversal="bruteforce",
                                      integrator="megakernel", **kw), params)
    rf.render(1)
    rm.render(1)
    a, b = rf.radiance(), rm.radiance()
    assert np.isfinite(a).all()
    assert abs(a.mean() - b.mean()) / max(b.mean(), 1e-9) < 0.08


def test_fused_deterministic():
    scene, cam = cornell_box()
    size = 24
    config = RenderConfig(width=size, height=size, samples_per_pass=2, max_bounces=3,
                          sky_mode=2, traversal="wide", integrator="fused",
                          pool_size=512)
    params = make_camera_params(width=size, height=size, **cam)
    r1 = Renderer(scene, config, params)
    r2 = Renderer(scene, config, params)
    r1.render(2)
    r2.render(2)
    np.testing.assert_array_equal(r1.radiance(), r2.radiance())


def test_fused_table_carry_parity():
    """node_carry / env_carry re-stage gather layouts only — films must be
    bit-identical to the closure-captured tables (the attr_carry
    contract)."""
    import jax

    from unity_webgpu_pathtracer_tpu.models.benchmark import million_triangle_scene
    from unity_webgpu_pathtracer_tpu.render.fused import fused_pass_with_stats

    scene, cam = million_triangle_scene(2_000)
    sd = scene.build("wide16")
    params = make_camera_params(width=32, height=32, **cam,
                                environment_intensity=np.float32(1.0))
    step = jax.jit(fused_pass_with_stats, static_argnums=(1,),
                   static_argnames=("pool_size",))
    films = {}
    for name, nk, ek in (("base", False, False), ("both", True, True)):
        config = RenderConfig(
            width=32, height=32, samples_per_pass=2, max_bounces=3,
            traversal="wide16", sky_mode=SKY_MODE_ENVIRONMENT,
            has_environment_texture=True, use_russian_roulette=True,
            integrator="fused", pool_size=512, transition_every=8,
            node_carry=nk, env_carry=ek,
        )
        film, _occ, rays, _arr = step(sd, config, params, 0, pool_size=512)
        films[name] = np.asarray(film)
        assert int(rays) > 0
    assert (films["both"] == films["base"]).all()
