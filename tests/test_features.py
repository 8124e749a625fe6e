"""Feature-level image tests: textures + alpha mask, analytic lights, DoF,
tonemap chain, preview renderer, CWBVH quantization, profiling."""

import numpy as np
import pytest

import jax.numpy as jnp

from unity_webgpu_pathtracer_tpu.api import Renderer
from unity_webgpu_pathtracer_tpu.config import PostParams, RenderConfig
from unity_webgpu_pathtracer_tpu.models.examples import (
    camera_aperture_scene,
    lights_scene,
    texture_scene,
)
from unity_webgpu_pathtracer_tpu.render.camera import make_camera_params
from unity_webgpu_pathtracer_tpu.post import tonemap as tm


def _render(builder, size=48, spp=16, **cfg_extra):
    scene, cam, overrides = builder()
    overrides = dict(overrides)
    overrides.pop("traversal", None)
    overrides.setdefault("has_lights", bool(scene.lights))
    overrides.setdefault("has_textures", bool(scene.textures))
    overrides.update(cfg_extra)
    config = RenderConfig(width=size, height=size, samples_per_pass=spp,
                          max_bounces=3, traversal="wide", **overrides)
    params = make_camera_params(width=size, height=size, **cam)
    r = Renderer(scene, config, params)
    r.render(1)
    return r.radiance()


def test_texture_and_alpha_mask():
    img = _render(texture_scene)
    assert np.isfinite(img).all()
    # Checker texture: center columns alternate in red/green dominance.
    mid = img[20:28, 16:32]
    assert mid.std() > 0.02
    # Alpha-masked border: rays pass through the quad edge to the floor/sky,
    # so the border region differs from an opaque quad's rendering.
    opaque = _render(lambda: _opaque_texture_scene())
    border_masked = img[8:12, 8:40].mean()
    border_opaque = opaque[8:12, 8:40].mean()
    assert abs(border_masked - border_opaque) > 0.01


def _opaque_texture_scene():
    scene, cam, overrides = texture_scene()
    scene.materials[0].alpha_mode = 0
    return scene, cam, overrides


@pytest.mark.slow
def test_analytic_lights_illuminate():
    img = _render(lights_scene, spp=24)
    assert np.isfinite(img).all()
    # No sky: all energy comes from the lights. Floor must be lit.
    assert img.mean() > 0.005
    assert img.max() > 0.05


def test_depth_of_field_geometry():
    """Thin-lens rays: origins spread over the aperture disk and converge
    exactly at the focal plane (camera.hlsl:22-38 semantics)."""
    from unity_webgpu_pathtracer_tpu.render import camera as uc

    config = RenderConfig(width=8, height=8, use_depth_of_field=True)
    params = uc.make_camera_params(eye=(0, 0, 4), target=(0, 0, 0), fov_y_deg=40,
                                   width=8, height=8, aperture=0.5, focal_length=4.0)
    st = jnp.arange(256, dtype=jnp.uint32)
    coords = jnp.stack([jnp.full((256,), 4.0), jnp.full((256,), 4.0)], -1)
    o, d, _ = uc.get_screen_ray(coords, config, params, st)
    o, d = np.asarray(o), np.asarray(d)
    assert o[:, 0].std() > 0.05 and o[:, 1].std() > 0.05  # lens sampling
    t = (0 - o[:, 2]) / d[:, 2]
    p = o + t[:, None] * d
    assert p.std(axis=0).max() < 1e-6                      # focal convergence


@pytest.mark.slow
def test_depth_of_field_blurs_out_of_focus():
    scene, cam, overrides = camera_aperture_scene()
    size = 48
    cam = dict(cam, aperture=1.2, focal_length=1.5)        # strongly defocused
    config = RenderConfig(width=size, height=size, samples_per_pass=48,
                          max_bounces=2, traversal="wide", **overrides)
    r = Renderer(scene, config, make_camera_params(width=size, height=size, **cam))
    r.render(1)
    dof = r.radiance()

    scene2, _, _ = camera_aperture_scene()
    cam_pin = dict(cam, aperture=0.0, focal_length=0.0)
    config_pin = RenderConfig(width=size, height=size, samples_per_pass=48,
                              max_bounces=2, traversal="wide",
                              sky_mode=overrides["sky_mode"])
    r2 = Renderer(scene2, config_pin, make_camera_params(width=size, height=size, **cam_pin))
    r2.render(1)
    pin = r2.radiance()

    def grad_energy(x, k=4):
        # Downsample first: per-pixel MC noise would otherwise dominate the
        # gradient; defocus blur survives averaging, noise does not.
        h = x.shape[0] // k
        ds = x.reshape(h, k, h, k, 3).mean((1, 3)).mean(-1)
        return np.abs(np.diff(ds, axis=0)).mean() + np.abs(np.diff(ds, axis=1)).mean()

    assert grad_energy(dof) < grad_energy(pin) * 0.7


def test_tonemap_operators_behave():
    x = jnp.asarray(np.linspace(0, 8, 64, dtype=np.float32).reshape(-1, 1).repeat(3, 1))
    for op in (tm.aces, tm.filmic, tm.reinhard, tm.lottes):
        y = np.asarray(op(x))
        assert np.isfinite(y).all()
        assert (np.diff(y[:, 0]) >= -1e-3).all(), op.__name__  # monotone
        assert y[-1, 0] <= 1.4
    # sRGB round trip.
    v = jnp.asarray(np.linspace(0, 1, 32, dtype=np.float32))
    np.testing.assert_allclose(np.asarray(tm.srgb_to_linear(tm.linear_to_srgb(v))),
                               np.asarray(v), atol=1e-5)
    # Presentation chain output in [0,1].
    img = jnp.asarray(np.random.default_rng(0).uniform(0, 4, (16, 16, 3)).astype(np.float32))
    out = np.asarray(tm.present(img, PostParams(vignette=0.3)))
    assert out.min() >= 0 and out.max() <= 1


def test_preview_renderer():
    from unity_webgpu_pathtracer_tpu.render.preview import preview
    from unity_webgpu_pathtracer_tpu.models.cornell import cornell_box

    scene, cam = cornell_box()
    size = 32
    config = RenderConfig(width=size, height=size, traversal="wide", sky_mode=2)
    data = scene.build("wide")
    params = make_camera_params(width=size, height=size, **cam)
    img = np.asarray(preview(data, config, params))
    assert img.shape == (size, size, 3)
    assert np.isfinite(img).all()
    # Red wall visible on the left, green on the right.
    assert img[16, 2, 0] > img[16, 2, 1]
    assert img[16, -3, 1] > img[16, -3, 0]


def test_cwbvh_parity_format():
    from unity_webgpu_pathtracer_tpu.accel import bvh2, mbvh
    from unity_webgpu_pathtracer_tpu.accel.cwbvh import (
        build_cwbvh,
        build_cwbvh_from_positions,
        validate_cwbvh,
    )

    r = np.random.default_rng(0)
    pos = (r.uniform(-10, 10, (300, 1, 3)) + r.normal(0, 0.5, (300, 3, 3))).astype(np.float32)
    bounds, child, order = mbvh.collapse_to_mbvh8(bvh2.build_bvh2(pos, leaf_size=3))
    nodes, tri_order = build_cwbvh(bounds, child)
    assert nodes.shape[1] == 20  # 80-byte / 5xfloat4 records
    assert sorted(tri_order.tolist()) == list(range(300))
    validate_cwbvh(nodes, bounds, child)
    # Meta bytes stay in range: unary counts <=3 bits, offsets <=5 bits.
    iview = nodes.view(np.uint32)
    meta = np.stack([iview[:, 6], iview[:, 7]], -1).view(np.uint8).reshape(-1, 8)
    inner = (meta & 0b11111) >= 24
    assert ((meta[~inner] & 0b11111) <= 24).all()

    # Full pipeline: reordered triangle records carry original indices.
    nodes2, recs, final_order = build_cwbvh_from_positions(pos)
    assert recs.shape == (300, 12)
    idx = recs[:, 11].view(np.int32)
    np.testing.assert_array_equal(idx, final_order)


def test_profiling_utilities():
    from unity_webgpu_pathtracer_tpu.models.cornell import cornell_box
    from unity_webgpu_pathtracer_tpu.utils.profiling import RenderStats, Timer, scene_summary

    scene, _ = cornell_box()
    data = scene.build("wide")
    stats = scene_summary(data)
    assert stats["triangles"] == int(data.tris.shape[0])
    assert stats["hbm_bytes"] > 0
    rs = RenderStats()
    rs.update(1_000_000, 5_000_000, 0.8, 0.5)
    assert abs(rs.mrays_per_sec - 2.0) < 1e-6
    with Timer("t", log=None) as t:
        pass
    assert t.elapsed >= 0


def test_many_lights_flat_compile():
    """32 rect lights take the on-device fori_loop path (compile size flat
    in light count); results must match the unrolled <=4-light semantics
    (Hyperion_rect_lights-style many-light scenes)."""
    import numpy as np
    import jax.numpy as jnp

    from unity_webgpu_pathtracer_tpu.config import LIGHT_TYPE_RECTANGLE, RenderConfig
    from unity_webgpu_pathtracer_tpu.render.fused import _analytic_light_hit, _light_hit_step
    from unity_webgpu_pathtracer_tpu.scene.lights import LightDesc, pack_lights

    rng = np.random.default_rng(7)
    descs = []
    for i in range(32):
        descs.append(LightDesc(
            type=LIGHT_TYPE_RECTANGLE,
            position=tuple(rng.uniform(-4, 4, 3)),
            right=(1, 0, 0), up=(0, 1, 0),
            size=(1.0, 1.0), color=(1, 1, 1), intensity=5.0, range=30))
    table = jnp.asarray(pack_lights(descs))

    class S:
        lights = table

    b = 256
    o = jnp.asarray(rng.uniform(-5, 5, (b, 3)).astype(np.float32))
    d_ = rng.normal(size=(b, 3)).astype(np.float32)
    d_ /= np.linalg.norm(d_, axis=-1, keepdims=True)
    d = jnp.asarray(d_)
    t = jnp.full((b,), 1e5, jnp.float32)

    hit, t_best, idx = _analytic_light_hit(S, o, d, t)

    # Reference: plain unrolled accumulation over the same table.
    t_ref = t
    idx_ref = jnp.full((b,), -1, jnp.int32)
    for i in range(32):
        t_ref, idx_ref = _light_hit_step(table[i], i, o, d, t_ref, idx_ref)
    assert np.array_equal(np.asarray(t_best), np.asarray(t_ref))
    assert np.array_equal(np.asarray(idx), np.asarray(idx_ref))
    assert np.asarray(hit).sum() > 0, "ray set never hits any light"


def test_many_lights_fused_render():
    """A 32-light scene renders finite, lit images through the fused
    integrator (NEE + analytic-light interception on the fori path)."""
    import numpy as np

    from unity_webgpu_pathtracer_tpu.config import LIGHT_TYPE_RECTANGLE, RenderConfig
    from unity_webgpu_pathtracer_tpu.models import primitives as prim
    from unity_webgpu_pathtracer_tpu.render.camera import make_camera_params
    from unity_webgpu_pathtracer_tpu.render.fused import fused_pass_with_stats
    from unity_webgpu_pathtracer_tpu.scene.lights import LightDesc
    from unity_webgpu_pathtracer_tpu.scene.material import MaterialDesc
    from unity_webgpu_pathtracer_tpu.scene.scene import Scene

    scene = Scene()
    floor = scene.add_material(MaterialDesc(base_color=(0.6, 0.6, 0.6, 1), roughness=0.8))
    g = prim.quad(size=(20, 20), material_index=floor)
    rx = np.eye(4, dtype=np.float32)
    c, s = np.cos(-np.pi / 2), np.sin(-np.pi / 2)
    rx[:3, :3] = np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float32)
    scene.add_mesh(g, rx)
    m = scene.add_material(MaterialDesc(base_color=(0.8, 0.8, 0.8, 1), roughness=0.4))
    scene.add_mesh(prim.uv_sphere(radius=0.6, material_index=m),
                   prim.transform_trs(translate=(0, 0.6, 0)))
    rng = np.random.default_rng(3)
    for i in range(32):
        ang = 2 * np.pi * i / 32
        scene.add_light(LightDesc(
            type=LIGHT_TYPE_RECTANGLE,
            position=(3.5 * np.cos(ang), 2.5, 3.5 * np.sin(ang)),
            right=(1, 0, 0), up=(0, 0, 1), size=(0.5, 0.5),
            color=tuple(rng.uniform(0.3, 1.0, 3)), intensity=4.0, range=30))
    size = 32
    cam = dict(eye=(0, 2.0, 6.0), target=(0, 0.5, 0), fov_y_deg=45.0)
    params = make_camera_params(width=size, height=size, **cam)
    config = RenderConfig(width=size, height=size, samples_per_pass=4,
                          max_bounces=3, traversal="wide16", sky_mode=2,
                          integrator="fused", pool_size=1024, has_lights=True)
    sd = scene.build("wide16")
    film, _occ, _rays, _arr = fused_pass_with_stats(sd, config, params,
                                                    np.uint32(0), pool_size=1024)
    f = np.asarray(film)
    assert np.isfinite(f).all()
    assert f.mean() > 0.01, "many-light scene rendered black"


def test_mask_stale_gathers_identical_with_lights():
    """mask_stale_gathers on a scene with analytic lights (exercises the
    MODE_SHADOW_LIGHT need-mask term): film exactly identical."""
    from unity_webgpu_pathtracer_tpu.render.fused import fused_pass_with_stats

    scene, cam, overrides = lights_scene()
    sd = scene.build("wide16")
    size = 40
    params = make_camera_params(width=size, height=size, **cam)
    films = {}
    for flag in (False, True):
        config = RenderConfig(width=size, height=size, samples_per_pass=4,
                              max_bounces=3, traversal="wide16", sky_mode=2,
                              integrator="fused", pool_size=1024,
                              has_lights=True, mask_stale_gathers=flag)
        film, _occ, rays, arr = fused_pass_with_stats(
            sd, config, params, np.uint32(0), pool_size=1024)
        films[flag] = (np.asarray(film), int(rays), int(arr))
    assert films[False][1:] == films[True][1:]
    np.testing.assert_array_equal(films[True][0], films[False][0])
    assert films[False][0].mean() > 0.005


def _normal_map_scene(bumpy: bool):
    """Quad with a normal map: flat (128,128,255) or a strong bump grid."""
    import numpy as np

    from unity_webgpu_pathtracer_tpu.models import primitives as prim
    from unity_webgpu_pathtracer_tpu.scene.material import MaterialDesc
    from unity_webgpu_pathtracer_tpu.scene.scene import Scene

    scene = Scene()
    h = w = 64
    nm = np.zeros((h, w, 3), np.uint8)
    nm[..., 0] = 128
    nm[..., 1] = 128
    nm[..., 2] = 255
    if bumpy:
        yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        sx = np.sin(xx / w * 8 * np.pi) * 0.8
        sy = np.sin(yy / h * 8 * np.pi) * 0.8
        z = np.sqrt(np.maximum(1.0 - sx**2 - sy**2, 0.05))
        nm[..., 0] = np.clip((sx * 0.5 + 0.5) * 255, 0, 255).astype(np.uint8)
        nm[..., 1] = np.clip((sy * 0.5 + 0.5) * 255, 0, 255).astype(np.uint8)
        nm[..., 2] = np.clip((z * 0.5 + 0.5) * 255, 0, 255).astype(np.uint8)
    tid = scene.add_texture(nm)
    m = scene.add_material(MaterialDesc(base_color=(0.8, 0.8, 0.8, 1.0),
                                        roughness=0.3, normal_texture=tid))
    q = prim.quad(size=(4, 4), material_index=m)
    scene.add_mesh(q)
    from unity_webgpu_pathtracer_tpu.models.benchmark import procedural_hdri
    scene.set_environment(procedural_hdri(64))
    cam = dict(eye=(0, 0.5, 3.0), target=(0, 0, 0), fov_y_deg=45.0)
    return scene, cam


def _render_nm(scene, cam, has_nm, integrator="fused"):
    import numpy as np

    from unity_webgpu_pathtracer_tpu.config import SKY_MODE_ENVIRONMENT, RenderConfig
    from unity_webgpu_pathtracer_tpu.render.camera import make_camera_params
    from unity_webgpu_pathtracer_tpu.api import Renderer

    size = 40
    config = RenderConfig(
        width=size, height=size, samples_per_pass=8, max_bounces=2,
        traversal="wide16" if integrator == "fused" else "bruteforce",
        sky_mode=SKY_MODE_ENVIRONMENT, has_environment_texture=True,
        has_textures=True, has_normal_maps=has_nm, integrator=integrator,
        pool_size=1024,
    )
    params = make_camera_params(width=size, height=size, **cam,
                                environment_intensity=np.float32(1.0))
    r = Renderer(scene, config, params)
    r.render(1)
    return np.asarray(r.radiance())


@pytest.mark.parametrize("integrator", ["fused", "megakernel"])
def test_normal_map_flat_is_identity(integrator):
    """A flat (0.5, 0.5, 1) normal map must not change the image (the TBN
    reconstruction reduces to the interpolated normal)."""
    scene, cam = _normal_map_scene(bumpy=False)
    img_off = _render_nm(scene, cam, has_nm=False, integrator=integrator)
    img_on = _render_nm(scene, cam, has_nm=True, integrator=integrator)
    assert np.isfinite(img_on).all()
    assert abs(img_on.mean() - img_off.mean()) / max(img_off.mean(), 1e-6) < 0.01, (
        img_on.mean(), img_off.mean())


@pytest.mark.parametrize("integrator", ["fused", "megakernel"])
def test_normal_map_bump_changes_shading(integrator):
    """A strong bump grid must visibly modulate the shading (the reference
    ships this path disabled — exceeding parity here)."""
    scene, cam = _normal_map_scene(bumpy=True)
    img_off = _render_nm(scene, cam, has_nm=False, integrator=integrator)
    img_on = _render_nm(scene, cam, has_nm=True, integrator=integrator)
    assert np.isfinite(img_on).all()
    d = np.abs(img_on - img_off).mean()
    assert d > 0.005, f"normal map changed nothing (mean delta {d})"
    # Bumps modulate spatially: the on-image must have more variation.
    assert img_on.std() > img_off.std() * 0.9


def _nan_material_scene():
    # NaN roughness propagates through GGX D into the sampled f/pdf —
    # the masked-lobe sampler eats a NaN *base_color* (every lobe CDF
    # comparison is False -> f=0, pdf=0, silent drop), so roughness is
    # the fixture that reproduces the reference's NaN-f condition
    # (pathtrace.hlsl:100).
    scene, cam, overrides = __import__(
        "unity_webgpu_pathtracer_tpu.models.examples",
        fromlist=["quad_scene"]).quad_scene()
    scene.materials[0].roughness = float("nan")
    return scene, cam, overrides


@pytest.mark.parametrize("integrator", ["megakernel", "fused"])
def test_nan_canary_paints_green(integrator):
    """debug_nan_canary replicates pathtrace.hlsl:100-104: a NaN BSDF
    sample paints the sample pure green; off, the sample is dropped."""
    img = _render(_nan_material_scene, size=32, spp=4,
                  integrator=integrator, debug_nan_canary=True)
    # Center pixels hit the NaN-material quad: every sample is the canary.
    center = img[14:18, 14:18]
    assert np.allclose(center, [0.0, 1.0, 0.0], atol=1e-6), center.mean(axis=(0, 1))
    # Canary off: the NaN sample is dropped silently (finite, not green).
    img_off = _render(_nan_material_scene, size=32, spp=4,
                      integrator=integrator, debug_nan_canary=False)
    assert np.isfinite(img_off).all()
    assert img_off[14:18, 14:18, 1].mean() < 0.5


@pytest.fixture(scope="module")
def bench_scene_small():
    from unity_webgpu_pathtracer_tpu.models.benchmark import million_triangle_scene

    scene, cam = million_triangle_scene(2000)
    return scene.build("wide16"), make_camera_params(width=40, height=24,
                                                     **cam)


def _bench_like_film(bench_scene_small, **overrides):
    import jax

    from unity_webgpu_pathtracer_tpu.config import SKY_MODE_ENVIRONMENT
    from unity_webgpu_pathtracer_tpu.render.fused import fused_pass_with_stats

    sd, params = bench_scene_small
    kw = dict(width=40, height=24, samples_per_pass=4, max_bounces=5,
              traversal="wide16", sky_mode=SKY_MODE_ENVIRONMENT,
              has_environment_texture=True, integrator="fused",
              pool_size=1024, transition_every=4, attr_compact=2)
    kw.update(overrides)
    step = jax.jit(fused_pass_with_stats, static_argnums=(1,))
    film, occ, rays, arr = step(sd, RenderConfig(**kw), params, 0)
    return np.asarray(film), (int(rays), int(arr), float(occ))


@pytest.mark.smoke
def test_mask_stale_gathers_film_identical(bench_scene_small):
    """mask_stale_gathers clamps the attr/env gather index to row 0 for
    lanes that cannot consume the result this transition.  Every consumer
    of the gathered rows is masked by shade/env_done/light_done, so the
    film and every counter must be EXACTLY identical — this is the
    correctness contract the config flag documents."""
    off = _bench_like_film(bench_scene_small, mask_stale_gathers=False)
    on = _bench_like_film(bench_scene_small, mask_stale_gathers=True)
    assert on[1] == off[1]
    np.testing.assert_array_equal(on[0], off[0])


@pytest.mark.smoke
def test_env_split_rows_film_identical(bench_scene_small):
    """env_split_rows extracts the merged-env-row fields from the
    transposed gather result (contiguous (B,) slices) instead of strided
    [B, j] columns.  Per-element values and op order are identical, so
    the film and every counter must be EXACTLY identical."""
    off = _bench_like_film(bench_scene_small, env_split_rows=False)
    on = _bench_like_film(bench_scene_small, env_split_rows=True)
    assert on[1] == off[1]
    np.testing.assert_array_equal(on[0], off[0])
