"""Integration tests against the REFERENCE'S OWN content.

The reference ships its example assets at
``/root/reference/Assets/Examples/Models`` (SURVEY.md L5).  Synthetic
fixtures (tests/test_loaders.py) can hide loader bugs that real exports
expose — 3ds-Max MTLs with backslash paths and case-mismatched texture
dirs, glTF-PBR with the full 5-texture JPEG set, fan-triangulated
polygons.  These tests run the loaders and the PRODUCTION render config
on the real files.

Asset availability on this image: ``DamagedHelmet.glb`` is a real binary
(3.7 MB GLB, 5 JPEG textures); every ``.obj`` (sponza, bunny, teapot,
buddha, sportsCar, hyperion set) and the Sponza ``Textures/*.png`` are
git-LFS pointer stubs (~131-byte text files starting "version https://
git-lfs..."), so their geometry/texels are NOT fetchable here (zero
egress).  The MTL files are real text, so the multi-material Sponza
material pipeline is still exercised end-to-end; the OBJ-geometry tests
auto-upgrade to full render tests if real files are ever mounted.
"""

from __future__ import annotations

import os

import numpy as np
import pytest

import tests.conftest  # noqa: F401  (forces the CPU backend)

REF_MODELS = "/root/reference/Assets/Examples/Models"
HELMET = os.path.join(REF_MODELS, "DamagedHelmet.glb")
SPONZA_OBJ = os.path.join(REF_MODELS, "Sponza", "sponza.obj")
SPONZA_MTL = os.path.join(REF_MODELS, "Sponza", "sponza.mtl")


def _is_lfs_stub(path: str) -> bool:
    if not os.path.exists(path) or os.path.getsize(path) > 4096:
        return False
    with open(path, "rb") as f:
        return f.read(7) == b"version"


def _render_production(scene, size=48, spp=2, bounces=3):
    """Render with the production config (fused + wide16 + prestep +
    record film)."""
    import jax

    from unity_webgpu_pathtracer_tpu.config import RenderConfig
    from unity_webgpu_pathtracer_tpu.models.benchmark import procedural_hdri
    from unity_webgpu_pathtracer_tpu.render.camera import make_camera_params
    from unity_webgpu_pathtracer_tpu.render.fused import fused_pass_with_stats

    if scene.env_image is None:
        scene.set_environment(procedural_hdri(32))
    cfg = RenderConfig(
        width=size, height=size, samples_per_pass=spp, max_bounces=bounces,
        traversal="wide16", integrator="fused", sky_mode=0,
        has_environment_texture=True,
        has_textures=bool(scene.textures),
        pool_size=2048,
    )
    sd = scene.build(cfg.traversal)
    lo, hi = scene.world_bounds()
    center = (lo + hi) / 2
    ext = float(np.linalg.norm(hi - lo)) or 1.0
    cam = make_camera_params(
        width=size, height=size,
        eye=tuple(center + np.array([0.45, 0.3, 0.85]) * ext),
        target=tuple(center), fov_y_deg=40.0)
    step = jax.jit(fused_pass_with_stats, static_argnums=(1,),
                   static_argnames=("pool_size",))
    film, occ, rays, _arr = step(sd, cfg, cam, 0, pool_size=2048)
    img = np.asarray(film).reshape(size, size, 3) / spp
    return img, float(occ), int(rays)


# ---------------------------------------------------------------------------
# DamagedHelmet.glb — the reference's flagship glTF scene (Helmet.unity)
# ---------------------------------------------------------------------------

needs_helmet = pytest.mark.skipif(
    not os.path.exists(HELMET) or _is_lfs_stub(HELMET),
    reason="DamagedHelmet.glb not present")


@needs_helmet
def test_damaged_helmet_loads_full_pbr_set():
    from unity_webgpu_pathtracer_tpu.scene.gltf import load_gltf

    scene = load_gltf(HELMET)
    assert len(scene.meshes) == 1
    mesh, _xf = scene.meshes[0]
    assert mesh.triangle_count == 15452          # known asset facts
    assert mesh.uvs is not None and mesh.normals is not None
    # All five glTF-PBR textures decode (JPEG via Pillow) and bind.
    assert len(scene.textures) == 5
    for img in scene.textures:
        assert img.shape[:2] == (2048, 2048)
    m = scene.materials[0]
    assert m.base_color_texture >= 0
    assert m.metallic_roughness_texture >= 0
    assert m.emission_texture >= 0
    assert m.occlusion_texture >= 0
    assert m.normal_texture >= 0
    assert m.emission == (1.0, 1.0, 1.0)


@needs_helmet
def test_damaged_helmet_renders_production_config():
    from unity_webgpu_pathtracer_tpu.scene.gltf import load_gltf

    scene = load_gltf(HELMET)
    img, occ, rays = _render_production(scene, size=48, spp=2)
    assert np.isfinite(img).all()
    assert img.mean() > 0.01                     # not black
    assert rays > 48 * 48 * 2                    # bounces + shadow rays ran
    # The helmet must actually be hit: the center region's mean must
    # differ from the border's (sky-only) mean.
    c = img[16:32, 16:32].mean()
    border = np.concatenate([img[:4].ravel(), img[-4:].ravel()]).mean()
    assert abs(c - border) > 1e-3


@needs_helmet
def test_damaged_helmet_textures_affect_image():
    """Textured vs texture-stripped renders must differ (texture fetches
    are live in the production path, not silently dropped)."""
    from unity_webgpu_pathtracer_tpu.scene.gltf import load_gltf

    scene = load_gltf(HELMET)
    img_tex, _, _ = _render_production(scene, size=32, spp=2)
    stripped = load_gltf(HELMET)
    stripped.textures = []
    for m in stripped.materials:
        m.base_color_texture = -1
        m.metallic_roughness_texture = -1
        m.emission_texture = -1
        m.occlusion_texture = -1
        m.normal_texture = -1
    img_flat, _, _ = _render_production(stripped, size=32, spp=2)
    assert np.abs(img_tex - img_flat).max() > 0.01


# ---------------------------------------------------------------------------
# Sponza — real multi-material MTL (geometry is an LFS stub on this image)
# ---------------------------------------------------------------------------

needs_sponza_mtl = pytest.mark.skipif(
    not os.path.exists(SPONZA_MTL) or _is_lfs_stub(SPONZA_MTL),
    reason="sponza.mtl not present")


@needs_sponza_mtl
def test_sponza_mtl_parses_all_materials():
    from unity_webgpu_pathtracer_tpu.scene.obj import load_mtl

    maps: dict[str, dict[str, str]] = {}
    mats = load_mtl(SPONZA_MTL, maps=maps)
    assert len(mats) == 25                       # known asset fact
    # The alpha-masked foliage material carries both maps.
    assert maps["leaf"]["kd"] == "textures\\sponza_thorn_diff.png"
    assert maps["leaf"]["d"] == "textures\\sponza_thorn_mask.png"
    assert maps["leaf"]["bump"] == "textures\\sponza_thorn_bump.png"
    # Ni/Ns/Kd parsed on a representative material.
    assert mats["leaf"].ior == pytest.approx(1.5)
    assert 0.0 < mats["leaf"].roughness <= 1.0


@needs_sponza_mtl
def test_sponza_map_paths_resolve_case_insensitively():
    """3ds-Max wrote ``textures\\...``; the on-disk dir is ``Textures/``.
    resolve_map_path must bridge both the separator and the case."""
    from unity_webgpu_pathtracer_tpu.scene.obj import (
        _load_image_rgba,
        resolve_map_path,
    )

    base = os.path.dirname(SPONZA_MTL)
    p = resolve_map_path(base, "textures\\sponza_thorn_diff.png")
    assert p is not None and os.path.exists(p)
    assert os.path.basename(os.path.dirname(p)) == "Textures"
    # Missing file -> None, not an exception.
    assert resolve_map_path(base, "textures\\no_such_file.png") is None
    # The resolved file is an LFS stub on this image: the decoder must
    # degrade to None (factor fallback), never raise.
    if _is_lfs_stub(p):
        assert _load_image_rgba(p) is None


@pytest.mark.skipif(_is_lfs_stub(SPONZA_OBJ) or not os.path.exists(SPONZA_OBJ),
                    reason="sponza.obj is a git-LFS pointer stub on this "
                           "image (geometry not fetchable; MTL pipeline "
                           "covered by the tests above)")
def test_sponza_obj_full_render():
    """Auto-upgrades to a full multi-material render if the real OBJ is
    ever mounted."""
    from unity_webgpu_pathtracer_tpu.scene.obj import load_obj

    scene = load_obj(SPONZA_OBJ)
    assert len(scene.meshes) >= 20
    img, _occ, _rays = _render_production(scene, size=48, spp=1)
    assert np.isfinite(img).all() and img.mean() > 0.01


@pytest.mark.parametrize("name", ["bunny.obj", "teapot.obj", "buddha.obj"])
def test_reference_obj_meshes(name):
    path = os.path.join(REF_MODELS, name)
    if not os.path.exists(path) or _is_lfs_stub(path):
        pytest.skip(f"{name} is a git-LFS pointer stub on this image")
    from unity_webgpu_pathtracer_tpu.scene.obj import load_obj

    scene = load_obj(path)
    img, _occ, _rays = _render_production(scene, size=48, spp=1)
    assert np.isfinite(img).all() and img.mean() > 0.01


# ---------------------------------------------------------------------------
# The Sponza material pipeline end-to-end on a stand-in mesh: real MTL,
# real resolution rules, synthetic texels where LFS stubs block decode.
# ---------------------------------------------------------------------------

@needs_sponza_mtl
def test_obj_with_real_mtl_and_texture_merge(tmp_path):
    """A tiny OBJ referencing the REAL sponza.mtl semantics: a material
    with map_Kd + map_d gets the mask merged into baseColor.a and
    alpha_mode=MASK; LFS-stubbed texels fall back to factors silently."""
    from unity_webgpu_pathtracer_tpu.utils.image import write_png

    tex_dir = tmp_path / "textures"
    tex_dir.mkdir()
    rgb = np.zeros((8, 8, 3), np.uint8)
    rgb[:, :4] = (255, 0, 0)
    write_png(str(tex_dir / "diff.png"), rgb)
    mask = np.zeros((8, 8, 3), np.uint8)
    mask[4:] = 255
    write_png(str(tex_dir / "mask.png"), mask)
    (tmp_path / "m.mtl").write_text(
        "newmtl foliage\nKd 1 1 1\nNs 10\nNi 1.5\n"
        "map_Kd Textures\\diff.png\n"          # wrong-case dir on purpose
        "map_d Textures\\mask.png\n"
        "newmtl stub\nKd 0.2 0.4 0.6\nmap_Kd Textures\\missing.png\n")
    (tmp_path / "m.obj").write_text(
        "mtllib m.mtl\n"
        "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\n"
        "vt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\n"
        "vn 0 0 1\n"
        "usemtl foliage\nf 1/1/1 2/2/1 3/3/1\n"
        "usemtl stub\nf 1/1/1 3/3/1 4/4/1\n")
    from unity_webgpu_pathtracer_tpu.scene.obj import load_obj

    scene = load_obj(str(tmp_path / "m.obj"))
    assert len(scene.materials) == 2
    by_tex = {m.base_color_texture: m for m in scene.materials}
    foliage = next(m for m in scene.materials if m.base_color_texture >= 0)
    stub = next(m for m in scene.materials if m.base_color_texture < 0)
    assert foliage.alpha_mode == 2               # mask merged
    assert len(scene.textures) == 1
    atlas_img = scene.textures[foliage.base_color_texture]
    assert atlas_img.shape == (8, 8, 4)
    assert (atlas_img[:4, :, 3] == 0).all()      # mask rows -> alpha 0
    assert (atlas_img[4:, :, 3] == 255).all()
    assert stub.base_color[:3] == (0.2, 0.4, 0.6)  # factor fallback
    del by_tex
