"""wide16 (16-wide quantized stack) traversal: build invariants + equivalence.

Same statistical-equivalence methodology as test_wide8.py (f16 leaf
quantization shifts grazing hits), plus a fused-integrator film check
against the wide8 backend."""

import numpy as np
import jax.numpy as jnp
import pytest

from unity_webgpu_pathtracer_tpu.accel.wide16 import (
    build_scene_wide16,
    build_tlas_wide16,
    validate_wide16,
)
from unity_webgpu_pathtracer_tpu.ops import traverse_wide16 as tw16
from unity_webgpu_pathtracer_tpu.ops.intersect import closest_hit_bruteforce
from unity_webgpu_pathtracer_tpu.utils.math import FAR_PLANE

from tests.test_wide8 import random_rays, random_tris, recs_of


class FakeScene:
    def __init__(self, tris, quality=1):
        recs = recs_of(tris)
        self.w16 = build_scene_wide16(tris, recs, quality=quality)
        self.wide16_nodes = jnp.asarray(self.w16.nodes)
        # SBVH `order` is a reference list (duplicates allowed): rows of
        # `tris` are refs; `order` maps a row back to its original tri id.
        self.order = np.asarray(self.w16.order)
        self.tris = jnp.asarray(recs[self.w16.order])
        self.tri_index = jnp.arange(self.order.shape[0], dtype=jnp.int32)
        self.inst_w2l = jnp.zeros((0, 12), jnp.float32)


@pytest.mark.parametrize("n", [12, 300, 4000])
def test_wide16_build_valid(n):
    tris = random_tris(n, seed=n)
    w = build_scene_wide16(tris, recs_of(tris))
    validate_wide16(w, n)


def test_wide16_numpy_native_agree():
    """The C++ emitter and the numpy emitter produce the same table."""
    from unity_webgpu_pathtracer_tpu.accel.bvh2 import build_bvh2
    from unity_webgpu_pathtracer_tpu.accel.native import native_wide16_or_none
    from unity_webgpu_pathtracer_tpu.accel.wide16 import build_wide16

    tris = random_tris(600, seed=5)
    recs = recs_of(tris)
    native = native_wide16_or_none(tris, recs, 4)
    if native is None:
        pytest.skip("native library unavailable")
    rows_n, depth_n, order_n = native
    w = build_scene_wide16(tris, recs)
    # Both builders must emit VALID tables over the same geometry; byte
    # equality is not required (different SAH tie-breaks are legal).
    validate_wide16(w, 600)
    from unity_webgpu_pathtracer_tpu.accel.wide16 import Wide16

    validate_wide16(Wide16(nodes=rows_n, depth=depth_n, order=order_n), 600)


@pytest.mark.parametrize("n,thresh", [(12, 0.99), (300, 0.995), (4000, 0.995)])
def test_wide16_matches_bruteforce(n, thresh):
    tris = random_tris(n, seed=n + 7)
    scene = FakeScene(tris)
    o, d = random_rays(512, seed=n, tris=tris)
    t16, bary16, slot16, _ = tw16.closest_hit(scene, o, d)
    tb, baryb, slotb, _ = closest_hit_bruteforce(scene, o, d)
    hit16 = np.asarray(slot16) >= 0
    hitb = np.asarray(slotb) >= 0
    # Compare in ORIGINAL triangle-id space: under SBVH a triangle appears
    # as several refs, so equal row ids are too strict — the two traversals
    # may legitimately report different copies of the same triangle.
    id16 = scene.order[np.maximum(np.asarray(slot16), 0)]
    idb = scene.order[np.maximum(np.asarray(slotb), 0)]
    same = (hit16 == hitb) & (~hitb | (id16 == idb))
    assert same.mean() >= thresh, f"only {same.mean():.4f} agree"
    both = hit16 & hitb & same
    assert both.any(), "ray set never hits the scene"
    terr = np.abs(np.asarray(t16)[both] - np.asarray(tb)[both])
    rel = terr / np.maximum(np.asarray(tb)[both], 1e-3)
    assert np.quantile(rel, 0.99) < 5e-3


def test_wide16_occluded_matches():
    tris = random_tris(800, seed=3)
    scene = FakeScene(tris)
    o, d = random_rays(512, seed=4, tris=tris)
    tb, _, slotb, _ = closest_hit_bruteforce(scene, o, d)
    occ = np.asarray(tw16.occluded(scene, o, d, jnp.float32(FAR_PLANE)))
    hitb = np.asarray(slotb) >= 0
    assert (occ == hitb).mean() >= 0.995


def test_wide16_tlas_instancing():
    """Two instances of one mesh, one transformed — vs brute force over the
    world-space union (mirrors test_wide8_tlas_instancing)."""
    base = random_tris(200, seed=9, spread=1.0, size=0.3)
    recs = recs_of(base)
    w16 = build_scene_wide16(base, recs)
    p = base.reshape(-1, 3)
    bounds = (p.min(0), p.max(0))

    t1 = np.eye(4, dtype=np.float32)
    t2 = np.eye(4, dtype=np.float32)
    t2[:3, 3] = (3.0, 0.5, -1.0)
    t2[0, 0] = 2.0  # non-uniform scale exercises the unnormalized-dir trick
    nodes, l2w, w2l, _layout = build_tlas_wide16(
        [w16], [bounds], [(0, t1, None), (0, t2, None)], [0])

    class S:
        wide16_nodes = jnp.asarray(nodes.nodes)
        inst_w2l = jnp.asarray(w2l)

    base_p = base[w16.order]
    world2 = base_p @ t2[:3, :3].T + t2[:3, 3]
    all_tris = np.concatenate([base_p, world2.astype(np.float32)])

    class SB:
        tris = jnp.asarray(recs_of(all_tris))
        tri_index = jnp.arange(all_tris.shape[0], dtype=jnp.int32)

    o, d = random_rays(512, seed=11, spread=4.0, tris=all_tris)
    t16, _, slot16, inst16 = tw16.closest_hit(S, o, d)
    tb, _, slotb, _ = closest_hit_bruteforce(SB, o, d)
    hit16 = np.asarray(slot16) >= 0
    hitb = np.asarray(slotb) >= 0
    assert (hit16 == hitb).mean() >= 0.99
    both = hit16 & hitb
    # Compare original tri ids: SBVH refs may duplicate a triangle, and the
    # brute-force union carries one row per ref per instance.
    order = np.asarray(w16.order)
    nref = order.shape[0]
    id16 = order[np.asarray(slot16)[both]]
    idb = order[np.asarray(slotb)[both] % nref]
    assert (id16 == idb).mean() >= 0.99
    rel = np.abs(np.asarray(t16)[both] - np.asarray(tb)[both]) / np.maximum(
        np.asarray(tb)[both], 1e-3)
    assert np.quantile(rel, 0.98) < 5e-3
    assert set(np.unique(np.asarray(inst16)[both])) <= {0, 1}


def test_wide16_fused_film_matches_wide8():
    """The production fused integrator converges to the same image on
    wide16 as on wide8.  The comparison is statistical, not bitwise: the
    per-lane RNG advances once per *transition* and transition timing
    depends on tree shape, so the two backends draw different (equally
    valid) sample sequences — at 16 spp the cornell means agree to well
    under 2%."""
    from unity_webgpu_pathtracer_tpu.config import RenderConfig
    from unity_webgpu_pathtracer_tpu.models.cornell import cornell_box
    from unity_webgpu_pathtracer_tpu.render.camera import make_camera_params
    from unity_webgpu_pathtracer_tpu.render.fused import fused_pass_with_stats

    size = 64
    scene, cam = cornell_box()
    params = make_camera_params(width=size, height=size, **cam)
    films = {}
    for trav in ("wide8", "wide16"):
        config = RenderConfig(
            width=size, height=size, samples_per_pass=16, max_bounces=3,
            traversal=trav, sky_mode=2, integrator="fused", pool_size=4096,
        )
        sd = scene.build(trav)
        film, occ, rays, _ = fused_pass_with_stats(
            sd, config, params, np.uint32(0), pool_size=4096)
        films[trav] = np.asarray(film).reshape(size, size, 3) / 16.0
        assert np.isfinite(films[trav]).all()
    a, b = films["wide8"], films["wide16"]
    assert abs(a.mean() - b.mean()) / max(a.mean(), 1e-6) < 0.02
    # Pixelwise: most pixels agree within MC noise at 16 spp.
    close = np.isclose(a, b, rtol=0.25, atol=0.05).all(axis=-1)
    assert close.mean() > 0.90, f"only {close.mean():.3f} pixels match"


def test_wide16_prestep_hits_bitwise_equal():
    """The gather-free root prestep must not change traversal RESULTS:
    closest hits after (prestep + arrivals) are bitwise identical to pure
    arrivals — it replays arrival_step16's inner-node arithmetic on the
    same values, only sourced from broadcast constants / the slot table.
    (The fused FILM is not bitwise comparable: finishing segments in fewer
    cadence periods shifts the per-lane RNG pairing — same estimator,
    different equally-valid sample sequence; see the statistical check
    below.)"""
    import jax

    from unity_webgpu_pathtracer_tpu.accel.wide16 import derive_top16
    from unity_webgpu_pathtracer_tpu.utils.math import safe_rcp

    tris = random_tris(3000, seed=11)
    sc = FakeScene(tris)
    top = derive_top16(sc.w16.nodes)
    assert top is not None
    o, d = random_rays(4096, seed=7)
    o, d = jnp.asarray(o), jnp.asarray(d)
    inv = safe_rcp(d)

    base = tw16.closest_hit(sc, o, d)

    s0 = tw16.init_state16(4096, jnp.float32(FAR_PLANE))
    s0 = tw16.prestep16(sc.wide16_nodes, jnp.asarray(top), o, d, inv, s0,
                        jnp.ones(4096, bool))

    def cond(s):
        return jnp.any(s.ptr >= 0)

    def body(s):
        return tw16.arrival_step16(sc.wide16_nodes, o, d, inv, s, None,
                                   has_instances=False)

    sf = jax.lax.while_loop(cond, body, s0)
    for a, b, name in ((base[0], sf.t, "t"), (base[2], sf.tri, "tri")):
        assert np.array_equal(np.asarray(a), np.asarray(b)), name


def test_wide16_prestep_film_statistical():
    """Fused film with prestep on vs off: same estimator, shifted RNG
    pairing -> means agree within MC noise."""
    from unity_webgpu_pathtracer_tpu.config import RenderConfig
    from unity_webgpu_pathtracer_tpu.models.cornell import cornell_box
    from unity_webgpu_pathtracer_tpu.render.camera import make_camera_params
    from unity_webgpu_pathtracer_tpu.render.fused import fused_pass_with_stats

    size = 48
    scene, cam = cornell_box()
    params = make_camera_params(width=size, height=size, **cam)
    sd = scene.build("wide16")
    assert sd.wide16_top.shape[0] == 16
    films = {}
    for pre in (True, False):
        config = RenderConfig(
            width=size, height=size, samples_per_pass=16, max_bounces=3,
            traversal="wide16", sky_mode=2, integrator="fused",
            pool_size=2048, use_prestep=pre,
        )
        film, _occ, _rays, _arr = fused_pass_with_stats(
            sd, config, params, np.uint32(0), pool_size=2048)
        films[pre] = np.asarray(film) / 16.0
        assert np.isfinite(films[pre]).all()
    a, b = films[True], films[False]
    assert abs(a.mean() - b.mean()) / max(a.mean(), 1e-6) < 0.03


def test_wide16_prestep_l3_hits_bitwise_equal():
    """Level-3 prestep (bit-exact 3-limb bf16 one-hot matmul gather over the
    256 grandchild slots) must also leave traversal results bitwise
    unchanged vs pure arrivals."""
    import jax

    from unity_webgpu_pathtracer_tpu.accel.wide16 import (
        derive_top16,
        derive_top3_limbs,
    )
    from unity_webgpu_pathtracer_tpu.utils.math import safe_rcp

    tris = random_tris(20000, seed=13)   # deep enough for 3 inner levels
    sc = FakeScene(tris)
    top = derive_top16(sc.w16.nodes)
    assert top is not None
    top3 = derive_top3_limbs(sc.w16.nodes, top)
    assert top3 is not None and top3.shape == (3, 256, 119)
    o, d = random_rays(4096, seed=17)
    o, d = jnp.asarray(o), jnp.asarray(d)
    inv = safe_rcp(d)

    base = tw16.closest_hit(sc, o, d)

    s0 = tw16.init_state16(4096, jnp.float32(FAR_PLANE))
    s0 = tw16.prestep16(sc.wide16_nodes, jnp.asarray(top), o, d, inv, s0,
                        jnp.ones(4096, bool), top3=jnp.asarray(top3))
    # The prestep must genuinely descend 3 levels for some lanes.
    assert int(np.asarray((s0.sp >= 2).sum())) > 0

    def cond(s):
        return jnp.any(s.ptr >= 0)

    def body(s):
        return tw16.arrival_step16(sc.wide16_nodes, o, d, inv, s, None,
                                   has_instances=False)

    sf = jax.lax.while_loop(cond, body, s0)
    for a, b, name in ((base[0], sf.t, "t"), (base[2], sf.tri, "tri")):
        assert np.array_equal(np.asarray(a), np.asarray(b)), name

def test_wide16_prestep_instanced_film():
    """Instanced (TLAS) scene with prestep ON: the placeholder top row
    (shape (1, 119)) statically skips prestep level 2, level 1 descends
    from the flattened table's real root row — films must match the
    prestep-off estimator within MC noise (the prestep x instancing cell
    of the traversal test matrix)."""
    from unity_webgpu_pathtracer_tpu.config import RenderConfig
    from unity_webgpu_pathtracer_tpu.models.examples import tlas_scene
    from unity_webgpu_pathtracer_tpu.render.camera import make_camera_params
    from unity_webgpu_pathtracer_tpu.render.fused import fused_pass_with_stats

    scene, cam, _extra = tlas_scene(n=4)
    size = 48
    params = make_camera_params(width=size, height=size, **cam)
    sd = scene.build("wide16")
    assert sd.wide16_top.shape[0] == 1  # placeholder -> level-2 skip path
    films = {}
    for pre in (False, True):
        config = RenderConfig(
            width=size, height=size, samples_per_pass=8, max_bounces=3,
            traversal="wide16", sky_mode=2, integrator="fused",
            pool_size=2048, use_prestep=pre,
        )
        film, _occ, _rays, _arr = fused_pass_with_stats(
            sd, config, params, np.uint32(0), pool_size=2048)
        films[pre] = np.asarray(film) / 8.0
        assert np.isfinite(films[pre]).all()
    base = films[False]
    assert abs(films[True].mean() - base.mean()) / max(base.mean(), 1e-6) \
        < 0.03, (films[True].mean(), base.mean())


def _beam_tris(n_beams, seed=11, extent=4.0):
    """Long thin quads (the SBVH ref-splitting stressor) as (2N,3,3)."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(-extent, extent, (n_beams, 3)).astype(np.float32)
    d = rng.normal(size=(n_beams, 3)).astype(np.float32)
    d /= np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-8)
    b = a + d * rng.uniform(0.5, extent, (n_beams, 1)).astype(np.float32)
    w = np.cross(b - a, rng.normal(size=(n_beams, 3)).astype(np.float32))
    w /= np.maximum(np.linalg.norm(w, axis=1, keepdims=True), 1e-8)
    w *= rng.uniform(0.004, 0.02, (n_beams, 1)).astype(np.float32)
    tris = np.concatenate([
        np.stack([a - w, a + w, b + w], axis=1),
        np.stack([a - w, b + w, b - w], axis=1),
    ], axis=0)
    return np.ascontiguousarray(tris, np.float32)


@pytest.mark.parametrize("quality", [0, 1])
def test_wide16_beams_matches_bruteforce(quality):
    """Long thin overlapping quads: SBVH duplicates references heavily
    here (the beams benchmark scene's geometry class); traversal must
    still agree with the oracle in original-triangle-id space."""
    tris = _beam_tris(400, seed=19)
    scene = FakeScene(tris, quality=quality)
    o, d = random_rays(512, seed=23, tris=tris)
    t16, _b16, slot16, _ = tw16.closest_hit(scene, o, d)
    tb, _bb, slotb, _ = closest_hit_bruteforce(scene, o, d)
    hit16 = np.asarray(slot16) >= 0
    hitb = np.asarray(slotb) >= 0
    id16 = scene.order[np.maximum(np.asarray(slot16), 0)]
    idb = scene.order[np.maximum(np.asarray(slotb), 0)]
    same = (hit16 == hitb) & (~hitb | (id16 == idb))
    # Thin grazing quads + f16 leaf quantization: slightly looser bar
    # than the fat-triangle fixtures, same methodology.
    assert same.mean() >= 0.99, f"only {same.mean():.4f} agree"
    both = hit16 & hitb & same
    assert both.any()
    rel = np.abs(np.asarray(t16)[both] - np.asarray(tb)[both]) / np.maximum(
        np.asarray(tb)[both], 1e-3)
    assert np.quantile(rel, 0.99) < 5e-3


def test_wide16_build_cache_roundtrip(tmp_path, monkeypatch):
    """The disk cache must return the build BIT-identically (rows hold
    packed integer fields in NaN space, so compare bits not floats), key
    on build options, and honor the disable knob."""
    from unity_webgpu_pathtracer_tpu.accel.wide16 import build_scene_wide16

    monkeypatch.setenv("UWPT_BVH_CACHE_DIR", str(tmp_path))
    monkeypatch.delenv("UWPT_BVH_CACHE", raising=False)
    tris = random_tris(300, seed=7)
    v0 = tris[:, 0]
    recs = np.concatenate([tris[:, 2] - v0, tris[:, 1] - v0, v0],
                          -1).astype(np.float32)
    a = build_scene_wide16(tris, recs)
    files0 = sorted(p.name for p in tmp_path.iterdir())
    assert len(files0) == 1 and files0[0].endswith(".npz")
    b = build_scene_wide16(tris, recs)  # warm: loaded from disk
    assert a.depth == b.depth
    assert (a.order == b.order).all()
    assert (a.nodes.view(np.uint32) == b.nodes.view(np.uint32)).all()
    # Different build options must MISS (new key), not collide.
    c = build_scene_wide16(tris, recs, quality=0)
    assert len(list(tmp_path.iterdir())) == 2
    assert c.nodes.shape[-1] == a.nodes.shape[-1]
    # Disabled: no new files even for a fresh geometry.
    monkeypatch.setenv("UWPT_BVH_CACHE", "0")
    tris2 = random_tris(123, seed=8)
    v0 = tris2[:, 0]
    recs2 = np.concatenate([tris2[:, 2] - v0, tris2[:, 1] - v0, v0],
                           -1).astype(np.float32)
    build_scene_wide16(tris2, recs2)
    assert len(list(tmp_path.iterdir())) == 2
