"""Shared machinery for the golden-image regression fixtures.

The reference's only regression net is its 15 example scenes rendered by
hand (SURVEY.md §4 — `Assets/Examples/Scenes/` ARE its manual golden
fixtures).  Here each builtin example scene gets a COMMITTED golden:
the per-pixel mean over K independent fixed-seed passes plus the
per-pixel std of those pass means, rendered with the production fused
config on CPU.  The regression test renders fresh passes under disjoint
seeds and z-tests them against the stored mean/std — energy-preserving
radiometric bugs (a flipped MIS weight, a wrong lobe pdf) shift means by
many sigma in the affected regions, while Monte-Carlo noise and harmless
reorderings (FMA, association) stay inside.

Regenerate after INTENDED radiometric changes with::

    python -m tests.golden_gen            # all scenes
    python -m tests.golden_gen cornell    # one scene

Generation cross-checks the fused mean against the independent
megakernel integrator (different RNG pairing, different traversal code)
so a fused-path bug cannot silently bake itself into the fixtures.
"""

from __future__ import annotations

import os

import numpy as np

# Importing this module leaves the backend alone: pytest (tests/conftest.py)
# and golden_gen pin the CPU, and chip_smoke.py renders the same scenes on
# the GPU.

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
SIZE = 64
SPP = 32          # samples per pass
K_PASSES = 8      # independent passes in the stored fixture
# Seed roots are WIDELY SPACED, not consecutive: the reference's seed
# formula `pixel*(sample+1)+root` (PathTracer.compute:60) makes nearby
# roots share RNG states across (pixel, sample) pairs, so consecutive
# roots produce correlated passes whose common deviation does not
# average out (measured: 8 consecutive-root cornell passes landed 1.6%
# below 8 spaced-root passes, ~8 sigma of a truly-independent mean).
SEED_STRIDE = 1000003
GEN_SEED_BASE = 1000   # fixture seed family
VAL_SEED_BASE = 4000   # held-out seeds for gate calibration at gen time
TEST_SEED_BASE = 7000  # disjoint seed family used by the regression test
N_TEST_PASSES = 2


def seed_roots(base, n):
    return [base + i * SEED_STRIDE for i in range(n)]

# All builtin example scenes (models/examples.py EXAMPLES).
SCENES = ["cornell", "quad", "texture", "lights", "rect_lights",
          "aperture", "brdf", "tlas", "sponza_like"]


def build_scene(name):
    """(scene_data, config, params, npix) for a golden render of `name`."""
    from unity_webgpu_pathtracer_tpu.config import RenderConfig
    from unity_webgpu_pathtracer_tpu.models.examples import EXAMPLES
    from unity_webgpu_pathtracer_tpu.render.camera import make_camera_params

    scene, cam, overrides = EXAMPLES[name]()
    overrides = dict(overrides)
    overrides.pop("traversal", None)
    overrides.setdefault("has_lights", bool(scene.lights))
    overrides.setdefault("has_textures", bool(scene.textures))
    # The firefly clamp is ON for golden renders: glossy paths to small
    # bright emitters make some pixels heavy-tailed (rect_lights measured
    # per-pass means of [1.33, 0.36, 0.44, 0.06, 0.06, 0.07] at ONE pixel
    # across seeds — the z-test's normality assumption fails there, and
    # two unbiased integrators legitimately "disagree" by 5x on any
    # finite sample).  Clamping (a product feature, PathTracer.cs:31 /
    # pathtrace.hlsl:79-84, applied identically by both integrators)
    # light-tails the estimator so per-pixel statistics are valid;
    # radiometric bugs still shift clamped means.
    config = RenderConfig(
        width=SIZE, height=SIZE, samples_per_pass=SPP, max_bounces=4,
        traversal="wide16", integrator="fused", pool_size=4096,
        use_firefly_filter=True,
        **overrides,
    )
    scene_data = scene.build(config.traversal)
    # Clamp at luminance 2: the fixture is a regression STATISTIC, not a
    # beauty render.  rect_lights pixels whose mean is carried by
    # p~0.003 events of radiance 25-45 have ~100% relative sem at any
    # affordable pass count — no per-pixel test works on the unclamped
    # estimator (measured: two unbiased integrators "disagreeing" 5x).
    # A hard clamp applied identically by both integrators and both test
    # arms light-tails every pixel; radiometric bugs still shift the
    # clamped means (only bugs confined to >2-luminance paths escape,
    # and the furnace/property tests cover energy).
    params = make_camera_params(width=SIZE, height=SIZE, **cam,
                                max_firefly_luminance=np.float32(2.0))
    return scene_data, config, params


def render_pass_means(name, seed_roots, config_overrides=None) -> np.ndarray:
    """(len(seed_roots), SIZE, SIZE, 3) independent per-pass mean images.

    ``config_overrides``: dataclasses.replace kwargs on the golden
    config."""
    import dataclasses

    import jax

    from unity_webgpu_pathtracer_tpu.render.fused import fused_pass_with_stats

    scene_data, config, params = build_scene(name)
    if config_overrides:
        config = dataclasses.replace(config, **config_overrides)
    step = jax.jit(fused_pass_with_stats, static_argnums=(1,),
                   static_argnames=("pool_size",))
    out = []
    for s in seed_roots:
        p = dataclasses.replace(params, seed_root=np.uint32(s))
        film, _occ, _rays, _arr = step(scene_data, config, p, 0,
                                       pool_size=config.pool_size)
        out.append(np.asarray(film).reshape(SIZE, SIZE, 3) / SPP)
    return np.stack(out)


def megakernel_mean(name, seed_roots) -> np.ndarray:
    """Cross-check estimator: independent integrator + traversal code."""
    import dataclasses

    import jax

    from unity_webgpu_pathtracer_tpu.render.integrator import render_pass

    scene_data, config, params = build_scene(name)
    config = dataclasses.replace(config, integrator="megakernel")
    step = jax.jit(render_pass, static_argnums=(1,))
    acc = None
    for s in seed_roots:
        p = dataclasses.replace(params, seed_root=np.uint32(s))
        film = np.asarray(step(scene_data, config, p, 0))
        acc = film if acc is None else acc + film
    return (acc / (len(seed_roots) * SPP)).reshape(SIZE, SIZE, 3)


def golden_path(name):
    return os.path.join(GOLDEN_DIR, f"{name}.npz")


def load_golden(name):
    d = np.load(golden_path(name))
    g = dict(mean=d["mean"], std=d["std"], lmean=d["lmean"],
             lstd=d["lstd"], spp=int(d["spp"]), k=int(d["k"]))
    # Calibration fields (fixtures regenerated with them; defaults keep
    # old fixtures loadable mid-regeneration).
    g["gmeans"] = d["gmeans"] if "gmeans" in d else None
    g["noise_bad"] = float(d["noise_bad"]) if "noise_bad" in d else 0.0
    return g


def dual_flags(passes_new: np.ndarray, g: dict,
               z_thresh: float = 6.0):
    """Per-pixel flags combining a RAW-mean z-test with a LOG1P-domain one.

    A pixel counts as drifted only when BOTH tests flag it:

    * the raw test is sensitive on stable pixels (deterministic walls,
      direct emission) where sem is tiny and a 1-2% shift is many sigma;
    * the log test compresses fireflies — on heavy-tailed pixels (glossy
      paths to an emission-12 panel; rect_lights measured mk passes of
      [1.33, 0.36, 0.44, 0.06, 0.06, 0.07] at ONE pixel between two
      unbiased estimators) a rare bright event explodes the raw z but
      moves log1p by a bounded amount absorbed by the stored log-domain
      std.

    A real radiometric bug (flipped MIS weight, wrong pdf) shifts the
    DISTRIBUTION, so both tests fire together.
    """
    n_new = passes_new.shape[0]
    k = g["k"]
    mean_new = passes_new.mean(axis=0)
    lmean_new = np.log1p(np.maximum(passes_new, 0.0)).mean(axis=0)

    floor = np.maximum(g["std"], np.percentile(g["std"], 25))
    sem = floor * np.sqrt(1.0 / k + 1.0 / n_new)
    bad_raw = np.abs(mean_new - g["mean"]) > z_thresh * sem + 2e-3

    lfloor = np.maximum(g["lstd"], np.percentile(g["lstd"], 25))
    lsem = lfloor * np.sqrt(1.0 / k + 1.0 / n_new)
    bad_log = np.abs(lmean_new - g["lmean"]) > z_thresh * lsem + 5e-3

    return bad_raw & bad_log, mean_new


def compare_to_golden(passes_new: np.ndarray, name: str,
                      z_thresh: float = 6.0):
    """Statistical regression check of fresh passes against the fixture.

    ``passes_new``: (n, H, W, 3) independent per-pass mean images.
    Two arms, each calibrated per scene from fixture-time measurements:

    * per-pixel: dual raw+log z-test flag fraction, gated against
      ``noise_bad`` — the flag fraction measured at generation time on
      HELD-OUT clean passes (heavy-tailed scenes like rect_lights flag
      ~2% of pixels between two clean unbiased runs; smooth env scenes
      flag ~0.01%, keeping them maximally sensitive);
    * global mean: a z-test using the stored per-pass global means
      (``gmeans``) — the seed formula correlates pixels within a pass,
      so the global mean's real sem is ~1% at these sample counts, far
      above the naive independent-pixel estimate.  A 1.2% relative
      floor keeps the gate meaningful when the measured spread is tiny.

    Measured detection (flipped env-MIS weight, the target bug class):
    brdf mean_shift 4.9% vs noise 0.04%; sponza_like 25% vs 0.4% —
    both many multiples of their calibrated gates.
    """
    g = load_golden(name)
    n = passes_new.shape[0]
    bad, mean_new = dual_flags(passes_new, g, z_thresh)
    bad_fraction = float(bad.mean())
    frac_limit = max(0.005, 3.0 * g["noise_bad"] + 0.005)

    denom = max(float(np.abs(g["mean"]).mean()), 1e-6)
    mean_shift_rel = float(np.abs(mean_new.mean() - g["mean"].mean())) / denom
    if g["gmeans"] is not None and len(g["gmeans"]) >= 3:
        gm = np.asarray(g["gmeans"], np.float64)
        s_rel = float(gm.std(ddof=1)) / max(float(gm.mean()), 1e-9)
        sem = s_rel * np.sqrt(1.0 / len(gm) + 1.0 / n)
        mean_gate = max(0.012, 4.0 * sem)
    else:
        mean_gate = 0.012
    ok = bad_fraction <= frac_limit and mean_shift_rel < mean_gate
    return ok, dict(bad_fraction=bad_fraction, frac_limit=frac_limit,
                    mean_shift_rel=mean_shift_rel, mean_gate=mean_gate)
