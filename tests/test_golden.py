"""Golden-image statistical regression tests (SURVEY.md §4).

Each builtin example scene has a committed fixture (tests/golden/*.npz:
per-pixel mean/std of 8 fixed-seed production-config passes in the raw
and log1p domains, plus per-pass global means and a held-out clean-run
flag-rate for gate calibration).  The test renders fresh passes under a
disjoint seed family and applies two calibrated arms
(golden_common.compare_to_golden): a per-pixel dual raw+log z-test and
a global-mean z-test.  The meta-tests below prove the detector catches
the target bug class — a deliberately flipped MIS power heuristic is
rendered end-to-end and must fail — while clean fresh seeds pass.

Regenerate after INTENDED radiometric changes:
``python -m tests.golden_gen``.
"""

from __future__ import annotations

import os

import numpy as np
import pytest

from tests.golden_common import (
    N_TEST_PASSES,
    SCENES,
    TEST_SEED_BASE,
    compare_to_golden,
    golden_path,
    load_golden,
    render_pass_means,
    seed_roots,
)


@pytest.mark.parametrize("name", SCENES)
def test_golden_regression(name):
    if not os.path.exists(golden_path(name)):
        # Fixtures are generated per-scene (~2 min each on CPU incl. the
        # megakernel cross-check); a partially-populated tests/golden/
        # directory means generation is still in flight — skip, don't
        # fail, so the rest of the suite's signal stays clean.
        pytest.skip(f"golden fixture for {name} not generated yet; run "
                    "python -m tests.golden_gen")
    passes = render_pass_means(name, seed_roots(TEST_SEED_BASE,
                                                N_TEST_PASSES))
    ok, stats = compare_to_golden(passes, name)
    assert ok, (f"{name} drifted from golden: {stats} — if the change is "
                "an intended radiometric fix, regenerate with "
                "python -m tests.golden_gen")


def _perturbed_passes(g, scale_img):
    """Synthesize two 'passes' at the golden mean times a perturbation —
    zero internal variance, so any real shift must be caught."""
    m = g["mean"] * scale_img
    return np.stack([m, m])


def test_golden_detector_catches_global_gain():
    """Meta-test: a 5% uniform gain (wrong normalization constant scale)
    must FAIL on the env-lit scenes, whose calibrated mean gates are
    tight (smooth env lighting -> sub-0.5% per-pass global-mean spread),
    while the fixture's own mean passes."""
    for name in ("brdf", "sponza_like"):
        g = load_golden(name)
        ok_self, stats_s = compare_to_golden(_perturbed_passes(g, 1.0), name)
        assert ok_self, f"{name} fixture fails against itself: {stats_s}"
        ok_gain, stats_g = compare_to_golden(_perturbed_passes(g, 1.05), name)
        assert not ok_gain, f"{name}: 5% global gain not detected: {stats_g}"


def test_golden_detector_catches_flipped_mis():
    """Meta-test for the target bug class: flip the
    MIS power heuristic (a^2/(a^2+b^2) -> b^2/(a^2+b^2)) in the live
    integrator and render fresh passes end-to-end — the suite must fail.

    Measured effect at this config: brdf mean_shift 4.9% (noise 0.04%),
    sponza_like 25% (noise 0.4%).  brdf alone is asserted here to bound
    test wall-time; the patch is applied to the modules that call
    power_heuristic by name and the jit caches are cleared (tracing is
    cached globally on function identity, so a monkeypatch without
    clear_caches() silently re-runs the old executable).
    """
    import jax
    import jax.numpy as jnp

    import unity_webgpu_pathtracer_tpu.render.fused as fused
    import unity_webgpu_pathtracer_tpu.render.lights as lights

    def flipped_ph(a, b):
        a2, b2 = a * a, b * b
        d = a2 + b2
        return jnp.where(d > 0, b2 / jnp.where(d > 0, d, 1.0), 0.0)

    orig = fused.power_heuristic
    fused.power_heuristic = flipped_ph
    lights.power_heuristic = flipped_ph
    jax.clear_caches()
    try:
        passes = render_pass_means("brdf", seed_roots(TEST_SEED_BASE,
                                                      N_TEST_PASSES))
        ok, stats = compare_to_golden(passes, "brdf")
    finally:
        fused.power_heuristic = orig
        lights.power_heuristic = orig
        jax.clear_caches()
    assert not ok, f"flipped MIS weight not detected on brdf: {stats}"


def test_golden_detector_catches_localized_spot_cone_bug():
    """Meta-test for the LOCALIZED bug class: a
    broken spot-cone fade confined to one light's footprint must still
    trip the "lights" scene gate.  Two severities, both rendered live:

    * hard-edge cone (penumbra annulus removed — the subtle, localized
      variant): measured bad_fraction 1.95% vs frac_limit 1.09% AND
      mean_shift 8.9% vs gate 1.2% — both arms fire;
    * cone ignored entirely (spot floods the hemisphere): bad_fraction
      26%, mean_shift 74%.

    The clean fresh-seed run passes (bad_fraction 0.07%, shift 0.1%) —
    asserted by test_golden_regression[lights].
    """
    import jax
    import jax.numpy as jnp

    import unity_webgpu_pathtracer_tpu.render.fused as fused
    import unity_webgpu_pathtracer_tpu.render.lights as lights

    def hard_edge(cos_theta, cos_outer, cos_inner):
        return (cos_theta > cos_outer).astype(jnp.float32)

    orig = fused.spot_cone_fade
    fused.spot_cone_fade = hard_edge
    lights.spot_cone_fade = hard_edge
    jax.clear_caches()
    try:
        passes = render_pass_means("lights", seed_roots(TEST_SEED_BASE,
                                                        N_TEST_PASSES))
        ok, stats = compare_to_golden(passes, "lights")
    finally:
        fused.spot_cone_fade = orig
        lights.spot_cone_fade = orig
        jax.clear_caches()
    assert not ok, f"hard-edged spot cone not detected on lights: {stats}"
