"""Generate the committed golden-image fixtures (see golden_common.py).

Usage::

    python -m tests.golden_gen            # all scenes
    python -m tests.golden_gen cornell tlas

For every scene: renders K_PASSES independent fixed-seed passes with the
production fused config, cross-checks the mean against the megakernel
integrator (independent RNG pairing and traversal code — a fused-path
bug cannot silently become the fixture), and writes
``tests/golden/<name>.npz`` (mean, per-pass std, meta) plus a tonemapped
PNG preview for humans.
"""

from __future__ import annotations

import os
import sys

import numpy as np

import tests.conftest  # noqa: F401  (fixtures are rendered on the CPU)
from tests.golden_common import (
    GEN_SEED_BASE,
    GOLDEN_DIR,
    K_PASSES,
    SCENES,
    SIZE,
    SPP,
    golden_path,
    megakernel_mean,
    render_pass_means,
    seed_roots,
)


def generate(name: str) -> None:
    print(f"[golden] {name}: {K_PASSES} passes x {SPP} spp @ {SIZE}^2",
          flush=True)
    seeds = seed_roots(GEN_SEED_BASE, K_PASSES)
    passes = render_pass_means(name, seeds)
    mean = passes.mean(axis=0)
    std = passes.std(axis=0, ddof=1)
    lp = np.log1p(np.maximum(passes, 0.0))
    lmean = lp.mean(axis=0)
    lstd = lp.std(axis=0, ddof=1)
    # Per-pass global means: the test's mean-shift gate is a z-test
    # against this spread (pixels within a pass are RNG-correlated, so
    # the global mean's sem is ~1%, not mean(std)/sqrt(npix)).
    gmeans = passes.mean(axis=(1, 2, 3))

    os.makedirs(GOLDEN_DIR, exist_ok=True)
    np.savez_compressed(golden_path(name), mean=mean.astype(np.float32),
                        std=std.astype(np.float32),
                        lmean=lmean.astype(np.float32),
                        lstd=lstd.astype(np.float32), spp=SPP, k=K_PASSES,
                        gmeans=gmeans.astype(np.float64), noise_bad=0.0)

    # Held-out calibration: the per-pixel arm's false-positive rate on
    # CLEAN passes from an unseen seed family (heavy-tailed scenes flag
    # ~2% between clean unbiased runs; smooth scenes ~0.01%).  Stored as
    # `noise_bad`; the test gates at 3x this + 0.5% absolute.
    from tests.golden_common import (N_TEST_PASSES, VAL_SEED_BASE,
                                     compare_to_golden)

    val = render_pass_means(name, seed_roots(VAL_SEED_BASE, N_TEST_PASSES))
    _ok, val_stats = compare_to_golden(val, name)
    noise_bad = val_stats["bad_fraction"]
    d = dict(np.load(golden_path(name)))
    d["noise_bad"] = noise_bad
    np.savez_compressed(golden_path(name), **d)

    # Cross-integrator check (same dual raw+log statistic as the
    # regression test, golden_common.dual_flags): a fused-path bug cannot
    # silently become the fixture, while heavy-tailed pixels — unbiased
    # estimators whose rare fireflies land differently (rect_lights
    # measured megakernel passes of [1.33, 0.36, 0.44, 0.06, 0.06, 0.07]
    # at one pixel) — are absorbed by the log-domain arm.
    from tests.golden_common import dual_flags, load_golden

    mk_passes = np.stack([
        megakernel_mean(name, [GEN_SEED_BASE + 100 + i * 1000003])
        for i in range(4)
    ])
    bad, mk_mean = dual_flags(mk_passes, load_golden(name), z_thresh=8.0)
    bad_frac = float(bad.mean())
    shift = abs(float(mk_mean.mean() - mean.mean())) / max(float(mean.mean()), 1e-6)
    print(f"[golden] {name}: mean {mean.mean():.4f}, megakernel agreement "
          f"bad_frac={bad_frac:.4%} mean_shift={shift:.4%}", flush=True)
    # Heavy-tailed scenes (rect_lights: glossy paths to small emission-12
    # panels) flag ~1.4% of pixels between two UNBIASED estimators at
    # k=8/n=4 passes — tail noise, not a bug, when the global means agree
    # to <0.5%.  Gate: tight per-pixel OR (loose per-pixel AND tight mean).
    ok = (bad_frac < 0.01 or (bad_frac < 0.03 and shift < 0.005)) \
        and shift < 0.02
    assert ok, (
        f"{name}: fused and megakernel disagree (bad={bad_frac:.2%}, "
        f"shift={shift:.2%}) — fix the integrator before regenerating")

    from unity_webgpu_pathtracer_tpu.config import PostParams
    from unity_webgpu_pathtracer_tpu.post.tonemap import present
    from unity_webgpu_pathtracer_tpu.utils.image import write_png

    img = np.asarray(present(mean, PostParams(mode=1)))
    write_png(os.path.join(GOLDEN_DIR, f"{name}.png"),
              (np.clip(img, 0, 1) * 255).astype(np.uint8))


def main(argv):
    names = argv or SCENES
    for name in names:
        generate(name)
    print("[golden] done")


if __name__ == "__main__":
    main(sys.argv[1:])
