"""Equirectangular HDRI environment with luminance-CDF importance sampling.

The reference reads the env texture back to the CPU and builds a flat
inclusive prefix-sum of per-texel grayscale (``PathTracer.cs:299-307``); the
kernel binary-searches it row-then-column (``util/sky.hlsl:7-41``).  Here the
CDF is the same flat row-major prefix sum, but sampling uses a single
``jnp.searchsorted`` (XLA lowers it to a vectorized branchless binary
search), and the equirect mapping is made *self-consistent* between eval and
sample (the reference flips V between the two paths — an upstream quirk noted
in SURVEY.md — which would break MIS weights; we use the EvalEnvMap
convention ``v = 1 - θ/π`` everywhere).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from unity_webgpu_pathtracer_tpu.utils.math import INV_PI, INV_TWO_PI, PI, TWO_PI, luminance


class EnvMap(NamedTuple):
    """Device-resident environment data (pytree).

    ``alias_row`` and ``quad_rows`` are gather-merged tables: NEE env
    sampling bakes everything one sample needs into a single row (1
    gather instead of 6), and sky eval bakes the 2x2 bilinear footprint
    per texel (1 instead of 4)."""

    image: jnp.ndarray       # (H, W, 3) float32 linear radiance
    cdf: jnp.ndarray         # (H*W,) inclusive prefix sum of luminance
    cdf_sum: jnp.ndarray     # () total luminance
    alias_prob: jnp.ndarray  # (H*W,) alias-table acceptance probability
    alias_idx: jnp.ndarray   # (H*W,) int32 alias texel
    alias_row: jnp.ndarray   # (H*W, 8) [prob, alias_idx(bits), self rgb, alias rgb]
    quad_rows: jnp.ndarray   # (H*W, 12) 2x2 wrap footprint [p00|p10|p01|p11], or (1,12) if disabled
    merged_rows: jnp.ndarray # (H*W, 20) [alias_row | quad_rows]: ONE gather serves
                             # both the transition's disjoint env consumers (miss
                             # lanes read the quad half, NEE lanes the alias half)


def _build_alias(weights: np.ndarray):
    """Vose alias table: O(1) categorical sampling (2 gathers on device,
    replacing the CDF binary search's ~15 dependent gathers)."""
    k = weights.size
    p = weights.astype(np.float64)
    total = p.sum()
    if total <= 0 or k == 0:
        return np.ones(max(k, 1), np.float32), np.zeros(max(k, 1), np.int32)
    p = p * (k / total)
    prob = np.ones(k, np.float64)
    alias = np.arange(k, dtype=np.int32)
    small = [i for i in range(k) if p[i] < 1.0]
    large = [i for i in range(k) if p[i] >= 1.0]
    while small and large:
        s = small.pop()
        l = large.pop()
        prob[s] = p[s]
        alias[s] = l
        p[l] = p[l] - (1.0 - p[s])
        (small if p[l] < 1.0 else large).append(l)
    return prob.astype(np.float32), alias


QUAD_ROWS_MAX_TEXELS = 2_000_000  # 4K-equirect quad tables get too big


def build_envmap(image: np.ndarray) -> EnvMap:
    """Build the flat luminance CDF (``PathTracer.cs:299-307`` semantics)
    plus the gather-merged alias/quad tables used by the fused integrator."""
    img = np.asarray(image, np.float32)
    h, w = img.shape[0], img.shape[1]
    lum = img[..., 0] * 0.299 + img[..., 1] * 0.587 + img[..., 2] * 0.114
    flat = lum.reshape(-1)
    cdf = np.cumsum(flat, dtype=np.float64).astype(np.float32)
    prob, alias = _build_alias(flat)

    texels = img.reshape(-1, 3)
    alias_row = np.zeros((max(h * w, 1), 8), np.float32)
    alias_row[: h * w, 0] = prob[: h * w]
    alias_row[: h * w, 1] = alias[: h * w].view(np.float32)
    alias_row[: h * w, 2:5] = texels
    alias_row[: h * w, 5:8] = texels[alias[: h * w]]

    if h * w <= QUAD_ROWS_MAX_TEXELS:
        right = np.roll(img, -1, axis=1)
        down = np.roll(img, -1, axis=0)       # wrap in v, matching _bilinear_wrap
        downright = np.roll(right, -1, axis=0)
        quad = np.concatenate([img, right, down, downright], axis=-1)
        quad_rows = quad.reshape(-1, 12).astype(np.float32)
    else:
        quad_rows = np.zeros((1, 12), np.float32)

    if quad_rows.shape[0] == h * w:
        merged = np.concatenate([alias_row[: h * w], quad_rows], axis=1)
    else:
        merged = np.zeros((1, 20), np.float32)
    return EnvMap(
        image=jnp.asarray(img),
        cdf=jnp.asarray(cdf),
        cdf_sum=jnp.asarray(cdf[-1] if cdf.size else 0.0, jnp.float32),
        alias_prob=jnp.asarray(prob),
        alias_idx=jnp.asarray(alias),
        alias_row=jnp.asarray(alias_row),
        quad_rows=jnp.asarray(quad_rows),
        merged_rows=jnp.asarray(merged),
    )


def _bilerp_coords(h, w, uv):
    """Shared bilinear footprint: (x0i, y0i, fx, fy), wrap addressing."""
    u = uv[..., 0] - jnp.floor(uv[..., 0])
    v = uv[..., 1] - jnp.floor(uv[..., 1])
    x = u * w - 0.5
    y = v * h - 0.5
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0i = jnp.mod(x0.astype(jnp.int32), w)
    y0i = jnp.mod(y0.astype(jnp.int32), h)
    return x0i, y0i, fx, fy


def _bilinear_wrap(image: jnp.ndarray, uv: jnp.ndarray) -> jnp.ndarray:
    """GPU-style bilinear sample with wrap addressing, texel centers at .5."""
    h, w = image.shape[0], image.shape[1]
    x0i, y0i, fx, fy = _bilerp_coords(h, w, uv)
    x1i = jnp.mod(x0i + 1, w)
    y1i = jnp.mod(y0i + 1, h)
    p00 = image[y0i, x0i]
    p10 = image[y0i, x1i]
    p01 = image[y1i, x0i]
    p11 = image[y1i, x1i]
    return (p00 * (1 - fx) + p10 * fx) * (1 - fy) + (p01 * (1 - fx) + p11 * fx) * fy


def _bilinear_quad(env: EnvMap, uv: jnp.ndarray) -> jnp.ndarray:
    """Bilinear via the pre-baked 2x2 footprint rows: ONE gather instead of
    four (same values as :func:`_bilinear_wrap`, gather-merged)."""
    h, w = env.image.shape[0], env.image.shape[1]
    x0i, y0i, fx, fy = _bilerp_coords(h, w, uv)
    row = env.quad_rows[y0i * w + x0i]                          # (B, 12)
    p00, p10 = row[..., 0:3], row[..., 3:6]
    p01, p11 = row[..., 6:9], row[..., 9:12]
    return (p00 * (1 - fx) + p10 * fx) * (1 - fy) + (p01 * (1 - fx) + p11 * fx) * fy


def env_bilinear(env: EnvMap, uv: jnp.ndarray) -> jnp.ndarray:
    """Bilinear env fetch; uses the quad-row table when built."""
    h, w = env.image.shape[0], env.image.shape[1]
    if env.quad_rows.shape[0] == h * w:
        return _bilinear_quad(env, uv)
    return _bilinear_wrap(env.image, uv)


def eval_env_map(env: EnvMap, directions: jnp.ndarray, intensity, rotation):
    """Radiance + pdf for directions hitting the sky (``sky.hlsl:43-64``).

    Returns ``(color·intensity (B,3), pdf (B,))``.
    """
    h, w = env.image.shape[0], env.image.shape[1]
    d = directions
    theta = jnp.arccos(jnp.clip(d[..., 1], -1.0, 1.0))
    phi_atan = jnp.arctan2(d[..., 2], d[..., 0])
    uv = jnp.stack(
        [(PI + phi_atan) * INV_TWO_PI + rotation, 1.0 - theta * INV_PI], axis=-1
    )
    color = env_bilinear(env, uv)
    sin_theta = jnp.sin(theta)
    pdf = (
        luminance(color)
        / jnp.maximum(env.cdf_sum, 1e-20)
        * (w * h)
        / jnp.maximum(TWO_PI * PI * sin_theta, 1e-8)
    )
    pdf = jnp.where(sin_theta <= 0.0, 0.0, pdf)
    return color * jnp.asarray(intensity)[..., None], pdf


def sample_env_map(env: EnvMap, rotation, state):
    """Inverse-CDF direction sample (``sky.hlsl:66-88``).

    Returns ``(direction (B,3), color (B,3), pdf (B,), new_state)``.
    """
    from unity_webgpu_pathtracer_tpu.utils import rng as urng

    h, w = env.image.shape[0], env.image.shape[1]
    u, state = urng.random_float(state)
    target = u * env.cdf_sum
    idx = jnp.clip(jnp.searchsorted(env.cdf, target, side="right"), 0, w * h - 1)
    x = (idx % w).astype(jnp.float32)
    y = (idx // w).astype(jnp.float32)
    uv = jnp.stack([(x + 0.5) / w, (y + 0.5) / h], axis=-1)
    color = _bilinear_wrap(env.image, uv)
    pdf = luminance(color) / jnp.maximum(env.cdf_sum, 1e-20)

    theta = (1.0 - uv[..., 1]) * PI
    phi = (uv[..., 0] - rotation) * TWO_PI
    sin_theta = jnp.sin(theta)
    direction = jnp.stack(
        [-sin_theta * jnp.cos(phi), jnp.cos(theta), -sin_theta * jnp.sin(phi)],
        axis=-1,
    )
    pdf = pdf * (w * h) / jnp.maximum(TWO_PI * PI * sin_theta, 1e-8)
    pdf = jnp.where(sin_theta <= 0.0, 0.0, pdf)
    return direction, color, pdf, state


def _texel_direction_pdf(env: EnvMap, idx, rotation):
    """Shared tail of the samplers: texel index -> (uv, direction, pdf-jac)."""
    h, w = env.image.shape[0], env.image.shape[1]
    x = (idx % w).astype(jnp.float32)
    y = (idx // w).astype(jnp.float32)
    uv = jnp.stack([(x + 0.5) / w, (y + 0.5) / h], axis=-1)
    theta = (1.0 - uv[..., 1]) * PI
    phi = (uv[..., 0] - rotation) * TWO_PI
    sin_theta = jnp.sin(theta)
    direction = jnp.stack(
        [-sin_theta * jnp.cos(phi), jnp.cos(theta), -sin_theta * jnp.sin(phi)],
        axis=-1,
    )
    return uv, direction, sin_theta


def sample_env_map_alias(env: EnvMap, rotation, state):
    """O(1) alias-method env sample; same distribution as the CDF sampler.

    ONE row gather per sample: ``alias_row`` carries the acceptance
    probability, the alias index, and both candidate texel colors (the
    reference's bilinear lookup at a texel center degenerates to the texel
    itself, so baking the color is exact). Returns
    ``(direction, color, pdf, new_state)``.
    """
    from unity_webgpu_pathtracer_tpu.utils import rng as urng

    h, w = env.image.shape[0], env.image.shape[1]
    k = h * w
    (u1, u2), state = urng.random_floats(state, 2)
    bin_ = jnp.clip((u1 * k).astype(jnp.int32), 0, k - 1)
    row = env.alias_row[bin_]                                   # (B, 8)
    take_alias = u2 >= row[..., 0]
    alias_idx = jax.lax.bitcast_convert_type(row[..., 1], jnp.int32)
    idx = jnp.where(take_alias, alias_idx, bin_)
    color = jnp.where(take_alias[..., None], row[..., 5:8], row[..., 2:5])
    uv, direction, sin_theta = _texel_direction_pdf(env, idx, rotation)
    pdf = luminance(color) / jnp.maximum(env.cdf_sum, 1e-20)
    pdf = pdf * (w * h) / jnp.maximum(TWO_PI * PI * sin_theta, 1e-8)
    pdf = jnp.where(sin_theta <= 0.0, 0.0, pdf)
    return direction, color, pdf, state


def empty_envmap() -> EnvMap:
    """Placeholder keeping SceneData a fixed pytree when no HDRI is bound."""
    return EnvMap(
        image=jnp.zeros((1, 1, 3), jnp.float32),
        cdf=jnp.ones((1,), jnp.float32),
        cdf_sum=jnp.asarray(1.0, jnp.float32),
        alias_prob=jnp.ones((1,), jnp.float32),
        alias_idx=jnp.zeros((1,), jnp.int32),
        alias_row=jnp.zeros((1, 8), jnp.float32).at[0, 0].set(1.0),
        quad_rows=jnp.zeros((1, 12), jnp.float32),
        merged_rows=jnp.zeros((1, 20), jnp.float32),
    )


def sample_env_transition(env: EnvMap, rotation, directions, want_alias, state,
                          need=None, split=False):
    """The fused transition's entire environment interaction in ONE gather.

    Miss lanes and env-NEE lanes are disjoint, so a single index vector into
    ``merged_rows`` serves both: miss lanes read the 2x2 bilinear footprint
    (cols 8:20) at their direction's texel, NEE lanes read the alias row
    (cols 0:8) at their sampled bin. Falls back to the separate paths when
    the merged table is disabled (very large envs).

    ``need`` (optional bool mask): lanes whose result is actually consumed
    this transition.  When given, the other lanes' gather index is clamped
    to row 0 (cache-hot), so those lanes' reads cost no cold fetch
    (``RenderConfig.mask_stale_gathers``).  Callers must only pass a
    mask that covers every lane whose sky_*/nee_* output feeds the film.

    ``split`` (``RenderConfig.env_split_rows``): extract every field from
    the TRANSPOSED row — a contiguous (B,) slice of the gather result —
    instead of strided ``[B, j]`` columns.  Per-element values and op
    order are identical — films are bit-identical.

    Returns ``(sky_color, sky_pdf, nee_dir, nee_color, nee_pdf, state)`` —
    sky_* valid on ~want_alias lanes, nee_* on want_alias lanes.
    """
    from unity_webgpu_pathtracer_tpu.utils import rng as urng

    h, w = env.image.shape[0], env.image.shape[1]
    k = h * w
    (u1, u2), state = urng.random_floats(state, 2)
    bin_ = jnp.clip((u1 * k).astype(jnp.int32), 0, k - 1)

    # Sky footprint at the (escaped) path direction.
    d = directions
    theta = jnp.arccos(jnp.clip(d[..., 1], -1.0, 1.0))
    phi_atan = jnp.arctan2(d[..., 2], d[..., 0])
    uv = jnp.stack(
        [(PI + phi_atan) * INV_TWO_PI + rotation, 1.0 - theta * INV_PI],
        axis=-1,
    )

    if env.merged_rows.shape[0] != k:
        # Fallback: two separate gather paths (still gather-merged per use).
        sky_color = env_bilinear(env, uv)
        sin_theta = jnp.sin(theta)
        sky_pdf = (
            luminance(sky_color) / jnp.maximum(env.cdf_sum, 1e-20)
            * (w * h) / jnp.maximum(TWO_PI * PI * sin_theta, 1e-8)
        )
        sky_pdf = jnp.where(sin_theta <= 0.0, 0.0, sky_pdf)
        nee_dir, nee_color, nee_pdf, state = sample_env_map_alias(
            env, rotation, state)
        return sky_color, sky_pdf, nee_dir, nee_color, nee_pdf, state

    x0i, y0i, fx, fy = _bilerp_coords(h, w, uv)
    sky_idx = y0i * w + x0i
    idx = jnp.where(want_alias, bin_, sky_idx)
    if need is not None:
        idx = jnp.where(need, idx, 0)
    row = env.merged_rows[idx]                                  # (B, 20)

    if split:
        # All extracts off the transposed row: each field is a contiguous
        # (B,) slice.  The bitcast rides the full-width (B,) vector — the
        # same data-movement-only path the unsplit [B, 1] column took
        # (integer bit patterns must never enter f32 arithmetic, where a
        # backend may flush them as denormals).
        rowT = row.T                                            # (20, B)
        take_alias = u2 >= rowT[0]
        alias_idx = jax.lax.bitcast_convert_type(rowT[1], jnp.int32)
        a_idx = jnp.where(take_alias, alias_idx, bin_)
        nee_color = jnp.stack(
            [jnp.where(take_alias, rowT[5 + c], rowT[2 + c])
             for c in range(3)], axis=-1)
        _uv_a, nee_dir, sin_a = _texel_direction_pdf(env, a_idx, rotation)
        nee_pdf = luminance(nee_color) / jnp.maximum(env.cdf_sum, 1e-20)
        nee_pdf = nee_pdf * (w * h) / jnp.maximum(TWO_PI * PI * sin_a, 1e-8)
        nee_pdf = jnp.where(sin_a <= 0.0, 0.0, nee_pdf)
        # Sky half, per component (identical per-element op order ->
        # bit-identical to the (B, 3) form below; fx/fy arrive (B, 1) for
        # the (B, 3) broadcast and are squeezed to (B,) here).
        fxs, fys = fx[..., 0], fy[..., 0]
        sky_color = jnp.stack(
            [(rowT[8 + c] * (1 - fxs) + rowT[11 + c] * fxs) * (1 - fys)
             + (rowT[14 + c] * (1 - fxs) + rowT[17 + c] * fxs) * fys
             for c in range(3)], axis=-1)
        sin_theta = jnp.sin(theta)
        sky_pdf = (
            luminance(sky_color) / jnp.maximum(env.cdf_sum, 1e-20)
            * (w * h) / jnp.maximum(TWO_PI * PI * sin_theta, 1e-8)
        )
        sky_pdf = jnp.where(sin_theta <= 0.0, 0.0, sky_pdf)
        return sky_color, sky_pdf, nee_dir, nee_color, nee_pdf, state

    # NEE half (alias method).
    take_alias = u2 >= row[..., 0]
    alias_idx = jax.lax.bitcast_convert_type(row[..., 1], jnp.int32)
    a_idx = jnp.where(take_alias, alias_idx, bin_)
    nee_color = jnp.where(take_alias[..., None], row[..., 5:8], row[..., 2:5])
    _uv_a, nee_dir, sin_a = _texel_direction_pdf(env, a_idx, rotation)
    nee_pdf = luminance(nee_color) / jnp.maximum(env.cdf_sum, 1e-20)
    nee_pdf = nee_pdf * (w * h) / jnp.maximum(TWO_PI * PI * sin_a, 1e-8)
    nee_pdf = jnp.where(sin_a <= 0.0, 0.0, nee_pdf)

    # Sky half (bilinear from the pre-baked footprint).
    p00, p10 = row[..., 8:11], row[..., 11:14]
    p01, p11 = row[..., 14:17], row[..., 17:20]
    sky_color = (p00 * (1 - fx) + p10 * fx) * (1 - fy) + (
        p01 * (1 - fx) + p11 * fx) * fy
    sin_theta = jnp.sin(theta)
    sky_pdf = (
        luminance(sky_color) / jnp.maximum(env.cdf_sum, 1e-20)
        * (w * h) / jnp.maximum(TWO_PI * PI * sin_theta, 1e-8)
    )
    sky_pdf = jnp.where(sin_theta <= 0.0, 0.0, sky_pdf)
    return sky_color, sky_pdf, nee_dir, nee_color, nee_pdf, state
