"""Tonemap operators (``Assets/Resources/util/tonemap.hlsl``) and the full
presentation chain (``Assets/Resources/Presentation.shader:36-73``).

Pure elementwise jnp — XLA fuses the whole chain into one pass over the film.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from unity_webgpu_pathtracer_tpu.config import (
    TONEMAP_ACES,
    TONEMAP_FILMIC,
    TONEMAP_LOTTES,
    TONEMAP_NONE,
    TONEMAP_REINHARD,
    PostParams,
)
from unity_webgpu_pathtracer_tpu.utils.math import luminance, matmul_f32

_ACES_IN = np.array(
    [[0.59719, 0.35458, 0.04823],
     [0.07600, 0.90834, 0.01566],
     [0.02840, 0.13383, 0.83777]], np.float32)
_ACES_OUT = np.array(
    [[1.60475, -0.53108, -0.07367],
     [-0.10208, 1.10813, -0.00605],
     [-0.00327, -0.07276, 1.07602]], np.float32)


def linear_to_srgb(rgb: jnp.ndarray) -> jnp.ndarray:
    """Piecewise sRGB OETF (``tonemap.hlsl:6-11``)."""
    safe = jnp.maximum(rgb, 0.0)
    low = safe * 12.92
    high = jnp.power(safe, 1.0 / 2.4) * 1.055 - 0.055
    return jnp.where(safe > 0.0031308, high, low)


def srgb_to_linear(rgb: jnp.ndarray) -> jnp.ndarray:
    safe = jnp.maximum(rgb, 0.0)
    low = safe / 12.92
    high = jnp.power((safe + 0.055) / 1.055, 2.4)
    return jnp.where(safe > 0.04045, high, low)


def aces(color: jnp.ndarray) -> jnp.ndarray:
    """ACES RRT+ODT fit (``tonemap.hlsl:21-45``)."""
    c = matmul_f32(color, jnp.asarray(_ACES_IN).T)
    a = c * (c + 0.0245786) - 0.000090537
    b = c * (0.983729 * c + 0.4329510) + 0.238081
    return matmul_f32(a / b, jnp.asarray(_ACES_OUT).T)


def filmic(x: jnp.ndarray) -> jnp.ndarray:
    """Hejl/Burgess-Dawson filmic (``tonemap.hlsl:48-53``)."""
    xx = jnp.maximum(0.0, x - 0.004)
    r = (xx * (6.2 * xx + 0.5)) / (xx * (6.2 * xx + 1.7) + 0.06)
    return jnp.power(r, 2.2)


def lottes(x: jnp.ndarray) -> jnp.ndarray:
    """Lottes 2016 HDR curve (``tonemap.hlsl:56-72``)."""
    a, d = 1.6, 0.977
    hdr_max, mid_in, mid_out = 8.0, 0.18, 0.267
    b = (-(mid_in ** a) + (hdr_max ** a) * mid_out) / (
        ((hdr_max ** (a * d)) - (mid_in ** (a * d))) * mid_out
    )
    c = ((hdr_max ** (a * d)) * (mid_in ** a) - (hdr_max ** a) * (mid_in ** (a * d)) * mid_out) / (
        ((hdr_max ** (a * d)) - (mid_in ** (a * d))) * mid_out
    )
    xs = jnp.maximum(x, 0.0)
    return jnp.power(xs, a) / (jnp.power(xs, a * d) * b + c)


def reinhard(x: jnp.ndarray) -> jnp.ndarray:
    return x / (1.0 + jnp.maximum(x, 0.0))


_OPERATORS = {
    TONEMAP_NONE: lambda x: x,
    TONEMAP_ACES: aces,
    TONEMAP_FILMIC: filmic,
    TONEMAP_REINHARD: reinhard,
    TONEMAP_LOTTES: lottes,
}


def present(color: jnp.ndarray, post: PostParams) -> jnp.ndarray:
    """Full presentation chain (``Presentation.shader:36-73``).

    Input is linear mean radiance (H, W, 3); output is display-ready [0,1].
    Vignette uses uv from the array geometry (row 0 = bottom of frame).
    """
    c = color * post.exposure
    c = _OPERATORS[post.mode](c)
    if post.srgb:
        c = linear_to_srgb(c)
    c = jnp.clip(0.5 + (c - 0.5) * post.contrast, 0.0, 1.0)
    c = jnp.power(c, 1.0 / post.brightness)
    lum = luminance(c)[..., None]
    c = lum + (c - lum) * post.saturation
    if post.vignette != 0.0:
        h, w = color.shape[0], color.shape[1]
        ys = (jnp.arange(h, dtype=c.dtype) + 0.5) / h
        xs = (jnp.arange(w, dtype=c.dtype) + 0.5) / w
        cy = (ys - 0.5)[:, None] * 2.0
        cx = (xs - 0.5)[None, :] * 2.0
        c = c * (1.0 - (cx * cx + cy * cy) * post.vignette)[..., None]
    return jnp.clip(c, 0.0, 1.0)


present_jit = jax.jit(present, static_argnums=(1,))
