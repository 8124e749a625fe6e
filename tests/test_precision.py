"""Matrix products on the render path run in full float32: camera rays,
the reprojection's camera-space transforms and the ACES fit, each against
a float64 NumPy reference, and each lowered with HIGHEST precision so no
backend may run it in TF32 or bf16 passes."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from unity_webgpu_pathtracer_tpu.config import RenderConfig
from unity_webgpu_pathtracer_tpu.post import tonemap
from unity_webgpu_pathtracer_tpu.render import camera, reproject

W, H = 96, 54
CONFIG = RenderConfig(width=W, height=H)
PARAMS = camera.make_camera_params(eye=(1.3, 2.1, 7.7),
                                   target=(0.2, 0.4, -0.3), fov_y_deg=55.0,
                                   width=W, height=H)


def _coords():
    ys, xs = np.divmod(np.arange(W * H), W)
    return np.stack([xs + 0.5, ys + 0.5], -1)


def _f64(x):
    return np.asarray(x, np.float64)


def _dirs_f64(coords):
    ip, c2w = _f64(PARAMS.cam_inv_proj), _f64(PARAMS.cam_to_world)
    uv = coords / np.array([W, H]) * 2.0 - 1.0
    d = (uv[:, 0:1] * ip[:3, 0] + uv[:, 1:2] * ip[:3, 1] + ip[:3, 3]) \
        @ c2w[:3, :3].T
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


def _camera():
    """Ray directions at every pixel center (unit vectors)."""
    coords = jnp.asarray(_coords(), jnp.float32)

    def fn(c):
        return camera.get_screen_ray(c, CONFIG, PARAMS,
                                     jnp.zeros(W * H, jnp.uint32))[1]

    return fn, coords, _dirs_f64(_coords()), 1e-6


def _reproject():
    """Pixel coordinates of world points in front of the camera; the
    tolerance is relative to the film's width."""
    rng = np.random.default_rng(2)
    pts = rng.uniform(-3, 3, (W * H, 3)).astype(np.float32)
    c2w, ip = _f64(PARAMS.cam_to_world), _f64(PARAMS.cam_inv_proj)
    cam = (_f64(pts) - c2w[:3, 3]) @ c2w[:3, :3]
    pts = pts[-cam[:, 2] > 0.5]
    cam = cam[-cam[:, 2] > 0.5]
    z = -cam[:, 2]
    uv = np.stack([cam[:, 0] / (z * ip[0, 0]), cam[:, 1] / (z * ip[1, 1])],
                  -1)

    def fn(p):
        return reproject._project_to_camera(p, CONFIG, PARAMS)[0]

    return fn, jnp.asarray(pts), (uv + 1.0) * 0.5 * np.array([W, H]), 2e-6 * W


def _aces():
    rng = np.random.default_rng(3)
    color = rng.uniform(0.0, 8.0, (4096, 3))
    c = color @ np.asarray(tonemap._ACES_IN, np.float64).T
    a = c * (c + 0.0245786) - 0.000090537
    b = c * (0.983729 * c + 0.4329510) + 0.238081
    ref = (a / b) @ np.asarray(tonemap._ACES_OUT, np.float64).T
    return tonemap.aces, jnp.asarray(color, jnp.float32), ref, 2e-6


CASES = {"camera": _camera, "reproject": _reproject, "aces": _aces}


@pytest.mark.parametrize("case", sorted(CASES))
def test_precision_vs_float64(case):
    fn, arg, ref, tol = CASES[case]()
    got = _f64(jax.jit(fn)(arg))
    assert np.abs(got - ref).max() <= tol


@pytest.mark.parametrize("case", sorted(CASES))
def test_matmuls_ask_for_highest(case):
    fn, arg, _ref, _tol = CASES[case]()
    text = jax.jit(fn).lower(arg).as_text()
    dots = [l for l in text.splitlines() if "dot_general" in l]
    assert dots, "no matrix product found"
    for line in dots:
        assert re.search(r"precision = \[HIGHEST, HIGHEST\]", line), line


def test_center_rays_match_camera_rays():
    """The reprojection's pinhole rays are the camera's, in full f32."""
    _o, d = jax.jit(reproject._center_rays, static_argnums=(0,))(CONFIG,
                                                                 PARAMS)
    assert np.abs(_f64(d) - _dirs_f64(_coords())).max() <= 1e-6
