"""CLI smoke tests: render and animate commands end-to-end on CPU.

Covers the reference's scripted interaction loops headlessly:
``FreeViewCamera.cs`` (orbit camera -> accumulation reset) and
``Bounce.cs`` (per-frame instance transforms -> TLAS-only refresh).
"""

import os

import numpy as np
import pytest

from unity_webgpu_pathtracer_tpu.cli import main


def test_cli_render_quad(tmp_path):
    out = str(tmp_path / "quad.png")
    main(["render", "builtin:quad", "--out", out, "--size", "32",
          "--spp", "2", "--spp-per-pass", "2", "--bounces", "2"])
    assert os.path.exists(out)
    from unity_webgpu_pathtracer_tpu.utils.image import read_png

    img = read_png(out)
    assert img.shape == (32, 32, 3)
    assert img.max() > 0


def test_cli_animate_orbit_bounce(tmp_path):
    out = str(tmp_path / "frame.png")
    main(["animate", "builtin:tlas", "--out", out, "--frames", "2",
          "--size", "32", "--spp", "1", "--bounces", "2",
          "--orbit", "--bounce"])
    frames = [str(tmp_path / f"frame-{i:04d}.png") for i in range(2)]
    for f in frames:
        assert os.path.exists(f)
    from unity_webgpu_pathtracer_tpu.utils.image import read_png

    a, b = (read_png(f).astype(np.float32) for f in frames)
    # Camera orbited half a turn and instances moved: frames must differ.
    assert np.abs(a - b).max() > 0


def test_enable_compile_cache(tmp_path, monkeypatch):
    from unity_webgpu_pathtracer_tpu.compile_cache import enable_compile_cache

    import jax

    prev = jax.config.jax_compilation_cache_dir
    try:
        d = str(tmp_path / "xla_cache")
        assert enable_compile_cache(d) == d
        assert os.path.isdir(d)
        assert jax.config.jax_compilation_cache_dir == d
        monkeypatch.setenv("UWPT_CACHE", "0")
        assert enable_compile_cache(str(tmp_path / "other")) is None
    finally:
        jax.config.update("jax_compilation_cache_dir", prev)


@pytest.fixture
def fresh_cache_config(monkeypatch):
    """Empty ``jax_compilation_cache_dir`` for the test; restored after."""
    import jax

    prev = jax.config.jax_compilation_cache_dir
    jax.config.update("jax_compilation_cache_dir", None)
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.delenv("UWPT_CACHE", raising=False)
    yield jax
    jax.config.update("jax_compilation_cache_dir", prev)


@pytest.mark.parametrize("env,want", [
    ({"JAX_COMPILATION_CACHE_DIR": "/some/cache"}, "/some/cache"),
    ({}, "default"),
    ({"UWPT_CACHE": "0", "JAX_COMPILATION_CACHE_DIR": "/x"}, None),
])
def test_compile_cache_resolution(env, want):
    from unity_webgpu_pathtracer_tpu.compile_cache import (
        DEFAULT_CACHE_DIR,
        resolve_cache_dir,
    )

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert DEFAULT_CACHE_DIR == os.path.join(repo, ".jax_cache")
    got = resolve_cache_dir(env)
    assert got == (DEFAULT_CACHE_DIR if want == "default" else want)


@pytest.mark.parametrize("set_env", [True, False])
def test_bench_compile_cache_lands_where_resolved(fresh_cache_config,
                                                  monkeypatch, tmp_path,
                                                  set_env):
    """bench.py enables the cache the same way the package does: the
    variable's directory when set, else <checkout>/.jax_cache."""
    import bench
    from unity_webgpu_pathtracer_tpu.compile_cache import DEFAULT_CACHE_DIR

    jax = fresh_cache_config
    if set_env:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert bench.main() != 0          # refuses the CPU after enabling
    want = str(tmp_path) if set_env else DEFAULT_CACHE_DIR
    assert jax.config.jax_compilation_cache_dir == want


def test_existing_cache_dir_is_respected(fresh_cache_config, tmp_path):
    from unity_webgpu_pathtracer_tpu.compile_cache import enable_compile_cache

    jax = fresh_cache_config
    jax.config.update("jax_compilation_cache_dir", str(tmp_path))
    assert enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == str(tmp_path)
