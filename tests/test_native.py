"""Native C++ builder: availability, invariants, and equivalence of the
traversal result against the numpy builder (trees may differ; closest hits
must not)."""

import numpy as np
import pytest

from unity_webgpu_pathtracer_tpu.accel import bvh2 as ubvh2
from unity_webgpu_pathtracer_tpu.accel import mbvh as umbvh
from unity_webgpu_pathtracer_tpu.accel.native import native_available, native_build_or_none


def _random_tris(n, seed=0, spread=10.0):
    r = np.random.default_rng(seed)
    base = r.uniform(-spread, spread, (n, 1, 3))
    return (base + r.normal(0, 0.5, (n, 3, 3))).astype(np.float32)


pytestmark = pytest.mark.skipif(not native_available(), reason="native lib not built")


@pytest.mark.parametrize("n", [1, 5, 64, 3000])
def test_native_invariants(n):
    pos = _random_tris(n, seed=n)
    out = native_build_or_none(pos)
    assert out is not None
    bounds, child, order = out
    umbvh.validate_mbvh(bounds, child, pos, order)


def test_native_matches_numpy_hits():
    import jax.numpy as jnp
    from tests.test_bvh import _scene_from_positions  # reuse scene builder
    from unity_webgpu_pathtracer_tpu.ops import traverse_mbvh as trav
    from unity_webgpu_pathtracer_tpu.scene.scene import SceneData

    pos = _random_tris(800, seed=3)
    # numpy tree
    scene_np = _scene_from_positions(pos)
    # native tree
    bounds, child, order = native_build_or_none(pos)
    p = pos[order]
    v0 = p[:, 0]
    tris = np.concatenate([p[:, 2] - v0, p[:, 1] - v0, v0], -1).astype(np.float32)
    scene_nat = scene_np._replace(
        tris=jnp.asarray(tris),
        tri_index=jnp.asarray(order.astype(np.int32)),
        bvh_bounds=jnp.asarray(bounds),
        bvh_child=jnp.asarray(child),
    )

    r = np.random.default_rng(4)
    o = jnp.asarray(r.uniform(-12, 12, (256, 3)).astype(np.float32))
    d = r.normal(size=(256, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d = jnp.asarray(d)

    t1, _, s1, _ = trav.closest_hit(scene_np, o, d)
    t2, _, s2, _ = trav.closest_hit(scene_nat, o, d)
    np.testing.assert_allclose(np.asarray(t1), np.asarray(t2), rtol=1e-4, atol=1e-4)
    # Same original triangle (orders differ; map through tri_index).
    hit = np.asarray(t1) < 1e4
    orig1 = np.asarray(scene_np.tri_index)[np.asarray(s1)[hit]]
    orig2 = np.asarray(scene_nat.tri_index)[np.asarray(s2)[hit]]
    np.testing.assert_array_equal(orig1, orig2)


def test_native_large_build_speed():
    import time

    pos = _random_tris(200_000, seed=7, spread=50.0)
    t0 = time.time()
    out = native_build_or_none(pos)
    dt = time.time() - t0
    assert out is not None
    assert dt < 20.0, f"native build too slow: {dt:.1f}s"


def test_f2h_parity_fuzz():
    """The C++ builder's f2h and the numpy fallback's canonical-f16 path
    must be BIT-IDENTICAL on every input class (normals, subnormals,
    +-0, inf, NaN, round-to-overflow values like 65520.0) — tables built
    by either path feed the same traversal, whose table contract
    (no subnormals/-0, no inf/nan) both emitters implement independently
    in two languages.  A deliberate divergence here must fail."""
    import warnings

    from unity_webgpu_pathtracer_tpu.accel.native import (
        native_available,
        native_f2h_or_none,
    )
    from unity_webgpu_pathtracer_tpu.accel.wide16 import _canon_f16

    if not native_available():
        import pytest

        pytest.skip("native builder unavailable")

    rng = np.random.default_rng(0xF16)
    bits = rng.integers(0, 2**32, size=1_000_000, dtype=np.uint64).astype(np.uint32)
    # Deterministic edge set on top of the fuzz: exact boundaries of every
    # branch in both implementations.
    edges = np.array([
        0.0, -0.0, 1.0, -1.0, 65504.0, -65504.0,
        65519.996, 65520.0, 65536.0, 1e30, -1e30,
        np.inf, -np.inf, np.nan,
        6.103515625e-05,        # smallest f16 normal
        6.0975551605224609e-05,  # largest f16 subnormal target
        5.960464477539063e-08,   # smallest f16 subnormal target
        2.9802322387695312e-08,  # exact tie to zero
        3.0e-08, 1e-20, -1e-20, 2.0**-25, 2.0**-24,
    ], np.float32)
    x = np.concatenate([bits.view(np.float32), edges])

    got = native_f2h_or_none(x)
    assert got is not None, "stale libuwptbvh.so without f2h_batch: make -C native"
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # overflow-in-cast is the point
        ref = _canon_f16(x.astype(np.float16))
    bad = got != ref
    assert not bad.any(), (
        f"{int(bad.sum())} mismatches; first: "
        f"x={x[bad][0]!r} cpp={hex(got[bad][0])} numpy={hex(ref[bad][0])}")


def test_stale_library_is_rebuilt(tmp_path, monkeypatch):
    """A library older than its source is rebuilt on first load, not
    loaded stale (a library copied from another checkout, say)."""
    import os
    import shutil

    from unity_webgpu_pathtracer_tpu.accel import native

    for name in ("Makefile", "bvh_builder.cpp"):
        shutil.copy(os.path.join(native._NATIVE_DIR, name), tmp_path)
    lib = str(tmp_path / os.path.basename(native._LIB_PATH))
    src = str(tmp_path / "bvh_builder.cpp")
    monkeypatch.setattr(native, "_NATIVE_DIR", str(tmp_path))
    monkeypatch.setattr(native, "_LIB_PATH", lib)
    monkeypatch.setattr(native, "_SRC_PATH", src)
    monkeypatch.setenv("CXXFLAGS", "-O0 -fPIC -std=c++17")
    monkeypatch.setattr(native, "_TRIED", False)
    monkeypatch.setattr(native, "_LIB", None)
    assert native._stale()                      # no library yet
    assert native._load() is not None
    assert not native._stale()

    old = os.path.getmtime(src) - 100.0         # the source is now newer
    os.utime(lib, (old, old))
    assert native._stale()
    monkeypatch.setattr(native, "_TRIED", False)
    assert native._load() is not None
    assert os.path.getmtime(lib) > old
    assert not native._stale()
