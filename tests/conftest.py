"""Test configuration: force an 8-device virtual CPU mesh.

All tests run on CPU (JAX executes the identical XLA program), with 8 virtual
host devices so multi-device sharding tests exercise real collectives
without a GPU.  Must run before the first ``import jax``.  Tests that need
the card carry the ``gpu`` marker and run ``chip_smoke.py`` in a child
process (tests/test_chip_smoke.py).
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
# Keep the BVH build cache inside the repo's ignored cache dir (hermetic,
# and repeated suite runs skip identical host builds).
os.environ.setdefault(
    "UWPT_BVH_CACHE_DIR",
    os.path.join(os.path.dirname(__file__), "..", ".jax_cache", "bvh"))
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

# The config update makes the CPU choice stick whatever the environment says.
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", False)

# Persistent compilation cache (repeated suite runs skip recompiles):
# JAX_COMPILATION_CACHE_DIR when set, else <checkout>/.jax_cache.
from unity_webgpu_pathtracer_tpu.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import pytest  # noqa: E402

# Smoke tier: `pytest -m smoke` = fast first signal (< ~2 min cold, seconds
# warm).  Modules whose tests build no large jit graph — numpy builders,
# bit-exact RNG/math checks, IO — are auto-marked; anything `slow` is
# excluded even inside these modules.
_SMOKE_MODULES = {
    "test_rng", "test_math", "test_image", "test_native", "test_bvh",
    "test_envmap", "test_wide16_leaf8",
}


def pytest_collection_modifyitems(config, items):
    for item in items:
        mod = item.module.__name__.rsplit(".", 1)[-1]
        if mod in _SMOKE_MODULES and "slow" not in item.keywords:
            item.add_marker(pytest.mark.smoke)
