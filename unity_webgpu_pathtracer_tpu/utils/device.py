"""What the measurement entry points (``bench.py``, ``chip_smoke.py``) ran on.

Every number they print names its device.  They run on a GPU or not at
all: :func:`require_gpu` refuses any other default backend instead of
falling back to the CPU.
"""

from __future__ import annotations

import subprocess

NVIDIA_SMI_QUERY = ["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"]


class NoGPUError(RuntimeError):
    pass


def require_gpu():
    """The JAX devices, or :class:`NoGPUError` naming the platform found."""
    import jax

    platform = jax.default_backend()
    if platform != "gpu":
        raise NoGPUError(f"no GPU: JAX's default backend is {platform!r} "
                         f"({jax.devices()})")
    return jax.devices()


def device_info(devices) -> dict:
    """``{"platform", "kind", "count"}`` as JAX reports them."""
    return {"platform": devices[0].platform, "kind": devices[0].device_kind,
            "count": len(devices)}


def gpu_name_and_power_limit() -> str:
    """``nvidia-smi``'s name and power limit, one line per card.

    Runs in a child process that does not import JAX, so it never opens
    the card a second time."""
    try:
        out = subprocess.run(NVIDIA_SMI_QUERY, capture_output=True,
                             text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    return out.stdout.strip()


def peak_bytes_in_use(device) -> int | None:
    """``memory_stats()["peak_bytes_in_use"]``, or None if not reported."""
    stats = device.memory_stats() or {}
    return stats.get("peak_bytes_in_use")
