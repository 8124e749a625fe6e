"""Progressive Monte-Carlo path-tracing framework in JAX/XLA.

A from-scratch JAX/XLA rebuild of the capabilities of
``brendan-duncan/unity_webgpu_pathtracer`` (a Unity 6 + WebGPU HLSL megakernel
path tracer, see ``SURVEY.md``), running on NVIDIA GPUs:

* **fused wavefront integration** — one ``lax.while_loop`` interleaving
  traversal arrivals and shading transitions over a flat ray pool with path
  regeneration into dead lanes (replaces the reference's divergent per-pixel
  megakernel, ``Assets/Resources/util/pathtrace.hlsl:25-128``),
* **16-wide quantized BVH traversal** — batched per-lane stacks over flat
  node rows in device memory (replaces the HLSL CWBVH stack traversal,
  ``Assets/Resources/util/bvh.hlsl:141-197``),
* **host-side C++/numpy BVH builders** (replaces the tinybvh C plugin,
  ``Assets/Plugins/Web/plugin.cpp``),
* **multi-device film tiling / sample sharding** over a
  ``jax.sharding.Mesh`` with collectives (no analogue in the single-GPU
  reference).

Public entry points:

* :class:`unity_webgpu_pathtracer_tpu.api.Renderer` — progressive renderer.
* :mod:`unity_webgpu_pathtracer_tpu.models` — example scenes mirroring the
  reference's ``Assets/Examples/Scenes``.
* ``python -m unity_webgpu_pathtracer_tpu.cli`` — command-line renderer.
"""

__version__ = "0.1.0"

from unity_webgpu_pathtracer_tpu.config import RenderConfig, RenderParams  # noqa: F401

__all__ = ["RenderConfig", "RenderParams", "__version__"]
