"""Persistent XLA compilation cache for the product entry points.

The fused wavefront pass is one large XLA module whose cold compile takes
a noticeable part of a session's start-up (the reference's analogue is
shader-variant compilation, which Unity caches on disk transparently —
``Library/ShaderCache``).  The CLI, ``bench.py``, ``chip_smoke.py`` and
(by default) :class:`~unity_webgpu_pathtracer_tpu.api.Renderer` enable
JAX's persistent compilation cache so later sessions start warm.

Where the cache lives (:func:`resolve_cache_dir`):

* ``JAX_COMPILATION_CACHE_DIR`` set: JAX reads it itself, and this module
  sets no directory in code;
* otherwise the fixed path ``<checkout>/.jax_cache`` (listed in
  ``.gitignore``) — a fixed path, because the path is part of the cache's
  key and a moving directory never hits;
* ``UWPT_CACHE=0`` disables the cache.

Importing the package never mutates global JAX config; constructing a
``Renderer`` DOES (documented on the class) unless the embedding
application already configured a cache directory (an existing setting is
never overridden) or opts out with ``Renderer(..., compile_cache=False)``.
"""

from __future__ import annotations

import os

CHECKOUT_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_CACHE_DIR = os.path.join(CHECKOUT_DIR, ".jax_cache")


def resolve_cache_dir(environ=None) -> str | None:
    """The cache directory the environment asks for, or None if disabled."""
    env = os.environ if environ is None else environ
    if env.get("UWPT_CACHE", "1") == "0":
        return None
    return env.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR


def enable_compile_cache(cache_dir: str | None = None) -> str | None:
    """Point JAX's persistent compilation cache at :func:`resolve_cache_dir`.

    Returns the directory in use, or None when disabled (``UWPT_CACHE=0``).
    A directory already configured — by ``JAX_COMPILATION_CACHE_DIR`` or
    by the application — is respected, never redirected; only an explicit
    ``cache_dir`` overrides it.  Safe to call more than once.  NOTE: this
    mutates process-global JAX config; every jit compilation in the
    process, not just this package's, lands in the cache directory.
    """
    if resolve_cache_dir() is None:
        return None
    import jax

    if cache_dir is None:
        existing = jax.config.jax_compilation_cache_dir
        if existing:
            return existing
        cache_dir = resolve_cache_dir()
    os.makedirs(cache_dir, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return cache_dir
