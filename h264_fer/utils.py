"""Small runtime utilities shared by the CLI, bench and drivers."""

from __future__ import annotations

import os
import pathlib

# fixed in-checkout cache location: the directory is part of JAX's cache
# key, so a path that moves between runs never hits
REPO_CACHE_DIR = pathlib.Path(__file__).resolve().parents[1] / ".jax_cache"


def enable_compilation_cache() -> str:
    """Turn on JAX's persistent compilation cache.

    The 1080p device programs take a long time to compile (XLA traces the
    whole wavefront + entropy pipeline); the persistent cache lets a fresh
    process reuse them. Call once per process, before the first jit
    execution.

    The directory is ``$JAX_COMPILATION_CACHE_DIR`` when that is set (JAX
    reads the variable itself), else ``<repo>/.jax_cache``. Returns the
    directory used.
    """
    import jax

    cache = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not cache:
        cache = str(REPO_CACHE_DIR)
        jax.config.update("jax_compilation_cache_dir", cache)
    os.makedirs(cache, exist_ok=True)
    return cache
