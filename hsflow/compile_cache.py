"""Persistent XLA compile cache: one place that decides where it lives."""

from __future__ import annotations

import os

# <checkout>/.jax_cache: a fixed path (the cache key includes it), listed in
# .gitignore.
_DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)


def enable_compile_cache() -> str:
    """Turn the persistent compile cache on and return its directory.

    JAX reads JAX_COMPILATION_CACHE_DIR itself; when that is set nothing
    else is configured here. Otherwise the cache goes to <checkout>/.jax_cache.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", _DEFAULT_DIR)
    return _DEFAULT_DIR
