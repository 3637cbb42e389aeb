"""Where compiled programs are cached on disk.

One directory holds both JAX's persistent compilation cache and the AOT
executable cache (utils/aot.py, under ``aot/``). If the environment sets
``JAX_COMPILATION_CACHE_DIR``, JAX already reads it and nothing is set in
code; otherwise the cache lives at ``<checkout>/.jax_cache``, a fixed path
(the path is part of the cache key, so a moving directory never hits).
"""

from __future__ import annotations

import os

import jax

_CHECKOUT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
DEFAULT_DIR = os.path.join(_CHECKOUT, ".jax_cache")
ENV_VAR = "JAX_COMPILATION_CACHE_DIR"


def cache_dir() -> str:
    """The compile-cache directory in effect (environment first)."""
    return os.environ.get(ENV_VAR) or DEFAULT_DIR


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache; returns its directory."""
    if not os.environ.get(ENV_VAR):
        jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return cache_dir()
