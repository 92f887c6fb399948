"""Where the persistent XLA compilation cache lives.

JAX reads JAX_COMPILATION_CACHE_DIR itself; when it is set, nothing is set
here.  Otherwise the cache goes to `<checkout>/.jax_cache`, a fixed path so
that later runs from the same checkout find what earlier runs compiled.
"""
from __future__ import annotations

import os

import jax

CHECKOUT_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory (see the
    module docstring) and return that directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", CHECKOUT_CACHE)
    return CHECKOUT_CACHE
