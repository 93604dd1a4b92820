"""Persistent compilation cache placement.

JAX reads ``JAX_COMPILATION_CACHE_DIR`` itself; when it is set, nothing
here touches the configuration. Otherwise the cache goes to ``.jax_cache``
at the root of the checkout (git-ignored), a fixed path so that every run
from the same checkout finds what an earlier one compiled.
"""

from __future__ import annotations

import os

import jax

CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def configure_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its one place and
    return that directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    return CACHE_DIR
