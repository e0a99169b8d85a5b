"""Persistent XLA compilation cache for the program's entry points.

``chip_smoke.py``, ``bench.py`` and ``python -m solid_dsp_tpu`` call
:func:`enable_compile_cache` once at start-up.  When the environment sets
``JAX_COMPILATION_CACHE_DIR``, JAX already reads it and nothing is set
here.  Otherwise the cache lives at a fixed path inside the checkout,
``<checkout>/.jax_cache`` (listed in ``.gitignore``): the directory is
part of the cache key, so a path that moved between runs would never hit.
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

__all__ = ["default_cache_dir", "enable_compile_cache"]

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"


def default_cache_dir() -> Path:
    """``<checkout>/.jax_cache``: beside the ``solid_dsp_tpu`` package."""
    return Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Make JAX keep compiled programs across processes; returns the
    directory in use."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    path = str(default_cache_dir())
    jax.config.update("jax_compilation_cache_dir", path)
    return path
