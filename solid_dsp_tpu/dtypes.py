"""Dtype policy.

The reference library computes everything in f64 / Complex<f64>.  On the
GPU the fast path is f32/c64 (TF32 tensor cores inside matmuls at
"default" precision); golden-parity tests run on
CPU with x64 enabled.  Every op takes an optional ``dtype`` and defaults to
the *current* JAX x64 setting so the same code serves both modes.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = [
    "real_dtype",
    "complex_dtype",
    "golden_real",
    "golden_complex",
]


def real_dtype():
    """Default real dtype: f64 when x64 is enabled, else f32."""
    return jnp.float64 if jax.config.jax_enable_x64 else jnp.float32


def complex_dtype():
    """Default complex dtype: c128 when x64 is enabled, else c64."""
    return jnp.complex128 if jax.config.jax_enable_x64 else jnp.complex64


# Golden tests always compare in the widest available precision.
golden_real = jnp.float64
golden_complex = jnp.complex128
