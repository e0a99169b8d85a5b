"""DotProduct — the universal coefficient-store + MAC kernel.

Parity: reference ``src/dot_product/mod.rs`` — struct (:37-42), new (:57-87)
with FORWARD/REVERSE storage, execute (:153-171) which MACs over
min(len(samples), len(coefs)) terms.

The reference's execute is a scalar loop; here a single execute is one dot
product and the *block* form (many sample windows at once) is a matmul:
``windows (T, n) @ coefs (n,)``.  Everything downstream (FIR taps, IIR
recurrence terms, generic DFT rows, filter-energy probes) funnels through
these two entry points, exactly like the reference's layer map (SURVEY §1 L2).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

__all__ = ["Direction", "DotProduct", "dot", "dot_block"]


class Direction:
    FORWARD = "forward"
    REVERSE = "reverse"


def dot(coefs: jnp.ndarray, samples: jnp.ndarray):
    """sum_i coefs[i] * samples[i] over min(len) terms (ref execute :159-170)."""
    n = min(coefs.shape[-1], samples.shape[-1])
    return jnp.sum(coefs[..., :n] * samples[..., :n], axis=-1)


def dot_block(coefs: jnp.ndarray, windows: jnp.ndarray):
    """Batched MAC: windows (..., T, n) x coefs (n,) -> (..., T) as matmuls."""
    n = coefs.shape[-1]
    return jnp.matmul(windows[..., :n], coefs, precision="highest")


class DotProduct:
    """Coefficient store with FORWARD/REVERSE direction.

    ``coefficients()`` returns the *stored* order — for REVERSE that is the
    reversed input, matching the reference's quirk that
    ``FIRFilter::coefficients()`` reports reversed taps
    (dot_product/mod.rs:102-109 returns the raw buffer).
    """

    def __init__(self, coefficients, direction: str = Direction.FORWARD, dtype=None):
        c = np.asarray(coefficients)
        if direction == Direction.REVERSE:
            c = c[::-1]
        self._coefs = jnp.asarray(c.copy(), dtype=dtype)
        self.direction = direction

    def coefficients(self) -> jnp.ndarray:
        return self._coefs

    def __len__(self) -> int:
        return int(self._coefs.shape[-1])

    def is_empty(self) -> bool:
        return len(self) == 0

    def execute(self, samples):
        """Single MAC against one sample window (newest-first, as the
        reference's Window::to_vec provides)."""
        return dot(self._coefs, jnp.asarray(samples))

    def execute_block(self, windows):
        """Batched MAC against stacked windows (..., T, n)."""
        return dot_block(self._coefs, jnp.asarray(windows))

    def __repr__(self) -> str:
        return f"DotProduct<{self._coefs.dtype}> [Size={len(self)}]"
