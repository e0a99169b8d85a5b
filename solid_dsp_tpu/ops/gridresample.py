"""Jittable arbitrary-ratio resampling grid: exact fixed-point positions.

The host-anchored resamplers (ops/farrow.py, ops/resample.py) compute
output positions on the HOST in f64 per block — correct, but it makes
``execute_block`` un-jittable and host-coupled.  This module makes the position stream a pure device
computation in int32 with ZERO drift:

* the ratio is quantized once at build time to ``R / 2**FB`` (FB = 20:
  relative quantization <= 2**-21, i.e. < 0.5 ppm of sample-clock —
  far below real SDR clock tolerances).  That quantized ratio IS the
  contract: positions follow it exactly forever (bit-reproducible,
  block-size invariant), unlike float accumulation.
* output k sits at fixed-point position t_k = t0 + k*R.  Computing k*R
  directly would overflow int32 (k up to 2^26, R up to 2^25), so k is
  split into 10-bit digits with host-precomputed carry/residue pairs of
  R<<10 and R<<20 — every intermediate stays < 2^31 (see _positions).
* the carried state is ONE int32 scalar t0 in [0, R): the block update
  t0' = t0 - r0 + (t0 < r0)*R and the valid-output count
  n_valid = q0 + (t0 < r0) are exact by construction
  (q0, r0 = divmod(L << FB, R) on the host).

Downstream engines turn (base, mu) into windows x taps; see
ops/farrow.py / ops/resample.py for the consumers.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np

__all__ = ["FB", "GridPlan", "plan_ratio", "grid_positions",
           "grid_n_valid", "grid_advance"]

FB = 20
_MASK = (1 << FB) - 1


@dataclass(frozen=True)
class GridPlan:
    """Host-side constants for one quantized ratio and block length."""

    R: int               # round(ratio * 2^FB)
    L: int               # input block length (samples)
    q0: int              # (L << FB) // R  — min outputs per block
    r0: int              # (L << FB) % R
    # per-digit carry/residue of R << (10*level), level = 0, 1, 2
    C: tuple
    D: tuple

    @property
    def ratio(self) -> float:
        """The exact ratio this plan resamples by (R / 2^FB)."""
        return self.R / float(1 << FB)

    @property
    def n_pad(self) -> int:
        """Static output-buffer size (max n_valid)."""
        return self.q0 + 1


def plan_ratio(ratio: float, L: int) -> GridPlan:
    """Quantize ``ratio`` (input samples per output) for blocks of L.

    Valid for ratio in [1/16, 32] and L <= 2^24 (int32 headroom — see
    module docstring); callers outside that envelope keep the legacy
    host-anchor path.
    """
    if not (1.0 / 16.0 <= ratio <= 32.0):
        raise ValueError("plan_ratio supports ratio in [1/16, 32]")
    if not (0 < L <= 1 << 24):
        raise ValueError("plan_ratio supports L <= 2^24")
    R = int(round(ratio * (1 << FB)))
    if R <= 0:
        raise ValueError("ratio too small")
    q0, r0 = divmod(L << FB, R)
    C = tuple((R << (10 * lv)) >> FB for lv in range(3))
    D = tuple((R << (10 * lv)) & _MASK for lv in range(3))
    return GridPlan(R=R, L=int(L), q0=int(q0), r0=int(r0), C=C, D=D)


def grid_positions(plan: GridPlan, t0, n: int):
    """(base (n,), mu (n,)) int32/f32 positions t_k = t0 + k*R, exact.

    base = floor(t_k * 2^-FB) in input-sample units; mu in [0, 1).
    ``t0`` is the carried int32 scalar.  All arithmetic int32-safe:
    each digit product k_l * D_l < 2^30, reduced mod 2^FB before
    summation; the carry products are bounded by the final base <= L.
    """
    k = jnp.arange(n, dtype=jnp.int32)
    k0 = k & 1023
    k1 = (k >> 10) & 1023
    k2 = k >> 20
    e0 = k0 * np.int32(plan.D[0])
    e1 = k1 * np.int32(plan.D[1])
    e2 = k2 * np.int32(plan.D[2])
    lo_sum = ((t0 & _MASK) + (e0 & _MASK) + (e1 & _MASK) + (e2 & _MASK))
    base = ((t0 >> FB) + k0 * np.int32(plan.C[0]) + k1 * np.int32(plan.C[1])
            + k2 * np.int32(plan.C[2]) + (e0 >> FB) + (e1 >> FB)
            + (e2 >> FB) + (lo_sum >> FB))
    mu = (lo_sum & _MASK).astype(jnp.float32) * np.float32(2.0 ** -FB)
    return base.astype(jnp.int32), mu


def grid_n_valid(plan: GridPlan, t0):
    """Number of outputs this block (q0 or q0+1), as a traced int32."""
    return jnp.int32(plan.q0) + (t0 < plan.r0).astype(jnp.int32)


def grid_advance(plan: GridPlan, t0):
    """Next block's carried phase t0' in [0, R) (exact)."""
    b = (t0 < plan.r0).astype(jnp.int32)
    return t0 - jnp.int32(plan.r0) + b * jnp.int32(plan.R)
