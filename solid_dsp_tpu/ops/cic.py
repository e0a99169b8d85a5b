"""CIC (cascaded integrator-comb) decimators / interpolators.

The workhorse first-stage rate changer of every digital front end
(multiplier-free in hardware); absent from the reference.  A CIC with N
stages, rate R, and differential delay M is EXACTLY the moving-average
FIR ``boxcar(RM) ** (*N)`` (N-fold self-convolution) followed (preceded)
by the rate change, so this implementation runs the equivalent FIR on
the conv path:

* identical output to the integrator->decimate->comb form, but with NO
  unbounded accumulators — the textbook structure relies on two's-
  complement wraparound, which floats cannot reproduce over long streams;
* the decimating form reuses ``fir_decim_apply`` (strided conv +
  phase carry), the interpolating form zero-stuffs and convolves.

DC gain is (RM)^N (decimator) / (RM)^N / R (interpolator after the 1/R
stuffing loss); ``normalize=True`` (default) scales it out.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from . import fir as fir_ops
from ..utils.transfer import zeros_device, zeros_like_device

__all__ = ["cic_kernel", "cic_frequency_response", "CICDecimator",
           "CICInterpolator"]


def cic_kernel(rate: int, stages: int, diff_delay: int = 1) -> np.ndarray:
    """Equivalent-FIR taps: boxcar(rate*diff_delay) self-convolved
    ``stages`` times; length N*(RM-1)+1, DC gain (RM)^N."""
    if rate < 1 or stages < 1 or diff_delay < 1:
        raise ValueError("rate, stages, diff_delay must be >= 1")
    box = np.ones(rate * diff_delay, dtype=np.float64)
    h = box
    for _ in range(stages - 1):
        h = np.convolve(h, box)
    return h


def cic_frequency_response(f, rate: int, stages: int,
                           diff_delay: int = 1) -> np.ndarray:
    """|H| of the CIC at normalized input-rate frequency f (cycles/sample):
    H(f) = (sin(pi f R M) / sin(pi f))^N, with the f->0 limit (RM)^N."""
    f = np.asarray(f, dtype=np.float64)
    rm = rate * diff_delay
    num = np.sin(np.pi * f * rm)
    den = np.sin(np.pi * f)
    with np.errstate(divide="ignore", invalid="ignore"):
        h = np.where(np.abs(den) < 1e-12, float(rm), num / den)
    return np.abs(h) ** stages


class CICDecimator:
    """N-stage CIC decimator by R (block-functional, streaming)."""

    def __init__(self, rate: int, stages: int = 4, diff_delay: int = 1,
                 normalize: bool = True, dtype=jnp.complex64):
        self.R = int(rate)
        self.N = int(stages)
        self.M = int(diff_delay)
        h = cic_kernel(self.R, self.N, self.M)
        self.scale = float(1.0 / np.sum(h)) if normalize else 1.0
        self._taps = jnp.asarray(h, dtype)
        self._tail = fir_ops.fir_init(len(h), dtype)
        self._phase = jnp.int32(0)

    def execute_block(self, x):
        x = jnp.asarray(x, self._taps.dtype)
        y, self._tail, self._phase = fir_ops.fir_decim_apply(
            self._taps, self._tail, self._phase, x,
            jnp.asarray(self.scale, self._taps.dtype), self.R)
        return y

    def reset(self):
        self._tail = fir_ops.fir_init(self._taps.shape[-1],
                                      self._taps.dtype)
        self._phase = jnp.int32(0)

    def frequency_response(self, f: float) -> float:
        return float(cic_frequency_response(f, self.R, self.N, self.M)
                     * self.scale)

    def __repr__(self):
        return f"CICDecimator [R={self.R}] [N={self.N}] [M={self.M}]"


from functools import partial

import jax


@partial(jax.jit, static_argnames=("rate",))
def _cic_interp_block(x, tail, taps, scale, rate: int):
    """Zero-stuff + boxcar^N conv as ONE dispatch, not one per op."""
    up = jnp.zeros(x.shape[-1] * rate, x.dtype)
    up = up.at[::rate].set(x)
    ext = jnp.concatenate([tail, up])
    y = fir_ops.conv1d_mxu(ext, taps) * scale
    return y, ext[-(taps.shape[-1] - 1):]


class CICInterpolator:
    """N-stage CIC interpolator by R: zero-stuff then the boxcar^N FIR."""

    def __init__(self, rate: int, stages: int = 4, diff_delay: int = 1,
                 normalize: bool = True, dtype=jnp.complex64):
        self.R = int(rate)
        self.N = int(stages)
        self.M = int(diff_delay)
        h = cic_kernel(self.R, self.N, self.M)
        # zero-stuffing keeps 1 of R samples: normalize to unity DC gain
        # at the output rate (sum(h)/R is the effective DC gain)
        self.scale = float(self.R / np.sum(h)) if normalize else 1.0
        self._taps = jnp.asarray(h, dtype)
        self._tail = zeros_device(len(h) - 1, dtype)

    def execute_block(self, x):
        x = jnp.asarray(x, self._taps.dtype)
        y, self._tail = _cic_interp_block(x, self._tail, self._taps,
                                          jnp.asarray(self.scale,
                                                      self._taps.dtype),
                                          self.R)
        return y

    def reset(self):
        self._tail = zeros_like_device(self._tail)

    def frequency_response(self, f: float) -> float:
        return float(cic_frequency_response(f, self.R, self.N, self.M)
                     * self.scale)

    def __repr__(self):
        return f"CICInterpolator [R={self.R}] [N={self.N}] [M={self.M}]"
