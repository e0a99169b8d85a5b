"""Halfband filters and multistage power-of-two resampling.

The classic efficient rate-conversion architecture the reference lacks
(its only decimator runs the full filter at the input rate,
src/filter/fir/decim.rs:221-228): a halfband lowpass has every second tap
zero (except the 0.5 center), so a decimate-by-2 stage costs half the
taps — and a decimate-by-2^k cascade runs each successive stage at half
the rate with a *wider* transition band (fewer taps) in the early stages.

Formulation: each stage is one strided conv on the even input phase
plus a strided slice for the center tap (the odd phase) — the zero taps
are never multiplied, unlike naively feeding the full halfband response
to a stride-2 conv.

Block-functional `(state, x) -> (y, state)` like every filter here.
"""

from __future__ import annotations

import jax
import numpy as np
import jax.numpy as jnp

from .fir import conv1d_mxu, fir_init
from ..design.firdes import estimate_required_filter_length, firdes_kaiser
from ..utils.transfer import (astype_device, ingest, zeros_device,
                              zeros_like_device)

__all__ = [
    "firdes_halfband",
    "halfband_decimate",
    "HalfbandDecimator",
    "MultistageDecimator",
]


def firdes_halfband(semi_length: int, stop_band_attenuation: float = 60.0
                    ) -> np.ndarray:
    """Kaiser-windowed halfband lowpass, length 4*semi_length - 1.

    Cutoff is exactly 0.25: the windowed sinc has zeros at all even
    offsets from center, giving h[center] = 0.5 and h[center +- even] = 0
    (enforced exactly).  Transition narrows as semi_length grows.
    """
    if semi_length < 1:
        raise ValueError("semi_length must be >= 1")
    n = 4 * semi_length - 1
    h = firdes_kaiser(n, 0.25, stop_band_attenuation, 0.0)
    c = (n - 1) // 2
    # exact halfband structure (the sinc already gives ~0 there)
    idx = np.arange(n)
    h = np.where((idx != c) & ((idx - c) % 2 == 0), 0.0, h)
    h = h / h.sum()  # unit DC gain; h[c] becomes exactly 0.5 by symmetry
    return h


def halfband_decimate(taps, tail, x):
    """Decimate-by-2 with a halfband filter.

    y[k] = sum_i h[i] x_ext[2k + i]  (odd-index taps other than the
    center are exactly zero, so the dense form equals the phase-split
    identity in the module docstring bit-for-bit up to summation order).

    ONE stride-2 banded-Toeplitz conv (:func:`conv1d_mxu`) instead of an
    even/odd phase split, which would extract ``x_ext[0::2]`` with a
    stride-2 gather; the dense strided matmul spends 2x the MACs to keep
    memory traffic at O(L) with zero gathers.  len(x) must be even.
    Returns (y, new_tail).
    """
    n = taps.shape[-1]
    L = x.shape[-1]
    if L % 2:
        raise ValueError("block length must be even")
    x_ext = jnp.concatenate([tail, x], axis=-1)
    y = conv1d_mxu(x_ext, taps, stride=2)
    new_tail = x_ext[..., -(n - 1):]
    return y, new_tail


class HalfbandDecimator:
    """Stateful decimate-by-2 stage (streaming, carried tail)."""

    def __init__(self, semi_length: int = 8,
                 stop_band_attenuation: float = 60.0, dtype=jnp.complex64):
        self.taps_np = firdes_halfband(semi_length, stop_band_attenuation)
        self._taps = jnp.asarray(self.taps_np, jnp.float32)
        self._tail = fir_init(len(self.taps_np), dtype=dtype)
        # ONE jitted dispatch per block, taps as a host-side closure
        # constant (compile-time-constant Toeplitz banks; a device-array
        # tap argument would trace the bloated traced-bank fallback)
        tn = self.taps_np.astype(np.float32)
        self._run = jax.jit(
            lambda tail, x: halfband_decimate(jnp.asarray(tn), tail, x))

    def execute_block(self, x):
        x = ingest(x)
        if not jnp.issubdtype(self._tail.dtype, x.dtype):
            self._tail = astype_device(
                self._tail, jnp.result_type(self._tail.dtype, x.dtype))
        y, self._tail = self._run(self._tail, x)
        return y

    def reset(self):
        self._tail = zeros_like_device(self._tail)


def _halfband_stage_semilen(fpass_out: float, stages_after: int,
                            as_db: float) -> int:
    """Semi-length for one halfband stage.

    The passband edge seen by this stage, normalized to ITS input rate, is
    fpass_out / 2**(stages_after + 1); aliasing onto the passband comes
    from above (0.5 - fpass_stage), so the symmetric halfband transition
    width is 0.5 - 2*fpass_stage.  Early stages get wide transitions and
    tiny filters — the whole point of the cascade.
    """
    fpass_stage = fpass_out / (2.0 ** (stages_after + 1))
    df = 0.5 - 2.0 * fpass_stage
    n = estimate_required_filter_length(max(min(df, 0.45), 0.05), as_db)
    return max(1, int(np.ceil((n + 1) / 4.0)))


class MultistageDecimator:
    """Decimate by R = 2^k [* r] via a halfband cascade (+ optional final
    general FIR stage for a residual odd factor).

    ``fpass`` is the passband edge as a fraction of the OUTPUT sample
    rate (< 0.5); everything above folds with >= stop_band_attenuation dB
    suppression.
    """

    def __init__(self, decimation: int, fpass: float = 0.4,
                 stop_band_attenuation: float = 60.0, dtype=jnp.complex64):
        if decimation < 2:
            raise ValueError("decimation must be >= 2")
        if not (0.0 < fpass < 0.5):
            raise ValueError("fpass in (0, 0.5) of the output rate")
        R = int(decimation)
        k = 0
        while R % 2 == 0:
            R //= 2
            k += 1
        self.n_halfband = k
        self.residual = R  # odd residual factor (1 = none)
        self.decimation = int(decimation)
        self.stages = []
        for s in range(k):
            stages_after = (k - 1 - s)
            # residual stage (if any) tightens what the last halfband sees
            eff_after = stages_after + (0 if R == 1 else np.log2(R))
            m = _halfband_stage_semilen(fpass, float(eff_after),
                                        stop_band_attenuation)
            self.stages.append(HalfbandDecimator(
                m, stop_band_attenuation, dtype=dtype))
        if R > 1:
            from .fir import DecimatingFIRFilter
            # input-rate units: passband fpass/R, stopband (1-fpass)/R,
            # cutoff at the midpoint 1/(2R)
            df = (1.0 - 2.0 * fpass) / R
            n = estimate_required_filter_length(max(min(df, 0.45), 0.01),
                                                stop_band_attenuation)
            taps = firdes_kaiser(int(n) | 1, 0.5 / R,
                                 stop_band_attenuation, 0.0)
            taps = taps / taps.sum()
            self.final = DecimatingFIRFilter(taps, 1.0, R, dtype=dtype)
        else:
            self.final = None

    def execute_block(self, x):
        y = jnp.asarray(x)
        for st in self.stages:
            y = st.execute_block(y)
        if self.final is not None:
            y = self.final.execute_block(y)
        return y

    def reset(self):
        for st in self.stages:
            st.reset()
        if self.final is not None:
            self.final._tail = zeros_like_device(self.final._tail)

    @property
    def total_taps(self) -> int:
        """Nonzero multiplies per output structure (cost metric)."""
        n = sum(int(np.count_nonzero(s.taps_np)) for s in self.stages)
        if self.final is not None:
            n += int(self.final._taps.shape[-1])
        return n
