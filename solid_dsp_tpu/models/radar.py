"""Pulse-compression radar kit: LFM chirps, matched filtering, CA-CFAR,
range-Doppler maps.

Outside the reference's scope (communications only) but squarely in this
framework's: detection/estimation over IQ streams, built from the same
conv + batched FFT machinery.  A coherent processing interval (CPI)
is an (n_pulses, n_range) matrix; everything batches.

* ``lfm_chirp`` — linear-FM pulse, the standard compression waveform.
* ``pulse_compress`` — matched filter (correlation with the conjugate
  pulse) via conv1d_mxu; processing gain = 10 log10(pulse length).
* ``range_doppler_map`` — slow-time windowed FFT across pulses.
* ``cfar_ca`` — cell-averaging CFAR along the last axis: the noise level
  per cell is the mean of ``train`` cells each side (after ``guard``
  cells), via ONE cumulative-sum sliding window (gather-free); the
  threshold multiplier alpha = 2T (Pfa^(-1/2T) - 1) is exact for
  exponentially-distributed noise power.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.fir import conv1d_mxu

__all__ = ["lfm_chirp", "pulse_compress", "range_doppler_map", "cfar_ca",
           "cfar_threshold_factor"]


def lfm_chirp(n: int, bandwidth: float = 0.8) -> np.ndarray:
    """Unit-amplitude linear-FM pulse sweeping ``bandwidth`` of the
    sample rate, centered on 0 (from -bw/2 to +bw/2 cycles/sample)."""
    t = np.arange(n, dtype=np.float64)
    phase = np.pi * bandwidth * (t * t / n - t)
    return np.exp(1j * phase).astype(np.complex64)


@jax.jit
def pulse_compress(x, pulse):
    """Matched filter: y[t] = sum_k conj(pulse[k]) x[t + k] (valid part
    zero-padded back to len(x) at the tail) — range profile per pulse."""
    x = jnp.asarray(x)
    p = jnp.conj(jnp.asarray(pulse)).astype(x.dtype)
    y = conv1d_mxu(x, p)
    pad = x.shape[-1] - y.shape[-1]
    if pad > 0:
        y = jnp.concatenate(
            [y, jnp.zeros((*y.shape[:-1], pad), y.dtype)], axis=-1)
    return y


@partial(jax.jit, static_argnames=("window",))
def range_doppler_map(X, window: str = "hann"):
    """(n_pulses, n_range) compressed CPI -> (n_pulses, n_range) power map
    with the Doppler (slow-time) FFT centered (fftshift along axis 0)."""
    X = jnp.asarray(X)
    n_pulses = X.shape[-2]
    if window == "rect":
        w = np.ones(n_pulses)
    elif window == "hann":
        w = np.hanning(n_pulses)
    else:
        raise ValueError(f"unknown window {window!r}")
    Xw = X * jnp.asarray(w, X.real.dtype)[..., :, None].astype(X.dtype)
    D = jnp.fft.fftshift(jnp.fft.fft(Xw, axis=-2), axes=-2)
    return jnp.real(D * jnp.conj(D))


def cfar_threshold_factor(pfa: float, n_train: int) -> float:
    """Exact CA-CFAR multiplier for exponential noise power:
    alpha = N (Pfa^(-1/N) - 1), N = total training cells."""
    return float(n_train * (pfa ** (-1.0 / n_train) - 1.0))


@partial(jax.jit, static_argnames=("guard", "train"))
def cfar_ca(power, guard: int = 2, train: int = 8, pfa: float = 1e-4):
    """Cell-averaging CFAR along the last axis.

    power: (..., N) nonnegative detector input (|y|^2).  Returns
    (detections bool (..., N), threshold (..., N)).  Edge cells with an
    incomplete training window fall back to the one-sided mean.
    """
    p = jnp.asarray(power)
    N = p.shape[-1]
    c = jnp.cumsum(p, axis=-1)
    zero = jnp.zeros((*p.shape[:-1], 1), p.dtype)
    c = jnp.concatenate([zero, c], axis=-1)          # c[i] = sum p[:i]

    # gather-free windowed sums: c[clip(i + off, 0, N)] is a STATIC slice
    # of c edge-padded by F on each side (front pads = c[0] = 0, tail
    # pads = c[N] = total), because off is a compile-time constant.
    F = guard + train + 1
    cp = jnp.concatenate(
        [jnp.zeros((*p.shape[:-1], F), p.dtype), c,
         jnp.broadcast_to(c[..., -1:], (*p.shape[:-1], F))], axis=-1)

    def at(off):
        """c[clip(i + off, 0, N)] for i = 0..N-1, as one static slice."""
        return cp[..., F + off: F + off + N]

    left_sum = at(-guard) - at(-guard - train)
    right_sum = at(1 + guard + train) - at(1 + guard)
    total = left_sum + right_sum
    # training-cell counts per position are trace-time numpy constants
    i = np.arange(N)
    left_n = np.clip(i - guard, 0, N) - np.clip(i - guard - train, 0, N)
    right_n = (np.clip(i + 1 + guard + train, 0, N)
               - np.clip(i + 1 + guard, 0, N))
    count = np.maximum(left_n + right_n, 1).astype(np.float64)
    noise = total / jnp.asarray(count, p.dtype)
    # per-cell exact multiplier for the actual training-cell count
    alpha = count * (pfa ** (-1.0 / count) - 1.0)
    thr = jnp.asarray(alpha, p.dtype) * noise
    return p > thr, thr
