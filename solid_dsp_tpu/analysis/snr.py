"""Signal-quality estimation: blind SNR, EVM, noise floor, tone SNR.

The reference exposes RSSI via the AGC (auto_gain_control/mod.rs:442-444)
but has no SNR/quality estimation; every real receiver needs it for link
adaptation and monitoring.  All estimators are one-pass block reductions
(elementwise work, shardable with a final psum).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["snr_m2m4", "evm", "noise_floor", "tone_snr"]


@partial(jax.jit, static_argnames=("kurtosis",))
def snr_m2m4(x: jnp.ndarray, kurtosis: float = 1.0) -> jnp.ndarray:
    """Blind M2M4 moment SNR estimate (linear ratio) for a modulated signal
    in complex AWGN — no training symbols or decisions needed.

    With S the signal and N the noise power:
      M2 = E|x|^2 = S + N
      M4 = E|x|^4 = ka S^2 + 4 S N + 2 N^2,
    where ka = E|s|^4 / (E|s|^2)^2 is the signal kurtosis (1.0 for any
    constant-modulus constellation — PSK/GMSK; 1.32 for 16-QAM).
    Substituting N = M2 - S collapses to (ka - 2) S^2 = M4 - 2 M2^2, so

        S = sqrt( (M4 - 2 M2^2) / (ka - 2) ),   N = M2 - S

    (ka = 1 gives the classic S = sqrt(2 M2^2 - M4); ka = 2, a Gaussian
    signal, is inherently unidentifiable by moments and is rejected).
    Returns S/N clamped to >= 0; convert with 10*log10.
    """
    ka = float(kurtosis)
    if abs(ka - 2.0) < 1e-9:
        raise ValueError("kurtosis 2.0 (Gaussian-like signal) is not "
                         "identifiable by the M2M4 estimator")
    ax2 = jnp.real(x * jnp.conj(x))
    m2 = jnp.mean(ax2, axis=-1)
    m4 = jnp.mean(ax2 * ax2, axis=-1)
    s = jnp.sqrt(jnp.maximum((m4 - 2.0 * m2 * m2) / (ka - 2.0), 0.0))
    n = jnp.maximum(m2 - s, 1e-30)
    return jnp.maximum(s, 0.0) / n


@jax.jit
def evm(y: jnp.ndarray, ref: jnp.ndarray) -> jnp.ndarray:
    """RMS error-vector magnitude of received symbols vs reference symbols
    (same shape), normalized by the reference RMS power.  Returns the
    linear fraction; percent = 100*evm, dB = 20*log10(evm).
    For AWGN at SNR rho, EVM -> 1/sqrt(rho)."""
    e = y - ref.astype(y.dtype)
    num = jnp.mean(jnp.real(e * jnp.conj(e)), axis=-1)
    den = jnp.maximum(jnp.mean(jnp.real(ref * jnp.conj(ref)), axis=-1), 1e-30)
    return jnp.sqrt(num / den)


@partial(jax.jit, static_argnames=("averages",))
def noise_floor(psd: jnp.ndarray, averages: int = 0) -> jnp.ndarray:
    """Robust noise-floor estimate from a PSD: the median bin power
    (immune to narrowband signals occupying < half the bins).

    ``averages`` = number of periodograms averaged into the PSD, used to
    correct the chi-square median bias: a single periodogram's bins are
    exponential (median = ln 2 * mean); with F averages the bias shrinks
    as the Wilson-Hilferty (1 - 1/(9F))^3.  ``averages=0`` (default)
    means "well-averaged" — no correction, median ~= mean, which is the
    right call for a long Welch PSD.
    """
    med = jnp.median(jnp.real(psd), axis=-1)
    if averages <= 0:
        return med
    if averages == 1:
        return med / float(np.log(2.0))
    return med / float((1.0 - 1.0 / (9.0 * averages)) ** 3)


@partial(jax.jit, static_argnames=("guard",))
def tone_snr(x: jnp.ndarray, guard: int = 2) -> tuple:
    """SNR of the strongest tone in a block: peak FFT bin (plus ``guard``
    bins each side) vs the noise floor estimated from the remaining bins.

    Returns (snr_linear, freq_cycles_per_sample).  Windowless periodogram:
    best for a tone near a bin center; for arbitrary frequencies feed a
    windowed block and accept the scalloping bound.
    """
    n = x.shape[-1]
    X = jnp.fft.fft(x, axis=-1)
    p = jnp.real(X * jnp.conj(X))
    k0 = jnp.argmax(p, axis=-1)
    idx = jnp.arange(n)
    d = jnp.abs((idx - k0 + n // 2) % n - n // 2)
    in_peak = d <= guard
    sig = jnp.sum(jnp.where(in_peak, p, 0.0), axis=-1)
    # robust floor from the non-peak bins (median, exponential-bias corrected)
    rest = jnp.where(in_peak, jnp.nan, p)
    floor = jnp.nanmedian(rest, axis=-1) / float(np.log(2.0))
    noise_total = floor * n
    snr = jnp.maximum(sig - floor * (2 * guard + 1), 0.0) / \
        jnp.maximum(noise_total, 1e-30)
    freq = k0.astype(jnp.float32) / n
    freq = jnp.where(freq > 0.5, freq - 1.0, freq)
    return snr, freq
