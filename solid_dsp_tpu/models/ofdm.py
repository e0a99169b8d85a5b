"""CP-OFDM modem: modulation, Schmidl-Cox sync, CFO correction, one-tap EQ.

New capability rounding out the modem layer (reference has none): OFDM is
the most accelerator-natural waveform — modulation is one batched IFFT, demodulation
one batched FFT, equalization one elementwise multiply; the only sequential
logic (frame sync) is a sliding correlation computed with the same
``conv1d_mxu``/cumsum machinery as everything else.

Conventions: ``nfft`` subcarriers, ``n_active`` centered around DC (DC
unused), cyclic prefix ``cp`` samples, unit-average-power time signal.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.fir import conv1d_mxu

__all__ = [
    "active_carrier_indices",
    "ofdm_modulate",
    "ofdm_demodulate",
    "schmidl_cox_preamble",
    "schmidl_cox_metric",
    "schmidl_cox_sync",
    "estimate_channel",
    "equalize",
]


def active_carrier_indices(nfft: int, n_active: int) -> np.ndarray:
    """FFT-bin indices of the n_active used subcarriers (centered, no DC)."""
    if n_active >= nfft or n_active % 2:
        raise ValueError("n_active must be even and < nfft")
    half = n_active // 2
    return np.concatenate([np.arange(1, half + 1),            # +1 .. +half
                           np.arange(nfft - half, nfft)])     # -half .. -1


@partial(jax.jit, static_argnames=("nfft", "cp", "n_active"))
def ofdm_modulate(symbols, nfft: int, cp: int, n_active: int):
    """Frequency-domain symbols (..., T, n_active) -> serialized time stream
    (..., T*(nfft+cp)) with cyclic prefix, unit average power."""
    idx = active_carrier_indices(nfft, n_active)
    X = jnp.zeros((*symbols.shape[:-1], nfft), symbols.dtype)
    X = X.at[..., idx].set(symbols)
    x = jnp.fft.ifft(X, axis=-1) * (nfft / np.sqrt(n_active))
    x = jnp.concatenate([x[..., nfft - cp:], x], axis=-1)  # prepend CP
    return x.reshape(*x.shape[:-2], -1)


@partial(jax.jit, static_argnames=("nfft", "cp", "n_active"))
def ofdm_demodulate(x, nfft: int, cp: int, n_active: int):
    """Serialized symbol-aligned stream -> frequency-domain symbols.

    x: (..., T*(nfft+cp)) starting exactly at a symbol boundary.
    """
    sym_len = nfft + cp
    T = x.shape[-1] // sym_len
    blocks = x[..., : T * sym_len].reshape(*x.shape[:-1], T, sym_len)
    body = blocks[..., cp:]
    X = jnp.fft.fft(body, axis=-1) * (np.sqrt(n_active) / nfft)
    idx = active_carrier_indices(nfft, n_active)
    return X[..., idx]


def schmidl_cox_preamble(nfft: int, cp: int, seed: int = 7) -> np.ndarray:
    """Preamble with two identical time halves: QPSK on EVEN carriers only.

    Unit average power (ifft of N_even unit carriers has power
    N_even / nfft^2, so the scale is nfft / sqrt(N_even)) — the preamble
    must not be transmitted below the payload or sync fails first.
    """
    rng = np.random.default_rng(seed)
    X = np.zeros(nfft, np.complex128)
    even = np.arange(2, nfft, 2)
    X[even] = np.exp(1j * 0.5 * np.pi * rng.integers(0, 4, len(even)))
    x = np.fft.ifft(X) * (nfft / np.sqrt(len(even)))
    return np.concatenate([x[nfft - cp:], x]).astype(np.complex64)


@partial(jax.jit, static_argnames=("nfft",))
def schmidl_cox_metric(x, nfft: int):
    """Sliding Schmidl-Cox timing metric M(d) = |P(d)|^2 / R(d)^2 with
    P(d) = sum_m conj(x[d+m]) x[d+m+N/2], R(d) = energy of the second half.

    Both moving sums are ones-kernel convs (O(L), matmul).  Returns (M, P).
    """
    half = nfft // 2
    prod = jnp.conj(x[..., :-half]) * x[..., half:]
    ones = jnp.ones(half, jnp.float32)
    P = conv1d_mxu(prod, ones)
    e2 = jnp.abs(x[..., half:]) ** 2
    R = conv1d_mxu(e2, ones)
    # gate on meaningful energy: dead air has R -> 0 and the normalized
    # ratio blows up on numerical noise there
    floor = 0.25 * jnp.mean(R, axis=-1, keepdims=True)
    M = jnp.where(R > floor,
                  jnp.abs(P) ** 2 / jnp.maximum(R * R, 1e-12), 0.0)
    return M, P


@partial(jax.jit, static_argnames=("nfft", "cp"))
def schmidl_cox_sync(x, nfft: int, cp: int):
    """Locate the preamble and estimate the carrier-frequency offset.

    Returns (start, cfo) where ``start`` indexes the first sample of the
    preamble's BODY (after its CP) and ``cfo`` is in cycles/sample.  The
    S&C metric has a CP-long plateau; taking the midpoint of the
    above-90%-of-peak region centers the estimate.
    """
    M, P = schmidl_cox_metric(x, nfft)
    # Take the plateau midpoint in a +-nfft window around the global argmax
    # only — a far-away high-metric region (another frame's preamble) must
    # not drag the mean.  NOTE: plain S&C scores any constant-envelope
    # narrowband segment near 1 (the metric is self-normalized); in CW-heavy
    # environments gate the input on the |P| energy ridge first.
    d_star = jnp.argmax(M, axis=-1)
    peak = jnp.take_along_axis(M, d_star[..., None], axis=-1)
    idxs = jnp.arange(M.shape[-1])
    above = (M > 0.9 * peak) & (jnp.abs(idxs - d_star[..., None]) <= nfft)
    mid = (jnp.sum(jnp.where(above, idxs, 0), axis=-1)
           / jnp.maximum(jnp.sum(above, axis=-1), 1))
    start = mid.astype(jnp.int32)
    Pd = jnp.take_along_axis(P, start[..., None], axis=-1)[..., 0]
    cfo = jnp.angle(Pd) / (jnp.pi * nfft)
    return start + cp // 2, cfo


@partial(jax.jit, static_argnames=())
def estimate_channel(rx_pilot, tx_pilot):
    """One-shot least-squares channel estimate per active carrier."""
    return rx_pilot / tx_pilot


@partial(jax.jit, static_argnames=())
def equalize(symbols, H):
    """One-tap zero-forcing equalization."""
    return symbols / H
