"""MIMO detection and space-time coding.

Multi-antenna TRANSMISSION (the array layer, models/array_proc.py,
covers reception/beamforming of single streams): spatial-multiplexing
detectors for y = H s + n and the classic Alamouti space-time block
code.  The reference library is strictly single-antenna; this extends
the link layer the way array_proc extended analysis.

Formulation: everything is batched small-matrix algebra over the
(time/subcarrier) axis — (..., R, T) channel tensors against (..., R)
observations via einsum/solve, and the ML detector enumerates the
M^T hypothesis constellation as ONE (batch, M^T) distance matmul
(matmul work; M^T is 16-4096 for the practical 2x2/4x4 QPSK/16QAM cases,
a trivially small inner axis).  No per-symbol Python loops anywhere.

Conventions: H[..., r, t] is the complex gain from TX antenna t to RX
antenna r; s entries are drawn from ``constellation`` with unit average
energy; noise_var is per receive antenna (complex total).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["zf_detect", "mmse_detect", "ml_detect", "slice_nearest",
           "alamouti_encode", "alamouti_decode", "mimo_capacity"]


@jax.jit
def zf_detect(H, y):
    """Zero-forcing: s_hat = H^+ y (least squares per batch element).

    H: (..., R, T) with R >= T; y: (..., R).  Returns soft estimates
    (..., T).  Nulls inter-stream interference completely at the cost
    of noise enhancement on ill-conditioned channels.
    """
    H = jnp.asarray(H)
    y = jnp.asarray(y)
    Hh = jnp.conj(jnp.swapaxes(H, -1, -2))
    A = Hh @ H
    b = jnp.einsum("...tr,...r->...t", Hh, y)
    return jnp.linalg.solve(A, b[..., None])[..., 0]


@jax.jit
def mmse_detect(H, y, noise_var=0.0):
    """LMMSE: s_hat = (H^H H + sigma^2 I)^-1 H^H y.

    Trades a small bias for much less noise enhancement than ZF at low
    SNR; equals ZF as noise_var -> 0.
    """
    H = jnp.asarray(H)
    y = jnp.asarray(y)
    T = H.shape[-1]
    Hh = jnp.conj(jnp.swapaxes(H, -1, -2))
    A = Hh @ H + jnp.asarray(noise_var) * jnp.eye(T, dtype=H.dtype)
    b = jnp.einsum("...tr,...r->...t", Hh, y)
    return jnp.linalg.solve(A, b[..., None])[..., 0]


@jax.jit
def slice_nearest(s_soft, constellation):
    """Nearest-point hard decision, returns (indices, points)."""
    s_soft = jnp.asarray(s_soft)
    c = jnp.asarray(constellation)
    d = jnp.abs(s_soft[..., None] - c) ** 2
    idx = jnp.argmin(d, axis=-1)
    return idx, c[idx]


@partial(jax.jit, static_argnames=())
def ml_detect(H, y, constellation):
    """Exact maximum-likelihood joint detection.

    Enumerates all M^T transmit vectors and minimizes ||y - H s||^2 as
    one batched matmul: Hs for every hypothesis is (..., R, M^T) =
    H @ S_all, so the search is a single contraction + argmin.
    Returns (indices (..., T), points (..., T)).  Intended for small
    M^T (2x2 QPSK = 16, 2x2 16QAM = 256, 4x4 QPSK = 256).
    """
    H = jnp.asarray(H)
    y = jnp.asarray(y)
    c = jnp.asarray(constellation)
    M = c.shape[0]
    T = H.shape[-1]
    # hypothesis matrix (T, M^T): column h is the digits of h base M
    grids = jnp.meshgrid(*([jnp.arange(M)] * T), indexing="ij")
    idx_all = jnp.stack([g.reshape(-1) for g in grids])      # (T, M^T)
    S_all = c[idx_all]                                       # (T, M^T)
    Hs = H @ S_all.astype(H.dtype)                           # (..., R, M^T)
    d = jnp.sum(jnp.abs(y[..., :, None] - Hs) ** 2, axis=-2)
    best = jnp.argmin(d, axis=-1)                            # (...,)
    idx = jnp.take(idx_all, best, axis=1)                    # (T, ...)
    idx = jnp.moveaxis(idx, 0, -1)
    return idx, c[idx]


@jax.jit
def alamouti_encode(s):
    """Alamouti 2x1 STBC: symbol pairs -> (2 time slots, 2 TX antennas).

    s: (..., N) with N even.  Returns tx (..., N, 2): slot 2k sends
    [s0, s1], slot 2k+1 sends [-conj(s1), conj(s0)] — the orthogonal
    design that yields full transmit diversity with a linear decoder.
    """
    s = jnp.asarray(s)
    s0 = s[..., 0::2]
    s1 = s[..., 1::2]
    slot0 = jnp.stack([s0, s1], axis=-1)
    slot1 = jnp.stack([-jnp.conj(s1), jnp.conj(s0)], axis=-1)
    tx = jnp.stack([slot0, slot1], axis=-2)        # (..., N/2, 2, 2)
    return tx.reshape(*s.shape[:-1], s.shape[-1], 2)


@jax.jit
def alamouti_decode(y, h):
    """Alamouti combining for a receiver with ONE antenna.

    y: (..., N) received samples (N even, channel constant over each
    pair); h: (..., 2) or (..., N/2, 2) channel from the two TX
    antennas.  Returns (s_hat (..., N), gain (..., N)): the matched-
    filter combination with per-symbol diversity gain |h0|^2 + |h1|^2
    (divide or feed both to a soft demapper).
    """
    y = jnp.asarray(y)
    h = jnp.asarray(h)
    y0 = y[..., 0::2]
    y1 = y[..., 1::2]
    if h.ndim == y.ndim and h.shape[-1] == 2 and h.shape != y0.shape + (2,):
        h = jnp.broadcast_to(h[..., None, :], (*y0.shape, 2))
    h0, h1 = h[..., 0], h[..., 1]
    g = (jnp.abs(h0) ** 2 + jnp.abs(h1) ** 2).astype(y.real.dtype)
    s0 = jnp.conj(h0) * y0 + h1 * jnp.conj(y1)
    s1 = jnp.conj(h1) * y0 - h0 * jnp.conj(y1)
    s_hat = jnp.stack([s0, s1], axis=-1).reshape(*y.shape[:-1],
                                                 y.shape[-1])
    gain = jnp.stack([g, g], axis=-1).reshape(*y.shape[:-1],
                                              y.shape[-1])
    return s_hat, gain


@jax.jit
def mimo_capacity(H, snr):
    """Ergodic MIMO capacity log2 det(I + snr/T * H H^H) in bits/use."""
    H = jnp.asarray(H)
    R, T = H.shape[-2], H.shape[-1]
    G = H @ jnp.conj(jnp.swapaxes(H, -1, -2))
    A = jnp.eye(R, dtype=H.dtype) + (jnp.asarray(snr) / T) * G
    sign, logdet = jnp.linalg.slogdet(A)
    return jnp.real(logdet) / np.log(2.0)
