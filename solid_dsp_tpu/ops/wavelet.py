"""Discrete wavelet transforms: Mallat analysis/synthesis cascades.

Not in the reference (no multiresolution anything); standard DSP kit for
denoising, transient detection, and compression front ends.  Accelerator mapping:
each level is one strided conv pair (the same ``conv1d_mxu`` machinery as
every FIR here) — no gathers, no sequential loops beyond the O(log N)
level cascade.

Orthogonal Daubechies family (haar = db1, db2, db4) with standard
perfect-reconstruction quadrature-mirror relations:
    g[k] = (-1)^k h[L-1-k]        (analysis highpass from lowpass)
Synthesis uses the time-reversed filters; with WHOLE-BLOCK periodic
extension the cascade reconstructs exactly (tests pin PR to 1e-6).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .fir import conv1d_mxu

__all__ = ["wavelet_filters", "dwt", "idwt", "wavedec", "waverec",
           "denoise_soft"]

# orthonormal lowpass decomposition filters
_DB = {
    "haar": np.array([1.0, 1.0]) / np.sqrt(2.0),
    "db2": np.array([0.48296291314469025, 0.836516303737469,
                     0.22414386804185735, -0.12940952255092145]),
    "db4": np.array([0.23037781330885523, 0.7148465705525415,
                     0.6308807679295904, -0.02798376941698385,
                     -0.18703481171888114, 0.030841381835986965,
                     0.032883011666982945, -0.010597401784997278]),
}


def wavelet_filters(name: str):
    """(dec_lo, dec_hi, rec_lo, rec_hi) for an orthogonal wavelet."""
    if name not in _DB:
        raise ValueError(f"unknown wavelet {name!r}; one of {sorted(_DB)}")
    h = _DB[name]
    L = len(h)
    g = ((-1.0) ** np.arange(L)) * h[::-1]
    # orthogonal: reconstruction filters are time-reversed decomposition
    return h, g, h[::-1].copy(), g[::-1].copy()


def _periodic_conv_down(x, taps_np):
    """Periodic (circular) convolution then downsample by 2.

    y[m] = sum_k taps[k] x[(2m + 1 - k) mod N] — the standard (pywt-
    convention) DWT analysis step with periodic extension, as ONE
    stride-2 banded-Toeplitz conv on the wrap-extended signal (not L
    rolls then a ``[1::2]`` stride-2 gather).  With
    o = len(taps) - 2 wrap samples prepended, w[j] = x[(j - o) mod N],

        y[m] = sum_i taps_r[i] w[2m + i],   taps_r = taps[::-1],

    (substituting i = Lt-1-k) — the strided matmul sliding correlation.
    ``taps_np`` stays host-side numpy so the conv banks are
    compile-time constants.
    """
    Lt = len(taps_np)
    o = Lt - 2
    w = jnp.concatenate([x[..., x.shape[-1] - o:], x], axis=-1) if o else x
    tr = jnp.asarray(np.asarray(taps_np)[::-1].copy(), x.dtype)
    return conv1d_mxu(w, tr, stride=2)


def _upsample_periodic_conv(c, taps_np):
    """Zero-stuff by 2 then periodic convolution: the synthesis step.

    y[n] = sum_k taps[k] u[(n - k) mod N2], u = zero-stuffed c.  The
    zero-stuffed stream is never materialized (the old ``.at[::2].set``
    scatter + L rolls): output phases split exactly as

        y[2s]   = sum_j taps[2j]   c[(s - j) mod N]
        y[2s+1] = sum_j taps[2j+1] c[(s - j) mod N]

    — two circular convs on the wrap-extended ``c`` (each a small matmul
    conv), interleaved with one stack+reshape.
    """
    tn = np.asarray(taps_np)
    N = c.shape[-1]
    phases = []
    for par in (0, 1):
        tp = tn[par::2]
        J = len(tp)
        o = J - 1
        w = jnp.concatenate([c[..., N - o:], c], axis=-1) if o else c
        tr = jnp.asarray(tp[::-1].copy(), c.dtype)
        phases.append(conv1d_mxu(w, tr))
    y = jnp.stack(phases, axis=-1)
    return y.reshape(*c.shape[:-1], 2 * N)


@partial(jax.jit, static_argnames=("wavelet",))
def dwt(x, wavelet: str = "db4"):
    """One analysis level: x (..., N even) -> (approx (..., N/2), detail)."""
    h, g, _, _ = wavelet_filters(wavelet)
    return (_periodic_conv_down(x, h[::-1]),
            _periodic_conv_down(x, g[::-1]))


@partial(jax.jit, static_argnames=("wavelet",))
def idwt(ca, cd, wavelet: str = "db4"):
    """Inverse of one level: (approx, detail) -> signal (..., 2*len)."""
    _, _, rl, rh = wavelet_filters(wavelet)
    a = _upsample_periodic_conv(ca, rl[::-1])
    d = _upsample_periodic_conv(cd, rh[::-1])
    L = len(rl)
    # align: circular round-trip group delay is L-2 with the odd-phase
    # (pywt-convention) analysis downsampling
    return jnp.roll(a + d, -(L - 2), axis=-1)


def wavedec(x, wavelet: str = "db4", levels: int = 3):
    """Multi-level analysis: returns [cA_L, cD_L, ..., cD_1]."""
    coeffs = []
    a = jnp.asarray(x)
    for _ in range(levels):
        if a.shape[-1] % 2:
            raise ValueError("signal length must be divisible by 2^levels")
        a, d = dwt(a, wavelet)
        coeffs.append(d)
    coeffs.append(a)
    return coeffs[::-1]


def waverec(coeffs, wavelet: str = "db4"):
    """Inverse of ``wavedec``."""
    a = coeffs[0]
    for d in coeffs[1:]:
        a = idwt(a, d, wavelet)
    return a


def denoise_soft(x, wavelet: str = "db4", levels: int = 3,
                 threshold=None, sigma_samples: int = 65536):
    """Wavelet soft-threshold denoising (VisuShrink default).

    threshold defaults to sigma * sqrt(2 ln N) with sigma estimated from
    the finest detail level's median absolute deviation / 0.6745.  The
    MAD uses at most ``sigma_samples`` detail coefficients (a contiguous
    slice — the noise is iid, so a 64K-sample median estimates sigma to
    well under 1%): a full-length ``jnp.median`` lowers to a full sort,
    which would dominate this function's runtime for multi-million-
    sample blocks.  Pass ``sigma_samples=None`` for the exact
    full-length MAD.
    """
    coeffs = wavedec(x, wavelet, levels)
    d1 = coeffs[-1]
    if threshold is None:
        if sigma_samples is not None and d1.shape[-1] > sigma_samples:
            d1s = d1[..., :sigma_samples]
        else:
            d1s = d1
        sigma = jnp.median(jnp.abs(d1s), axis=-1, keepdims=True) / 0.6745
        threshold = sigma * np.sqrt(2.0 * np.log(x.shape[-1]))
    thr = jnp.asarray(threshold)
    out = [coeffs[0]]
    for d in coeffs[1:]:
        out.append(jnp.sign(d) * jnp.maximum(jnp.abs(d) - thr, 0.0))
    return waverec(out, wavelet)
