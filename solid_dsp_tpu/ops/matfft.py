"""Batched DFT as planar matmuls (Bailey 4-step / 6-step).

An alternative to ``jnp.fft`` (``fft(..., backend="matmul")``): a DFT of
composite size N = N1*N2 is two batched
matmuls against small DFT matrices plus one twiddle pass and one
transpose:

    x[n1*N2 + n2]  --(contract n1 with F_N1)-->  B[n2, k1]
    C = B * W_N^(n2*k1)                          (elementwise twiddle)
    C  --(DFT over n2, direct or recursive)-->   D[k1, k2]
    X[k1 + N1*k2] = D[k1, k2]                    (transpose + flatten)

For frames of 256-16384 points (spectrogram/Welch, channelizer output
DFTs, OFDM symbols) the matmul FLOPs (8*N*(N1+N2) per transform) stay
small next to the bytes each transform moves.

Everything is planar real arithmetic: complex64 is interleaved in
device memory, and planar planes avoid strided de-interleave passes and
complex dot lowerings.  Complex matrix
products use the same ``[Re | Im]`` block-column bank trick as
``ops.fir.fir_toeplitz``: one real dot per input plane against a
(n, 2k) bank, then a fused combine of four contiguous block slices.

Reference seed: the reference's generic DFT executor is one DotProduct
per output bin (fft/dft/mod.rs:120-132); this module is that same
matrix-times-signal formulation done matmul-style — whole DFT matrices,
batched, recursive over the Cooley-Tukey split the reference's
mixed-radix plan performs pointer-chasing style (fft/mixed_radix/
mod.rs:87-130).
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from .fir import _resolve_precision

# Largest size handled by a single direct matmul (bank is n x 2n floats:
# 256 -> 512 KB f32).  Above this the size is
# split recursively.
DIRECT_MAX = 256


@lru_cache(maxsize=512)
def _dft_bank_np(n: int, sign: int, dtype: str):
    """(n, 2n) real bank [Re F | Im F] of the unnormalized DFT matrix
    F[j, k] = exp(sign * 2i*pi*j*k / n), built in float64."""
    j = np.arange(n, dtype=np.int64)
    # exact integer phase reduction mod n keeps large-n precision
    ph = (j[:, None] * j[None, :]) % n
    f = np.exp(sign * 2j * np.pi * ph / n)
    return np.concatenate([f.real, f.imag], axis=1).astype(dtype)


@lru_cache(maxsize=512)
def _twiddle_np(n1: int, n2: int, sign: int, dtype: str):
    """Twiddle planes (2, n2, k1): W[n2, k1] = exp(sign*2i*pi*n2*k1/(n1*n2))."""
    n = n1 * n2
    a = np.arange(n2, dtype=np.int64)[:, None]
    b = np.arange(n1, dtype=np.int64)[None, :]
    ph = (a * b) % n
    w = np.exp(sign * 2j * np.pi * ph / n)
    return np.stack([w.real, w.imag]).astype(dtype)


@lru_cache(maxsize=512)
def _split(n: int) -> int:
    """Pick n1 | n: the divisor <= DIRECT_MAX closest to sqrt(n) from
    below (balanced splits minimize total matmul FLOPs ~ N*(n1 + n/n1))."""
    best = 1
    d = 1
    while d * d <= n:
        if n % d == 0 and d <= DIRECT_MAX:
            best = d
        d += 1
    # a divisor just above sqrt may beat one far below it
    for cand in range(int(np.sqrt(n)), min(DIRECT_MAX, n) + 1):
        if cand > 1 and n % cand == 0:
            if min(cand, n // cand) > min(best, n // best):
                best = cand
            break
    return best


def _cdot(pr, pi, bank, k, prec):
    """Complex contraction of the LAST axis with a (n, 2k) real bank.

    (pr + i*pi) @ (Fr + i*Fi) via two real dots and a block-slice
    combine; returns (re, im), each (..., k)."""
    dn = (((pr.ndim - 1,), (0,)), ((), ()))
    a = jax.lax.dot_general(pr, bank, dn, precision=prec)
    b = jax.lax.dot_general(pi, bank, dn, precision=prec)
    return a[..., :k] - b[..., k:], a[..., k:] + b[..., :k]


def _core(pr, pi, n: int, sign: int, prec):
    """DFT over the last axis of the real planes (pr, pi), size n.

    Returns (re, im) of the unnormalized transform.  n must be 1, <=
    DIRECT_MAX, or composite (primes above DIRECT_MAX are the caller's
    problem — see fft_mx's Bluestein fallback)."""
    if n <= DIRECT_MAX:
        bank = jnp.asarray(_dft_bank_np(n, sign, pr.dtype.name))
        return _cdot(pr, pi, bank, n, prec)
    n1 = _split(n)
    if n1 == 1:
        raise ValueError(
            f"size {n} is prime and exceeds DIRECT_MAX={DIRECT_MAX}; "
            "route primes through the Bluestein wrapper (fft_mx)")
    n2 = n // n1
    batch = pr.shape[:-1]
    # stage A: contract n1 (axis -2 of the (n1, n2) view)
    ar = pr.reshape(*batch, n1, n2)
    ai = pi.reshape(*batch, n1, n2)
    nd = ar.ndim
    bank1 = jnp.asarray(_dft_bank_np(n1, sign, pr.dtype.name))
    dn = (((nd - 2,), (0,)), ((), ()))
    ya = jax.lax.dot_general(ar, bank1, dn, precision=prec)  # (..., n2, 2k1)
    yb = jax.lax.dot_general(ai, bank1, dn, precision=prec)
    br = ya[..., :n1] - yb[..., n1:]
    bi = ya[..., n1:] + yb[..., :n1]
    # stage B: twiddle W_N^{n2*k1} — fused by XLA into the combine above
    tw = jnp.asarray(_twiddle_np(n1, n2, sign, pr.dtype.name))
    cr = br * tw[0] - bi * tw[1]
    ci = br * tw[1] + bi * tw[0]
    # stage C: DFT of size n2 over axis -2
    if n2 <= DIRECT_MAX:
        bank2 = jnp.asarray(_dft_bank_np(n2, sign, pr.dtype.name))
        da = jax.lax.dot_general(cr, bank2, dn, precision=prec)
        db = jax.lax.dot_general(ci, bank2, dn, precision=prec)
        dr = da[..., :n2] - db[..., n2:]   # (..., k1, k2)
        di = da[..., n2:] + db[..., :n2]
    else:
        dr, di = _core(jnp.swapaxes(cr, -1, -2), jnp.swapaxes(ci, -1, -2),
                       n2, sign, prec)     # (..., k1, k2)
    # stage D: X[k1 + n1*k2] -> flat order is (k2 major, k1 minor)
    dr = jnp.swapaxes(dr, -1, -2).reshape(*batch, n)
    di = jnp.swapaxes(di, -1, -2).reshape(*batch, n)
    return dr, di


def _is_prime(n: int) -> bool:
    if n < 2:
        return False
    d = 2
    while d * d <= n:
        if n % d == 0:
            return False
        d += 1
    return True


def dft_mx_planar(pr, pi, sign: int = -1, precision=None):
    """Unnormalized DFT over the last axis of real planes (pr, pi).

    The planar entry point for fused chains that already carry (re, im)
    float planes.  Prime sizes above DIRECT_MAX
    take the Bluestein route with the pow2 convolution FFTs also done as
    matmuls."""
    prec = _resolve_precision(precision)
    n = pr.shape[-1]
    if n <= DIRECT_MAX or _split(n) > 1:
        return _core(pr, pi, n, sign, prec)
    return _bluestein_mx(pr, pi, n, sign, prec)


def _bluestein_mx(pr, pi, n: int, sign: int, prec):
    """Prime-size planar DFT: chirp-z through a pow2 circular convolution
    whose forward/inverse FFTs are matmul 4-step transforms."""
    from .fft import _bluestein_tables

    c, B, L = _bluestein_tables(n, float(sign))
    rd = pr.dtype
    cr = jnp.asarray(c.real.astype(rd))
    ci = jnp.asarray(c.imag.astype(rd))
    ar = pr * cr - pi * ci
    ai = pr * ci + pi * cr
    pad = [(0, 0)] * (pr.ndim - 1) + [(0, L - n)]
    fr, fi = _core(jnp.pad(ar, pad), jnp.pad(ai, pad), L, -1, prec)
    Br = jnp.asarray(B.real.astype(rd))
    Bi = jnp.asarray(B.imag.astype(rd))
    gr = fr * Br - fi * Bi
    gi = fr * Bi + fi * Br
    hr, hi = _core(gr, gi, L, +1, prec)    # unnormalized inverse
    hr = hr[..., :n] / L
    hi = hi[..., :n] / L
    return hr * cr - hi * ci, hr * ci + hi * cr


def fft_mx(x, nfft: int | None = None, precision=None) -> jnp.ndarray:
    """Unnormalized forward DFT along the last axis, as matmuls.

    Same contract as :func:`ops.fft.fft`; intended for batched frames
    where the matmul formulation beats the backend's FFT lowering."""
    return _dft_mx(x, nfft, -1, precision)


def ifft_mx(x, nfft: int | None = None, precision=None) -> jnp.ndarray:
    """UNNORMALIZED inverse DFT (no 1/N — the reference's convention,
    matching :func:`ops.fft.ifft`)."""
    return _dft_mx(x, nfft, +1, precision)


def _dft_mx(x, nfft, sign: int, precision):
    x = jnp.asarray(x)
    cdtype = jnp.result_type(x.dtype, jnp.complex64)
    x = x.astype(cdtype)
    n = int(nfft or x.shape[-1])
    if x.shape[-1] < n:
        pad = [(0, 0)] * (x.ndim - 1) + [(0, n - x.shape[-1])]
        x = jnp.pad(x, pad)
    elif x.shape[-1] > n:
        x = x[..., :n]
    re, im = dft_mx_planar(x.real, x.imag, sign, precision)
    return jax.lax.complex(re, im).astype(cdtype)
