"""Chirp-Z transform and zoom FFT.

Evaluates the z-transform on a logarithmic spiral contour

    X[k] = sum_{n=0}^{N-1} x[n] * a^{-n} * w^{n k},    k = 0..M-1

via Bluestein's identity nk = (n^2 + k^2 - (k-n)^2) / 2, which turns the
chirped sum into ONE linear convolution — executed here as a pow2
circular convolution with jnp.fft, the accelerator-native fast path (the same
machinery as ops/fft.py's any-size Bluestein backend, generalized to
arbitrary contours and output counts).  All chirp tables are built
host-side in float64/longdouble (quadratic phases are reduced mod 2*pi
before exponentiation so precision holds for large N) and closed over as
numpy constants — nothing here fetches device arrays back to the host.

The reference framework has no zoom/CZT facility (its FFT planner,
src/fft/mod.rs, only dispatches full-size DFTs); this extends the
transform layer the way its Rader path (src/fft/rader/mod.rs) hints at:
every exotic transform becomes a pow2 convolution.

Typical uses: zoom FFT (fine frequency resolution over a narrow band
without a huge NFFT), arbitrary-resolution spectral interpolation,
pole/zero evaluation off the unit circle.

Numerical envelope: for |w| != 1 the chirp factors grow like
exp(|log|w|| * max(n, m)^2 / 2); once that exceeds the working dtype's
dynamic range the FFT convolution cancels catastrophically.  This is
inherent to Bluestein (scipy.signal.czt carries the same warning and
fails identically — verified side by side).  Keep
|log|w|| * max(n,m)^2 / 2 below ~8 in complex64 and ~30 in complex128;
unit-circle contours (zoom FFT) have no such limit.
"""
from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["czt", "zoom_fft", "CZT"]


@lru_cache(maxsize=128)
def _czt_tables(n: int, m: int, w_log_mag: float, w_angle: float,
                a_log_mag: float, a_angle: float):
    """Host-side chirp tables for an (n -> m) CZT.

    Returns (input chirp (n,), FFT of the convolution kernel (L,),
    output chirp (m,), L).  Quadratic phases use longdouble and are
    reduced mod 2*pi before cos/sin; magnitudes use log-domain exp so
    |w| != 1 spirals neither overflow nor lose precision prematurely.
    """
    L = max(1 << int(n + m - 2).bit_length(), 1) if n + m > 2 else 1

    def _chirp(idx: np.ndarray, log_mag: float, angle: float,
               scale: float) -> np.ndarray:
        """(mag * e^{i angle})^{scale * idx^2} with phase reduced mod 2pi."""
        q = idx.astype(np.longdouble) ** 2 * scale
        ph = np.remainder(q * np.longdouble(angle),
                          2 * np.longdouble(np.pi)).astype(np.float64)
        mag = np.exp(q.astype(np.float64) * log_mag)
        return mag * (np.cos(ph) + 1j * np.sin(ph))

    nn = np.arange(n, dtype=np.int64)
    kk = np.arange(m, dtype=np.int64)
    # a^{-n}: linear phase/magnitude, same reduced-phase treatment
    na = nn.astype(np.longdouble) * np.longdouble(a_angle)
    pa = np.remainder(-na, 2 * np.longdouble(np.pi)).astype(np.float64)
    a_pow = np.exp(-nn.astype(np.float64) * a_log_mag) * (
        np.cos(pa) + 1j * np.sin(pa))
    chirp_in = a_pow * _chirp(nn, w_log_mag, w_angle, 0.5)
    chirp_out = _chirp(kk, w_log_mag, w_angle, 0.5)
    # kernel v[j] = w^{-j^2/2} for j = -(n-1) .. (m-1), circularly embedded
    j_pos = np.arange(m, dtype=np.int64)
    j_neg = np.arange(1, n, dtype=np.int64)
    v = np.zeros(L, dtype=np.complex128)
    v[:m] = _chirp(j_pos, w_log_mag, w_angle, -0.5)
    if n > 1:
        v[L - (n - 1):] = _chirp(j_neg, w_log_mag, w_angle, -0.5)[::-1]
    return chirp_in, np.fft.fft(v), chirp_out, L


@partial(jax.jit, static_argnames=("n", "m", "w_params", "a_params"))
def _czt_exec(x, n: int, m: int, w_params, a_params):
    chirp_in, V, chirp_out, L = _czt_tables(n, m, *w_params, *a_params)
    ci = jnp.asarray(chirp_in).astype(x.dtype)
    V_ = jnp.asarray(V).astype(x.dtype)
    co = jnp.asarray(chirp_out).astype(x.dtype)
    y = x * ci
    Y = jnp.fft.fft(y, n=L, axis=-1)
    conv = jnp.fft.ifft(Y * V_, axis=-1)[..., :m]
    return conv * co


def _contour_params(z) -> tuple[float, float]:
    z = complex(z)
    if z == 0:
        raise ValueError("czt contour parameter must be nonzero")
    return float(np.log(abs(z))), float(np.angle(z))


def czt(x, m: int | None = None, w=None, a=1.0 + 0j,
        *, w_angle: float | None = None) -> jnp.ndarray:
    """Chirp-Z transform along the last axis.

    x: (..., N) real or complex.  m: number of output points (default N).
    w: ratio between contour points (default exp(-2j*pi/m) — the DFT
    contour).  a: starting point.  ``w_angle`` optionally gives the
    contour angle directly in radians (w = e^{1j*w_angle}), bypassing
    the lossy angle-recovery of a complex ``w`` for long transforms.

    czt(x) == fft(x); czt(x, m, w, a) matches scipy.signal.czt.
    """
    x = jnp.asarray(x)
    n = int(x.shape[-1])
    m = int(m if m is not None else n)
    if m < 1 or n < 1:
        raise ValueError(f"czt needs n >= 1 and m >= 1, got {n=}, {m=}")
    if w_angle is not None:
        if w is not None:
            raise ValueError("pass w or w_angle, not both")
        w_params = (0.0, float(w_angle))
    elif w is None:
        w_params = (0.0, -2.0 * np.pi / m)
    else:
        w_params = _contour_params(w)
    a_params = _contour_params(a)
    cdtype = jnp.result_type(x.dtype, jnp.complex64)
    return _czt_exec(x.astype(cdtype), n, m, w_params, a_params)


def zoom_fft(x, f1: float, f2: float | None = None, m: int | None = None,
             *, fs: float = 2.0, endpoint: bool = False) -> jnp.ndarray:
    """DTFT samples on [f1, f2) (or [f1, f2] with endpoint=True).

    Evaluates m equally spaced points of the spectrum between
    frequencies f1 and f2 (units of ``fs``; default fs=2 means
    frequencies are in half-cycles/sample like scipy.signal.zoom_fft).
    With f1=0, f2=fs, m=N, endpoint=False this reproduces fft(x) at a
    fraction of the cost when m << N would otherwise force zero-padding.
    """
    x = jnp.asarray(x)
    n = int(x.shape[-1])
    if f2 is None:
        f1, f2 = 0.0, float(f1)
    m = int(m if m is not None else n)
    if m < 1:
        raise ValueError("zoom_fft needs m >= 1")
    span = (f2 - f1) / (m - 1 if (endpoint and m > 1) else m)
    w_angle = -2.0 * np.pi * span / fs
    a_angle = 2.0 * np.pi * f1 / fs
    a = np.exp(1j * a_angle)
    cdtype = jnp.result_type(x.dtype, jnp.complex64)
    return _czt_exec(x.astype(cdtype), n, m, (0.0, w_angle),
                     _contour_params(a))


class CZT:
    """Reusable CZT plan (reference-style transform object).

    Mirrors the FFT class surface (ops/fft.py:314): construct once with
    the contour, then ``execute`` many blocks — tables are cached by
    (n, m, contour) so repeated executes re-enter a compiled jit.
    """

    def __init__(self, n: int, m: int | None = None, w=None, a=1.0 + 0j,
                 *, w_angle: float | None = None):
        self.n = int(n)
        self.m = int(m if m is not None else n)
        if w_angle is not None:
            if w is not None:
                raise ValueError("pass w or w_angle, not both")
            self._w_params = (0.0, float(w_angle))
        elif w is None:
            self._w_params = (0.0, -2.0 * np.pi / self.m)
        else:
            self._w_params = _contour_params(w)
        self._a_params = _contour_params(a)

    def execute(self, x) -> jnp.ndarray:
        x = jnp.asarray(x)
        if x.shape[-1] != self.n:
            raise ValueError(
                f"CZT plan built for n={self.n}, got {x.shape[-1]}")
        cdtype = jnp.result_type(x.dtype, jnp.complex64)
        return _czt_exec(x.astype(cdtype), self.n, self.m,
                         self._w_params, self._a_params)

    def __repr__(self):
        return f"CZT [n={self.n}] [m={self.m}] [w={self._w_params}]"
