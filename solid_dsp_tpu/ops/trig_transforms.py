"""Real trigonometric transforms: DCT/DST (FFTW REDFT/RODFT) + MDCT.

The reference *declares* these in its FFTType enum (fft/mod.rs:23-37:
REDFT00/REDFT10/REDFT01/REDFT11, RODFT..., MDCT, IMDCT) but never
implements them — the planner only handles complex DFTs.  This module
completes that intended API surface with FFTW's unnormalized conventions
(so a future FFTW cross-check is 1:1).

accelerator-first implementation choices:

* DCT-I / DCT-II / DST-I have textbook O(N log N) embeddings into a real
  FFT — used as the fast path (XLA FFT).
* The remaining kinds run as a single matmul against a cached cosine /
  sine matrix — for the N ≤ 8k frame sizes of spectral analysis this is
  exactly what the systolic array is for, and it is batched over frames.
* MDCT/IMDCT (lapped, 2N -> N) fold to a DCT-IV; with the sine window they
  satisfy TDAC perfect reconstruction (tested).
"""

from __future__ import annotations

from functools import lru_cache

import jax.numpy as jnp
import numpy as np

__all__ = ["dct", "dst", "mdct", "imdct", "mdct_window"]


# ---------------------------------------------------------------------------
# matrices (host-side, cached)
# ---------------------------------------------------------------------------

@lru_cache(maxsize=64)
def _trig_matrix(kind: str, n: int) -> np.ndarray:
    k = np.arange(n)[:, None].astype(np.float64)  # output index
    m = np.arange(n)[None, :].astype(np.float64)  # input index
    if kind == "dct1":  # REDFT00, length n, needs n >= 2
        # y[k] = x0 + (-1)^k x_{n-1} + 2 sum_{j=1}^{n-2} x_j cos(pi j k/(n-1))
        M = 2.0 * np.cos(np.pi * m * k / (n - 1))
        M[:, 0] = 1.0
        M[:, -1] = (-1.0) ** k[:, 0]
        return M
    if kind == "dct2":  # REDFT10
        return 2.0 * np.cos(np.pi * (m + 0.5) * k / n)
    if kind == "dct3":  # REDFT01
        M = 2.0 * np.cos(np.pi * m * (k + 0.5) / n)
        M[:, 0] = 1.0
        return M
    if kind == "dct4":  # REDFT11
        return 2.0 * np.cos(np.pi * (m + 0.5) * (k + 0.5) / n)
    if kind == "dst1":  # RODFT00
        return 2.0 * np.sin(np.pi * (m + 1.0) * (k + 1.0) / (n + 1))
    if kind == "dst2":  # RODFT10
        return 2.0 * np.sin(np.pi * (m + 0.5) * (k + 1.0) / n)
    if kind == "dst3":  # RODFT01
        M = 2.0 * np.sin(np.pi * (m + 1.0) * (k + 0.5) / n)
        M[:, -1] = (-1.0) ** k[:, 0]
        return M
    if kind == "dst4":  # RODFT11
        return 2.0 * np.sin(np.pi * (m + 0.5) * (k + 0.5) / n)
    raise ValueError(kind)


def _matmul_transform(kind: str, x: jnp.ndarray) -> jnp.ndarray:
    n = x.shape[-1]
    M = _trig_matrix(kind, n)
    return jnp.matmul(x, M.T.astype(x.dtype), precision="highest")


# ---------------------------------------------------------------------------
# FFT fast paths (XLA real FFT)
# ---------------------------------------------------------------------------

def _dct1_fft(x):
    # symmetric extension of length 2(n-1): [x0 .. x_{n-1}, x_{n-2} .. x1]
    ext = jnp.concatenate([x, x[..., -2:0:-1]], axis=-1)
    return jnp.fft.rfft(ext, axis=-1).real


def _dct2_fft(x):
    n = x.shape[-1]
    ext = jnp.concatenate([x, x[..., ::-1]], axis=-1)  # length 2n
    F = jnp.fft.rfft(ext, axis=-1)[..., :n]
    tw = np.exp(-1j * np.pi * np.arange(n) / (2 * n))
    return (F * tw.astype(F.dtype)).real


def _dst1_fft(x):
    n = x.shape[-1]
    z = jnp.zeros_like(x[..., :1])
    ext = jnp.concatenate([z, x, z, -x[..., ::-1]], axis=-1)  # length 2(n+1)
    return -jnp.fft.rfft(ext, axis=-1).imag[..., 1: n + 1]


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def dct(x, type: int = 2, backend: str = "auto") -> jnp.ndarray:
    """REDFT (FFTW-convention, unnormalized) DCT along the last axis."""
    x = jnp.asarray(x)
    if type == 1:
        if x.shape[-1] < 2:
            raise ValueError("DCT-I requires n >= 2")
        return _dct1_fft(x) if backend != "matmul" else _matmul_transform(
            "dct1", x)
    if type == 2:
        return _dct2_fft(x) if backend != "matmul" else _matmul_transform(
            "dct2", x)
    if type in (3, 4):
        return _matmul_transform(f"dct{type}", x)
    raise ValueError("DCT type must be 1..4")


def dst(x, type: int = 2, backend: str = "auto") -> jnp.ndarray:
    """RODFT (FFTW-convention, unnormalized) DST along the last axis."""
    x = jnp.asarray(x)
    if type == 1:
        return _dst1_fft(x) if backend != "matmul" else _matmul_transform(
            "dst1", x)
    if type in (2, 3, 4):
        return _matmul_transform(f"dst{type}", x)
    raise ValueError("DST type must be 1..4")


def mdct_window(n: int) -> np.ndarray:
    """Sine window w[j] = sin(pi/(2N)(j+1/2)) over 2N points (TDAC-valid)."""
    j = np.arange(2 * n)
    return np.sin(np.pi / (2 * n) * (j + 0.5))


def mdct(x, window: np.ndarray | None = None) -> jnp.ndarray:
    """Lapped MDCT: 2N windowed inputs -> N coefficients (last axis).

    X[k] = sum_{j=0}^{2N-1} w[j] x[j] cos(pi/N (j + 1/2 + N/2)(k + 1/2))
    """
    x = jnp.asarray(x)
    n2 = x.shape[-1]
    if n2 % 2:
        raise ValueError("MDCT input length must be even (2N)")
    n = n2 // 2
    if window is not None:
        x = x * jnp.asarray(np.asarray(window), x.dtype)
    j = np.arange(n2)[None, :].astype(np.float64)
    k = np.arange(n)[:, None].astype(np.float64)
    M = np.cos(np.pi / n * (j + 0.5 + n / 2.0) * (k + 0.5))
    return jnp.matmul(x, M.T.astype(x.dtype), precision="highest")


def imdct(X, window: np.ndarray | None = None) -> jnp.ndarray:
    """Inverse MDCT: N coefficients -> 2N aliased output samples.

    y[j] = (2/N) sum_k X[k] cos(pi/N (j + 1/2 + N/2)(k + 1/2)); overlap-add
    of consecutive windowed frames (hop N, sine window) reconstructs the
    input exactly (TDAC) — tested.
    """
    X = jnp.asarray(X)
    n = X.shape[-1]
    j = np.arange(2 * n)[:, None].astype(np.float64)
    k = np.arange(n)[None, :].astype(np.float64)
    M = np.cos(np.pi / n * (j + 0.5 + n / 2.0) * (k + 0.5)) * (2.0 / n)
    y = jnp.matmul(X, M.T.astype(X.dtype), precision="highest")
    if window is not None:
        y = y * jnp.asarray(np.asarray(window), y.dtype)
    return y
