"""Linear prediction / parametric (AR) spectral estimation.

All-pole modeling layer: Levinson-Durbin on the autocorrelation method,
Burg's method on the raw samples, AR power spectra, and the FIR/IIR
lattice filter structures that realize the models with the reflection
coefficients directly.

Formulation: every routine is a fixed-shape jit that batches over
leading axes.  The order recursions (Levinson, Burg) run as
``lax.fori_loop`` over the model order p with masked fixed-size (p+1)
coefficient vectors — p is small (tens), the per-step work is
elementwise/dot over the batch, so the sequential depth is p, not N.
The data axis N only ever appears inside dense dot products (matmul/elementwise
shapes).  The synthesis lattice is the one genuinely per-sample
recurrence (state = p reflection stages) and runs as a ``lax.scan``
over time, like ops/iir.py's direct-form core.

The reference framework has no prediction layer (its analysis stops at
group delay / frequency response, SURVEY §2); this extends the analysis
surface in the same spirit as analysis/estimate.py.  Conventions match
the textbook/scipy ones: A(z) = 1 + a_1 z^-1 + ... + a_p z^-p is the
prediction-ERROR filter, the all-pole model is sigma^2 / |A|^2, and
``levinson`` agrees with scipy.linalg.solve_toeplitz on the Yule-Walker
normal equations (verified in tests/test_lpc.py).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["acf", "levinson", "lpc", "burg", "ar_psd",
           "lattice_fir", "lattice_iir", "reflection_to_poly"]


@partial(jax.jit, static_argnames=("order", "normalize"))
def acf(x, order: int, normalize: bool = True) -> jnp.ndarray:
    """Biased sample autocorrelation r[0..order] along the last axis.

    r[k] = (1/N) sum_n x[n+k] conj(x[n])  (the biased estimator — it
    keeps the Toeplitz system positive semi-definite, which Levinson
    needs).  x: (..., N) real or complex -> (..., order+1).
    """
    x = jnp.asarray(x)
    n = x.shape[-1]
    if order >= n:
        raise ValueError(f"order {order} needs at least order+1 samples, "
                         f"got {n}")
    cols = [jnp.sum(x[..., k:] * jnp.conj(x[..., : n - k]), axis=-1)
            for k in range(order + 1)]
    r = jnp.stack(cols, axis=-1)
    return r / n if normalize else r


@jax.jit
def levinson(r) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Levinson-Durbin recursion on autocorrelations r (..., p+1).

    Solves the Yule-Walker normal equations Toeplitz(r[:p]) a = -r[1:]
    in O(p^2) instead of O(p^3).  Returns (a, k, e):
      a (..., p+1) — prediction-error filter, a[..., 0] = 1
      k (..., p)   — reflection (PARCOR) coefficients
      e (...,)     — final prediction error power (real)
    Hermitian (complex-signal) convention throughout.
    """
    r = jnp.asarray(r)
    p = r.shape[-1] - 1
    cdtype = r.dtype
    a0 = jnp.zeros(r.shape[:-1] + (p + 1,), cdtype
                   ).at[..., 0].set(1.0)
    e0 = jnp.real(r[..., 0])
    k0 = jnp.zeros(r.shape[:-1] + (max(p, 1),), cdtype)
    idx = jnp.arange(p + 1)

    def step(m, carry):
        a, k, e = carry
        # acc = r[m] + sum_{i=1}^{m-1} a_i r[m-i]  (gather-free: masked
        # dot of a with the reversed-r row for this m)
        rrev = jnp.take_along_axis(
            jnp.broadcast_to(r, a.shape),
            jnp.broadcast_to(jnp.clip(m - idx, 0, p),
                             a.shape[:-1] + (p + 1,)),
            axis=-1)
        mask = (idx < m).astype(a.real.dtype)
        acc = jnp.sum(a * rrev * mask, axis=-1)
        km = -acc / jnp.maximum(e, jnp.finfo(e.dtype).tiny).astype(e.dtype)
        km = km.astype(cdtype)
        # a <- a + km * J conj(a)  on entries 1..m (J = index reversal
        # within the first m+1 slots)
        arev = jnp.take_along_axis(
            jnp.conj(a),
            jnp.broadcast_to(jnp.clip(m - idx, 0, p),
                             a.shape[:-1] + (p + 1,)),
            axis=-1)
        upd_mask = ((idx >= 1) & (idx <= m)).astype(a.real.dtype)
        a = a + km[..., None] * arev * upd_mask
        e = e * (1.0 - jnp.abs(km) ** 2)
        k = k.at[..., m - 1].set(km)
        return a, k, e

    a, k, e = jax.lax.fori_loop(1, p + 1, step, (a0, k0, e0))
    return a, k[..., :p], e


@partial(jax.jit, static_argnames=("order",))
def lpc(x, order: int):
    """Autocorrelation-method LPC: (a, k, e) for x (..., N).

    e is the prediction error POWER (per sample); the all-pole model of
    x's PSD is ar_psd(a, e).
    """
    return levinson(acf(x, order))


@partial(jax.jit, static_argnames=("order",))
def burg(x, order: int):
    """Burg's method: reflection coefficients from the data directly.

    Minimizes forward+backward prediction error at each order without
    windowing the data — markedly better poles than the autocorrelation
    method on short records.  x: (..., N) -> (a (..., p+1), k (..., p),
    e (...,)).  The order loop is ``fori_loop``; per order the work is
    two masked length-N dots (vector reductions), so the whole estimate is
    one jit with sequential depth p.
    """
    x = jnp.asarray(x)
    n = x.shape[-1]
    p = int(order)
    if p >= n:
        raise ValueError(f"order {p} needs more than order samples, got {n}")
    cdtype = x.dtype
    f0 = x
    b0 = x
    a0 = jnp.zeros(x.shape[:-1] + (p + 1,), cdtype).at[..., 0].set(1.0)
    k0 = jnp.zeros(x.shape[:-1] + (max(p, 1),), cdtype)
    e0 = jnp.real(jnp.sum(x * jnp.conj(x), axis=-1)) / n
    tidx = jnp.arange(n)
    pidx = jnp.arange(p + 1)

    def step(m, carry):
        f, b, a, k, e = carry
        # valid forward errors live at n >= m; backward at n <= N-1-?,
        # realized by shifting b right once per order and masking
        b1 = jnp.roll(b, 1, axis=-1)
        valid = (tidx >= m).astype(x.real.dtype)
        num = jnp.sum(f * jnp.conj(b1) * valid, axis=-1)
        den = jnp.sum((jnp.abs(f) ** 2 + jnp.abs(b1) ** 2) * valid,
                      axis=-1)
        km = (-2.0 * num
              / jnp.maximum(den, jnp.finfo(den.dtype).tiny)).astype(cdtype)
        fn = f + km[..., None] * b1
        bn = b1 + jnp.conj(km)[..., None] * f
        # poly update a <- a + km * J conj(a), entries 1..m
        arev = jnp.take_along_axis(
            jnp.conj(a),
            jnp.broadcast_to(jnp.clip(m - pidx, 0, p),
                             a.shape[:-1] + (p + 1,)),
            axis=-1)
        upd = ((pidx >= 1) & (pidx <= m)).astype(x.real.dtype)
        a = a + km[..., None] * arev * upd
        e = e * (1.0 - jnp.abs(km) ** 2)
        k = k.at[..., m - 1].set(km)
        return fn, bn, a, k, e

    _, _, a, k, e = jax.lax.fori_loop(1, p + 1, step,
                                      (f0, b0, a0, k0, e0))
    return a, k[..., :p], e


@partial(jax.jit, static_argnames=("nfft",))
def ar_psd(a, sigma2, nfft: int = 1024) -> jnp.ndarray:
    """AR model power spectrum sigma2 / |A(e^{j2 pi f})|^2.

    a: (..., p+1) with a[..., 0] = 1; sigma2: (...,) prediction error
    power.  Returns (..., nfft) over f = k/nfft in [0, 1) cycles/sample
    (two-sided; real models are symmetric about 0.5).
    """
    a = jnp.asarray(a)
    A = jnp.fft.fft(a, n=nfft, axis=-1)
    return jnp.asarray(sigma2)[..., None] / jnp.maximum(
        jnp.abs(A) ** 2, jnp.finfo(A.real.dtype).tiny)


@jax.jit
def reflection_to_poly(k) -> jnp.ndarray:
    """Reflection coefficients (..., p) -> prediction-error poly (..., p+1).

    The step-up recursion (the polynomial half of Levinson), for driving
    direct-form filters from lattice/PARCOR parameterizations.
    """
    k = jnp.asarray(k)
    p = k.shape[-1]
    a0 = jnp.zeros(k.shape[:-1] + (p + 1,), k.dtype).at[..., 0].set(1.0)
    idx = jnp.arange(p + 1)

    def step(m, a):
        arev = jnp.take_along_axis(
            jnp.conj(a),
            jnp.broadcast_to(jnp.clip(m - idx, 0, p),
                             a.shape[:-1] + (p + 1,)),
            axis=-1)
        upd = ((idx >= 1) & (idx <= m)).astype(a.real.dtype)
        return a + k[..., m - 1][..., None] * arev * upd

    return jax.lax.fori_loop(1, p + 1, step, a0)


@jax.jit
def lattice_fir(x, k) -> jnp.ndarray:
    """Analysis (prediction-error) lattice filter.

    Runs the p-stage FIR lattice with reflection coefficients k (..., p)
    over x (..., N); output equals convolving x with
    reflection_to_poly(k) and truncating to N (zero initial state).
    Each stage is one elementwise pass over the whole block (shift +
    two multiply-adds) — sequential depth p, not N.
    """
    x = jnp.asarray(x)
    k = jnp.asarray(k)
    p = k.shape[-1]
    f = x
    b = x
    for m in range(p):  # p is a static Python int (shape) — unrolled
        km = k[..., m][..., None]
        b1 = jnp.roll(b, 1, axis=-1).at[..., 0].set(0.0)
        f, b = f + km * b1, b1 + jnp.conj(km) * f
    return f


@jax.jit
def lattice_iir(y, k) -> jnp.ndarray:
    """Synthesis (all-pole) lattice: inverse of lattice_fir.

    Per-sample ``lax.scan`` over time with the p backward errors as
    state (the honest sequential recurrence, like ops/iir.py's scan
    core).  y: (..., N), k: (..., p) -> x with lattice_fir(x, k) == y.
    """
    y = jnp.asarray(y)
    k = jnp.asarray(k)
    p = k.shape[-1]
    bshape = y.shape[:-1] + (p,)
    b0 = jnp.zeros(bshape, y.dtype)

    def step(b, yn):
        # descend the lattice: f_p = yn; f_{m-1} = f_m - k_m b_{m-1}[n-1]
        f = yn
        fs = []
        for m in range(p - 1, -1, -1):
            f = f - k[..., m] * b[..., m]
            fs.append(f)
        x_n = f
        # ascend: b_m[n] = b_{m-1}[n-1] + conj(k_m) f_{m-1}[n]
        new_b = [x_n]
        for m in range(1, p):
            f_prev = fs[p - 1 - (m - 1)]  # f_{m-1}[n]
            new_b.append(b[..., m - 1] + jnp.conj(k[..., m - 1]) * f_prev)
        return jnp.stack(new_b, axis=-1), x_n

    _, xs = jax.lax.scan(step, b0, jnp.moveaxis(y, -1, 0))
    return jnp.moveaxis(xs, 0, -1)
