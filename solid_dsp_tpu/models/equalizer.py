"""Adaptive FIR equalization: LMS/NLMS/RLS/CMA + gradient (optax) training.

New capability beyond the reference (it has no adaptive filtering); this is
the framework's "training" story: channel equalizers whose taps are learned
from data, either with classic adaptive-filter updates or with a genuine
optimizer step (optax) on a jitted loss — all pure block transforms that
shard over a ('channel', 'time') mesh like everything else.

* ``lms_step``: w <- w + mu * X^H e / T   (block least-mean-squares; the
  per-sample LMS recursion averaged over the block — the standard
  frequency-flat convergence behavior at block scale, all matmul work).
* ``nlms_step``: LMS normalized by the mean tap-window energy, making the
  step size invariant to input scaling.
* ``make_rls``: exponentially-weighted recursive least squares in the
  accelerator-native *block* formulation — instead of the classic per-sample
  inverse-correlation (P-matrix) update (a strictly sequential O(n^2)/sample
  recursion), accumulate the weighted normal equations per block as matmuls
  (R <- lam^T R + X^H W X,  p <- lam^T p + X^H W d) and do ONE n x n solve
  per block.  At block boundaries this is *algebraically identical* to
  per-sample RLS with forgetting factor ``lam`` and regularization
  ``delta`` (tests pin this against an independent per-sample accumulation).
* ``cma_step``: Godard/constant-modulus blind equalization — no training
  symbols, gradient of E[(|y|^2 - R2)^2]/4 via the same sliding-correlation
  trick as LMS.
* ``dd_lms_step``: decision-directed LMS — the desired signal is the
  nearest-constellation-point slice of the equalizer output (run after CMA
  has opened the eye).
* ``make_equalizer_trainer``: optax SGD/Adam on 0.5*|y - d|^2 with the
  complex-gradient convention dL/dw* (jax native for complex leaves).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.fir import conv1d_mxu
from ..streaming.framing import extend_with_tail, frame_windows, split_tail

__all__ = ["eq_init", "eq_apply", "lms_step", "nlms_step", "cma_step",
           "dd_lms_step", "make_rls", "make_equalizer_trainer",
           "LMSEqualizer", "RLSEqualizer", "CMAEqualizer",
           "fdaf_init", "fdaf_step", "FDAFCanceller"]


def eq_init(ntaps: int, dtype=jnp.complex64):
    """(taps, tail): center-spike initial taps, zero input history,
    built on the host and transferred."""
    from ..utils.transfer import put_array

    t = np.zeros(ntaps, dtype=np.dtype(dtype))
    t[ntaps // 2] = 1.0
    return (put_array(t),
            put_array(np.zeros(max(ntaps - 1, 0), np.dtype(dtype))))


@jax.jit
def eq_apply(taps, tail, x):
    """Filter a block: y[t] = sum_i taps[i] x_ext[t+i]; returns (y, tail)."""
    x_ext = extend_with_tail(tail, x)
    y = conv1d_mxu(x_ext, taps)
    return y, split_tail(x_ext, taps.shape[-1] - 1)


@jax.jit
def lms_step(taps, tail, x, desired, mu=0.05):
    """One block-LMS adaptation step.

    Returns (y, new_taps, new_tail); e = d - y, w += mu * mean_t(e[t] W[t]^*).
    """
    n = taps.shape[-1]
    x_ext = extend_with_tail(tail, x)
    y = conv1d_mxu(x_ext, taps)
    e = desired.astype(y.dtype) - y
    # grad[i] = mean_t e[t] conj(x_ext[t+i]) — a sliding correlation of the
    # error against the input: same conv kernel, no (T, n) materialization
    grad = conv1d_mxu(jnp.conj(x_ext), e)[..., :n] / x.shape[-1]
    new_taps = taps + mu * grad.astype(taps.dtype)
    return y, new_taps, split_tail(x_ext, n - 1)


@jax.jit
def nlms_step(taps, tail, x, desired, mu=0.5, eps=1e-8):
    """One block-NLMS step: LMS with the step normalized by the mean
    tap-window input energy, so ``mu`` is dimensionless in (0, 2) and the
    update is invariant to input scaling."""
    n = taps.shape[-1]
    x_ext = extend_with_tail(tail, x)
    y = conv1d_mxu(x_ext, taps)
    e = desired.astype(y.dtype) - y
    grad = conv1d_mxu(jnp.conj(x_ext), e)[..., :n] / x.shape[-1]
    # mean per-window energy ~= n * mean |x|^2
    energy = n * jnp.mean(jnp.abs(x_ext) ** 2)
    new_taps = taps + (mu / (eps + energy)) * grad.astype(taps.dtype)
    return y, new_taps, split_tail(x_ext, n - 1)


@jax.jit
def cma_step(taps, tail, x, mu=0.2, r2=1.0):
    """One block constant-modulus (Godard p=2) step — blind, no reference.

    J = E[(|y|^2 - r2)^2] / 4;  dJ/dw* = E[y (|y|^2 - r2) x*], computed as
    the same sliding error-input correlation as LMS (``mu`` is a
    block-gradient step: one update per block on the block-averaged
    gradient, so useful values are ~100x larger than classic per-sample
    CMA steps).  ``r2`` is the Godard
    dispersion constant E|s|^4 / E|s|^2 of the target constellation
    (1.0 for unit-power PSK).  Note CMA leaves an arbitrary phase rotation;
    follow with decision-directed LMS or a phase-recovery loop.
    """
    n = taps.shape[-1]
    x_ext = extend_with_tail(tail, x)
    y = conv1d_mxu(x_ext, taps)
    e = y * (jnp.abs(y) ** 2 - r2).astype(y.dtype)
    grad = conv1d_mxu(jnp.conj(x_ext), e)[..., :n] / x.shape[-1]
    new_taps = taps - mu * grad.astype(taps.dtype)
    return y, new_taps, split_tail(x_ext, n - 1)


@jax.jit
def dd_lms_step(taps, tail, x, points, mu=0.05):
    """Decision-directed block LMS: desired = nearest constellation point
    of the current output (use once the eye is open, e.g. after CMA)."""
    from .linear_mod import slice_symbols

    n = taps.shape[-1]
    x_ext = extend_with_tail(tail, x)
    y = conv1d_mxu(x_ext, taps)
    c = jnp.asarray(points).astype(y.dtype)
    d = c[slice_symbols(y, c)]
    e = d - y
    grad = conv1d_mxu(jnp.conj(x_ext), e)[..., :n] / x.shape[-1]
    new_taps = taps + mu * grad.astype(taps.dtype)
    return y, new_taps, split_tail(x_ext, n - 1)


def make_rls(ntaps: int, lam: float = 0.999, delta: float = 1e-2,
             dtype=jnp.complex64):
    """Exponentially-weighted RLS in block-normal-equation form.

    Returns ``(init, step)`` with
    ``init() -> (R, p, tail)`` and
    ``step(R, p, tail, x, d) -> (y, R, p, tail)``.

    Semantics: after any number of blocks totalling T samples, the taps
    solve  min_w sum_t lam^(T-1-t) |d_t - X[t] w|^2 + lam^T delta ||w||^2
    — exactly per-sample RLS with forgetting ``lam`` and initial
    regularization ``delta`` (P_0 = I/delta), but computed as matmuls
    plus one (ntaps x ntaps) solve per block instead of a sequential
    O(ntaps^2)-per-sample P update.  The output block ``y`` is filtered
    with the *a-posteriori* taps (solved after absorbing the block).
    """
    n = int(ntaps)
    lam = float(lam)

    def init():
        from ..utils.transfer import put_array

        npdt = np.dtype(dtype)
        return (put_array(delta * np.eye(n, dtype=npdt)),
                put_array(np.zeros(n, npdt)),
                put_array(np.zeros(max(n - 1, 0), npdt)))

    @jax.jit
    def step(R, p, tail, x, d):
        T = x.shape[-1]
        x_ext = extend_with_tail(tail, x)
        X = frame_windows(x_ext, n)                      # (T, n)
        # forgetting weights lam^(T-1-t), newest sample weight 1 (host
        # precomputed in f64: T and lam are static under jit)
        wts = jnp.asarray(
            np.power(lam, np.arange(T - 1, -1, -1, dtype=np.float64)),
            dtype=jnp.float32 if dtype == jnp.complex64 else jnp.float64)
        Xw = X * wts[:, None].astype(X.dtype)
        R2 = (lam ** T) * R + jnp.conj(X).T @ Xw
        p2 = (lam ** T) * p + jnp.conj(X).T @ (wts.astype(X.dtype)
                                               * d.astype(X.dtype))
        w = jnp.linalg.solve(R2, p2)
        y = X @ w
        return y, R2, p2, split_tail(x_ext, n - 1)

    return init, step


def make_equalizer_trainer(ntaps: int, optimizer=None, dtype=jnp.complex64):
    """Gradient-descent equalizer training: returns (init, train_step).

    ``train_step(taps, opt_state, tail, x, d) ->
    (y, taps, opt_state, tail, loss)`` — one jitted optimizer step on the
    block loss  L = mean |y - d|^2  (optax handles complex leaves natively).
    """
    import optax

    opt = optimizer or optax.adam(3e-2)

    def init():
        taps, tail = eq_init(ntaps, dtype)
        return taps, opt.init(taps), tail

    @jax.jit
    def train_step(taps, opt_state, tail, x, d):
        x_ext = extend_with_tail(tail, x)

        def loss_fn(w):
            y = conv1d_mxu(x_ext, w)
            r = y - d.astype(y.dtype)
            return jnp.mean(jnp.real(r * jnp.conj(r))), y

        (loss, y), g = jax.value_and_grad(loss_fn, has_aux=True)(taps)
        g = jnp.conj(g)  # dL/dw* convention for complex descent
        updates, opt_state = opt.update(g, opt_state, taps)
        taps = optax.apply_updates(taps, updates)
        return y, taps, opt_state, split_tail(x_ext, ntaps - 1), loss

    return init, train_step


class LMSEqualizer:
    """Stateful block-LMS equalizer with the framework's streaming API."""

    def __init__(self, ntaps: int, mu: float = 0.05, dtype=jnp.complex64):
        self.ntaps = int(ntaps)
        self.mu = float(mu)
        self._taps, self._tail = eq_init(self.ntaps, dtype)

    @property
    def taps(self) -> np.ndarray:
        return np.asarray(self._taps)

    def execute_block(self, x, desired=None):
        """Filter a block; adapts taps when ``desired`` is given."""
        x = jnp.asarray(x, self._taps.dtype)
        if desired is None:
            y, self._tail = eq_apply(self._taps, self._tail, x)
            return y
        y, self._taps, self._tail = lms_step(
            self._taps, self._tail, x, jnp.asarray(desired, self._taps.dtype),
            self.mu,
        )
        return y

    def reset(self):
        self._taps, self._tail = eq_init(self.ntaps, self._taps.dtype)

    def __repr__(self):
        return f"LMSEqualizer [ntaps={self.ntaps}] [mu={self.mu}]"


class RLSEqualizer:
    """Stateful block-RLS equalizer (exponentially-weighted, see make_rls)."""

    def __init__(self, ntaps: int, lam: float = 0.999, delta: float = 1e-2,
                 dtype=jnp.complex64):
        self.ntaps = int(ntaps)
        self.lam = float(lam)
        self._init, self._step = make_rls(ntaps, lam, delta, dtype)
        self._R, self._p, self._tail = self._init()

    @property
    def taps(self) -> np.ndarray:
        return np.asarray(jnp.linalg.solve(self._R, self._p))

    def execute_block(self, x, desired):
        x = jnp.asarray(x, self._p.dtype)
        y, self._R, self._p, self._tail = self._step(
            self._R, self._p, self._tail, x,
            jnp.asarray(desired, self._p.dtype))
        return y

    def reset(self):
        self._R, self._p, self._tail = self._init()

    def __repr__(self):
        return f"RLSEqualizer [ntaps={self.ntaps}] [lambda={self.lam}]"


class CMAEqualizer:
    """Stateful blind constant-modulus equalizer with optional
    decision-directed refinement once the eye is open."""

    def __init__(self, ntaps: int, mu: float = 0.2, r2: float = 1.0,
                 dtype=jnp.complex64):
        self.ntaps = int(ntaps)
        self.mu = float(mu)
        self.r2 = float(r2)
        self._taps, self._tail = eq_init(self.ntaps, dtype)

    @property
    def taps(self) -> np.ndarray:
        return np.asarray(self._taps)

    def execute_block(self, x, points=None, mu_dd: float = 0.05):
        """One blind CMA block; pass ``points`` (a constellation) to switch
        to decision-directed LMS instead."""
        x = jnp.asarray(x, self._taps.dtype)
        if points is None:
            y, self._taps, self._tail = cma_step(
                self._taps, self._tail, x, self.mu, self.r2)
        else:
            y, self._taps, self._tail = dd_lms_step(
                self._taps, self._tail, x, jnp.asarray(points), mu_dd)
        return y

    def reset(self):
        self._taps, self._tail = eq_init(self.ntaps, self._taps.dtype)

    def __repr__(self):
        return f"CMAEqualizer [ntaps={self.ntaps}] [mu={self.mu}] [r2={self.r2}]"


# ------------------------------------------- frequency-domain (FDAF)

def fdaf_init(m: int, dtype=jnp.complex64):
    """State for the overlap-save frequency-domain adaptive filter.

    m: time-domain filter length; the FFT size is 2m.  Returns
    (W (2m,) frequency weights, x_prev (m,) previous input block,
    P (2m,) per-bin input-power EMA for the normalized step).
    """
    from ..utils.transfer import put_array

    npdt = np.dtype(dtype)
    return (put_array(np.zeros(2 * m, npdt)),
            put_array(np.zeros(m, npdt)),
            put_array(np.full(2 * m, 1e-3, np.float32)))


@partial(jax.jit, static_argnames=("constrained",))
def fdaf_step(state, x, d, mu: float = 0.5, p_beta: float = 0.9,
              eps: float = 1e-6, constrained: bool = True):
    """One constrained fast-block-NLMS update over sub-blocks of m.

    The production adaptive-filter formulation (echo/noise cancellation,
    long channel ID): overlap-save turns the convolution AND the
    gradient correlation into length-2m FFTs — O(log m) work per sample
    instead of O(m) — and the per-bin power normalization equalizes
    convergence across the input spectrum (colored inputs converge as
    fast as white, unlike time-domain LMS whose modes spread by the
    input eigenvalue ratio).  The gradient constraint (zeroing the
    acausal half of the weight update) removes circular wrap-around so
    the learned filter is exactly a length-m causal FIR.

    x, d: (T,) with T a multiple of m (the class wrapper buffers).
    Sub-blocks advance through a ``lax.scan`` — ONE dispatch per call.
    Returns (y (T,), e (T,), new_state).
    """
    W, x_prev, P = state
    m = x_prev.shape[-1]
    n = 2 * m
    xb = x.reshape(-1, m)
    db = d.reshape(-1, m)

    def body(carry, xd):
        W, x_prev, P = carry
        xm, dm = xd
        seg = jnp.concatenate([x_prev, xm])
        Xf = jnp.fft.fft(seg)
        y = jnp.fft.ifft(Xf * W)[m:].astype(seg.dtype)
        e = dm - y
        Ef = jnp.fft.fft(jnp.concatenate([jnp.zeros(m, e.dtype), e]))
        P2 = p_beta * P + (1.0 - p_beta) * jnp.abs(Xf).astype(P.dtype) ** 2
        G = jnp.conj(Xf) * Ef / (P2 + eps).astype(Xf.dtype)
        if constrained:
            g = jnp.fft.ifft(G)
            g = jnp.concatenate([g[:m], jnp.zeros(m, g.dtype)])
            G = jnp.fft.fft(g)
        W2 = W + mu * G.astype(W.dtype)
        return (W2, xm, P2), (y, e)

    (W, x_prev, P), (ys, es) = jax.lax.scan(body, (W, x_prev, P),
                                            (xb, db))
    return ys.reshape(-1), es.reshape(-1), (W, x_prev, P)


class FDAFCanceller:
    """Streaming frequency-domain adaptive canceller / channel identifier.

    feed ``execute_block(x, d)`` with the reference input x and the
    observed signal d; returns the error e = d - y (the cancelled
    residual).  ``taps`` exposes the learned length-m causal FIR.
    Arbitrary block lengths are buffered internally to multiples of m.
    """

    def __init__(self, m: int = 256, mu: float = 0.5,
                 dtype=jnp.complex64):
        if m < 1:
            raise ValueError("m must be >= 1")
        self.m = int(m)
        self.mu = float(mu)
        self._state = fdaf_init(self.m, dtype)
        self._dtype = dtype
        self._xbuf = np.zeros(0, np.complex128)
        self._dbuf = np.zeros(0, np.complex128)

    @property
    def taps(self) -> np.ndarray:
        W = np.asarray(self._state[0])
        return np.fft.ifft(W)[: self.m]

    def execute_block(self, x, d):
        self._xbuf = np.concatenate([self._xbuf, np.asarray(x)])
        self._dbuf = np.concatenate([self._dbuf, np.asarray(d)])
        t = (len(self._xbuf) // self.m) * self.m
        if t == 0:
            return jnp.zeros(0, self._dtype)
        xs = jnp.asarray(self._xbuf[:t], self._dtype)
        ds = jnp.asarray(self._dbuf[:t], self._dtype)
        self._xbuf = self._xbuf[t:]
        self._dbuf = self._dbuf[t:]
        _, e, self._state = fdaf_step(self._state, xs, ds, self.mu)
        return e

    def reset(self):
        self._state = fdaf_init(self.m, self._dtype)
        self._xbuf = np.zeros(0, np.complex128)
        self._dbuf = np.zeros(0, np.complex128)

    def __repr__(self):
        return f"FDAFCanceller [m={self.m}] [mu={self.mu}]"
