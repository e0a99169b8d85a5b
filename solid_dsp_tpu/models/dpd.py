"""Digital predistortion (DPD): memory-polynomial PA linearization.

Production transmit chains drive power amplifiers near saturation for
efficiency and linearize them digitally — a capability absent from the
reference but standard in deployed SDR.  The memory-polynomial (MP) model
(a pruned Volterra series) is

    y[n] = sum_{k=0}^{K-1} sum_{q=0}^{Q-1} c[k, q] * x[n-q] |x[n-q]|^(2k)

— odd-order nonlinearity with Q taps of memory.  Everything here is
matmul-shaped: the basis is a (T, K*Q) matrix, fitting is one regularized LS
solve of the (K*Q, K*Q) normal equations, application is one matmul.

Learning uses the *indirect* architecture: fit a postdistorter from the
(gain-normalized) PA output back to the PA input, then copy it in front of
the PA as the predistorter — the standard fixed point for mild-memory PAs.

``saleh_pa`` provides the classic Saleh AM/AM + AM/PM traveling-wave-tube
model as a test target.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

__all__ = ["mp_basis", "mp_fit", "mp_apply", "dpd_learn", "saleh_pa",
           "Predistorter"]


@partial(jax.jit, static_argnames=("order", "memory"))
def mp_basis(x: jnp.ndarray, order: int, memory: int) -> jnp.ndarray:
    """Memory-polynomial basis matrix Phi (T, order*memory).

    Column (k, q) is  x[n-q] |x[n-q]|^(2k)  (odd orders 1, 3, 5, ...);
    delays are zero-padded at the block head (pass a tail-extended block
    and slice for streaming use).  Static shifts only — no gathers.
    """
    T = x.shape[-1]
    cols = []
    ax = jnp.abs(x)
    powers = [x]
    for k in range(1, order):
        powers.append(powers[-1] * (ax * ax).astype(x.dtype))
    for q in range(memory):
        xq_pows = powers if q == 0 else [
            jnp.concatenate([jnp.zeros((*x.shape[:-1], q), x.dtype),
                             p[..., : T - q]], axis=-1) for p in powers]
        cols.extend(xq_pows)
    return jnp.stack(cols, axis=-1)


@partial(jax.jit, static_argnames=("order", "memory"))
def mp_fit(x: jnp.ndarray, y: jnp.ndarray, order: int, memory: int,
           ridge: float = 1e-6) -> jnp.ndarray:
    """LS-fit MP coefficients c so that  mp_apply(c, x) ~= y.

    Solves (Phi^H Phi + ridge*tr/N I) c = Phi^H y — one (KQ, KQ) solve.
    """
    Phi = mp_basis(x, order, memory)
    A = jnp.conj(Phi).T @ Phi
    n = A.shape[-1]
    A = A + (ridge * jnp.trace(A).real / n) * jnp.eye(n, dtype=A.dtype)
    b = jnp.conj(Phi).T @ y.astype(Phi.dtype)
    return jnp.linalg.solve(A, b)


@partial(jax.jit, static_argnames=("order", "memory"))
def mp_apply(coefs: jnp.ndarray, x: jnp.ndarray, order: int,
             memory: int) -> jnp.ndarray:
    """Apply a memory polynomial: one (T, KQ) @ (KQ,) matmul."""
    return mp_basis(x, order, memory) @ coefs


def saleh_pa(x, alpha_a: float = 2.1587, beta_a: float = 1.1517,
             alpha_p: float = 4.0033, beta_p: float = 9.1040):
    """Saleh PA model: AM/AM  A(r) = aa r / (1 + ba r^2),
    AM/PM  P(r) = ap r^2 / (1 + bp r^2) radians (memoryless)."""
    r = jnp.abs(x)
    r2 = r * r
    gain = alpha_a / (1.0 + beta_a * r2)
    phase = alpha_p * r2 / (1.0 + beta_p * r2)
    return x * (gain * jnp.exp(1j * phase)).astype(x.dtype)


def dpd_learn(pa_fn, x, order: int = 5, memory: int = 3,
              iters: int = 3, ridge: float = 1e-6):
    """Indirect-learning DPD: returns (coefs, linear_gain).

    Each iteration drives the PA with the current predistorted signal,
    normalizes the PA output by the small-signal linear gain g (estimated
    from the lowest-envelope decile), and LS-fits the postdistorter
    (y/g -> PA input); the fit is copied as the next predistorter.

    The PA must be operated inside its linearizable range: besides AM/AM
    monotonicity (Saleh: r < 1/sqrt(beta_a)), the linear target must be
    reachable — peak_in * g <= max PA output envelope (Saleh:
    alpha_a / (2 sqrt(beta_a)), so peak_in <= ~0.466).  Past either bound
    no predistorter exists and the fit degrades sharply.  Back off the
    drive or crest-factor-reduce first (models/cfr.py).
    """
    x = jnp.asarray(x)
    order, memory = int(order), int(memory)
    coefs = jnp.zeros(order * memory, x.dtype).at[0].set(1.0)
    g = None
    for _ in range(max(1, int(iters))):
        u = mp_apply(coefs, x, order, memory)
        y = pa_fn(u)
        if g is None:
            r = jnp.abs(u)
            small = (r <= jnp.quantile(r, 0.1)).astype(u.dtype)
            g = (jnp.sum(y * jnp.conj(u) * small)
                 / jnp.maximum(jnp.sum(r * r * jnp.real(small)), 1e-30))
        coefs = mp_fit(y / g, u, order, memory, ridge)
    return coefs, g


class Predistorter:
    """Stateful block predistorter (carries the delay-line tail)."""

    def __init__(self, coefs, order: int, memory: int, dtype=jnp.complex64):
        self.order, self.memory = int(order), int(memory)
        self._c = jnp.asarray(coefs, dtype)
        self._tail = jnp.zeros(max(self.memory - 1, 0), dtype)

    def execute_block(self, x):
        x = jnp.asarray(x, self._c.dtype)
        ext = jnp.concatenate([self._tail, x], axis=-1)
        y = mp_apply(self._c, ext, self.order, self.memory)
        if self.memory > 1:
            self._tail = ext[..., -(self.memory - 1):]
            return y[..., self.memory - 1:]
        return y

    def reset(self):
        self._tail = jnp.zeros_like(self._tail)

    def __repr__(self):
        return (f"Predistorter [order={self.order}] "
                f"[memory={self.memory}]")
