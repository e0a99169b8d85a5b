"""Shared parallel linear-recurrence machinery.

The block-parallel evaluation of  s[t] = A[t] s[t-1] + v[t]  as an
O(log T)-depth ``associative_scan`` over affine maps (A, v) is used by the
IIR engine (ops/iir.py, companion matrices), the steady-state Kalman
tracker (ops/kalman.py), and any future first-order-vector recurrence.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["affine_combine", "affine_scan", "chunked_first_order"]


def affine_combine(left, right, precision=None):
    """Compose affine maps: (A2, v2) ∘ (A1, v1) = (A2 A1, A2 v1 + v2)."""
    A1, v1 = left
    A2, v2 = right
    return (jnp.matmul(A2, A1, precision=precision),
            jnp.einsum("...ij,...j->...i", A2, v1) + v2)


def affine_scan(As, vs, precision=None):
    """Prefix evaluation of s[t] = A[t] s[t-1] + v[t] (s[-1] folded into
    v[0] by the caller).  As: (T, n, n), vs: (T, n) -> s: (T, n)."""
    def combine(left, right):
        return affine_combine(left, right, precision)

    _, s = jax.lax.associative_scan(combine, (As, vs))
    return s


def chunked_first_order(lams: np.ndarray, u, chunk: int = 256):
    """SCALAR LTI recurrences  s[m, t] = lam[m] s[m, t-1] + u[m, t]
    (s[m, -1] = 0) evaluated as matmuls instead of a scan.

    ``lams``: CONCRETE host-side (m,) decay factors (real or complex) —
    they parameterize compile-time-constant chunk matrices.  ``u``:
    (..., m, T) inputs.  Returns s with u's shape.

    Blocked two-level evaluation (the standard chunked linear
    recurrence): within chunks of ``chunk`` samples the prefix is one
    matmul against the lower-triangular Toeplitz power matrix
    LT[m, i', i] = lam[m]^(i - i'); across the T/chunk chunk boundaries
    the carries obey a tiny first-order recurrence with constant factor
    lam^chunk, evaluated by a log-depth ``associative_scan`` over
    scalars.  Everything lands as matmuls / a few elementwise passes, in
    place of a (T, n, n)-matrix ``associative_scan`` of tiny per-element
    matmuls (the 2-state steady-state Kalman tracker).
    """
    lams = np.atleast_1d(np.asarray(lams))
    m = lams.shape[0]
    T = u.shape[-1]
    B = int(min(chunk, max(T, 1)))
    F = -(-T // B)
    pad = F * B - T
    if pad:
        u = jnp.concatenate(
            [u, jnp.zeros((*u.shape[:-1], pad), u.dtype)], axis=-1)
    # LT[m, i', i] = lam^(i-i') for i >= i' (host, compile-time constant)
    d = np.arange(B)[None, :] - np.arange(B)[:, None]        # (B, B)
    with np.errstate(invalid="ignore"):
        LT = np.where(d >= 0, lams[:, None, None].astype(np.complex128)
                      ** np.maximum(d, 0)[None], 0.0)
    if not np.iscomplexobj(lams):
        LT = LT.real
    cdt = jnp.result_type(u.dtype, np.zeros(0, LT.dtype).dtype,
                          jnp.float32)
    uc = u.reshape(*u.shape[:-2], m, F, B).astype(cdt)
    hi = jax.lax.Precision.HIGHEST
    rdt = np.zeros(0, cdt).real.dtype

    def _mm(a, M_np):
        return jnp.einsum("...mfi,mij->...mfj", a,
                          jnp.asarray(M_np.astype(rdt)), precision=hi)

    if jnp.issubdtype(cdt, jnp.complexfloating):
        # real-plane float32 dots at HIGHEST: full float32 products on
        # every backend, whatever its complex-dot lowering
        ur, ui = jnp.real(uc), jnp.imag(uc)
        LTr, LTi = LT.real, LT.imag
        s_re = _mm(ur, LTr) - _mm(ui, LTi)
        s_im = _mm(ur, LTi) + _mm(ui, LTr)
        s_loc = jax.lax.complex(s_re, s_im).astype(cdt)
    else:
        s_loc = _mm(uc, LT).astype(cdt)
    # chunk-boundary carries: g[f] = lam^B g[f-1] + s_loc[..., f, B-1]
    c = s_loc[..., B - 1]                                    # (..., m, F)
    aB = jnp.asarray((lams.astype(np.complex128) ** B if
                      np.iscomplexobj(lams) else lams.astype(np.float64)
                      ** B)).astype(cdt)
    a_el = jnp.broadcast_to(aB[:, None], c.shape[-2:])
    a_el = jnp.broadcast_to(a_el, c.shape)

    def comb(left, right):
        a1, v1 = left
        a2, v2 = right
        return a1 * a2, a2 * v1 + v2

    _, g = jax.lax.associative_scan(comb, (a_el, c), axis=c.ndim - 1)
    g_prev = jnp.concatenate(
        [jnp.zeros((*g.shape[:-1], 1), g.dtype), g[..., :-1]], axis=-1)
    powv = np.asarray(lams.astype(np.complex128)[:, None]
                      ** (np.arange(B) + 1)[None, :])
    if not np.iscomplexobj(lams):
        powv = powv.real
    s = s_loc + g_prev[..., None] * jnp.asarray(powv).astype(cdt)[:, None, :]
    return s.reshape(*s.shape[:-2], F * B)[..., :T]
