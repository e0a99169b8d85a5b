"""Kalman filtering and steady-state trackers, accelerator-first.

The reference library has no state estimation at all; SDR chains need it
for carrier/timing drift tracking, Doppler smoothing, and burst parameter
estimation.  Three formulations, trading generality for parallelism:

* ``kalman_apply`` — the full time-varying filter (predict/update with the
  Riccati recursion in the carry) as a ``lax.scan``: exact, sequential.
* ``steady_state_gain`` — host-side discrete algebraic Riccati iteration
  giving the asymptotic gain K∞; the filter then becomes LTI.
* ``kalman_lti_apply`` — the steady-state filter  x_k = F x_{k-1} + K z_k
  (F = (I − K C) A) evaluated either as a scan or as a fully parallel
  ``lax.associative_scan`` over affine maps (O(log T) depth): the same
  trick the IIR engine uses (ops/iir.py), generalized to an n-state
  tracker.  For the n ≤ 4 states of practical trackers the (n, n) matmul
  composition is tiny elementwise work and the throughput is block-parallel.
* ``alpha_beta_gains`` / ``AlphaBetaTracker`` — the classic constant-
  velocity tracker: the closed-form steady-state Kalman filter for a
  white-acceleration target, parameterized by the Kalata tracking index.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .linrec import affine_scan, chunked_first_order

__all__ = ["kalman_init", "kalman_apply", "rts_smooth",
           "steady_state_gain", "kalman_lti_apply", "make_kalman_lti",
           "alpha_beta_gains", "AlphaBetaTracker", "cv_model"]


def kalman_init(x0, P0):
    """Carry pytree: (state estimate, covariance)."""
    return jnp.asarray(x0), jnp.asarray(P0)


@jax.jit
def kalman_apply(state, Z, A, C, Q, R):
    """Full Kalman filter over a block of measurements.

    state: (x, P) with x (n,) and P (n, n).  Z: (T, m).  Returns
    (X_est (T, n), new_state).  Standard predict/update:
      x⁻ = A x,  P⁻ = A P Aᵀ + Q
      S = C P⁻ Cᵀ + R,  K = P⁻ Cᵀ S⁻¹
      x = x⁻ + K (z − C x⁻),  P = (I − K C) P⁻
    """
    A = jnp.asarray(A)
    C = jnp.atleast_2d(jnp.asarray(C))
    Q = jnp.asarray(Q)
    R = jnp.atleast_2d(jnp.asarray(R))

    def step(carry, z):
        x2, P2, _, _ = _kf_predict_update(carry[0], carry[1], z, A, C, Q, R)
        return (x2, P2), x2

    Z2 = jnp.atleast_2d(Z.T).T if Z.ndim == 1 else Z
    (x, P), X = jax.lax.scan(step, state, Z2)
    return X, (x, P)


def _kf_predict_update(x, P, z, A, C, Q, R):
    """One Kalman predict/update; returns (x2, P2, xp, Pp).  The single
    source of the filter equations — kalman_apply and rts_smooth's
    forward pass both call it, so a change (e.g. Joseph form) cannot
    leave them inconsistent."""
    I = jnp.eye(A.shape[-1], dtype=A.dtype)
    xp = A @ x
    Pp = A @ P @ A.T + Q
    S = C @ Pp @ C.T + R
    K = jnp.linalg.solve(S.T, (Pp @ C.T).T).T
    x2 = xp + K @ (z - C @ xp)
    P2 = (I - K @ C) @ Pp
    return x2, P2, xp, Pp


@jax.jit
def rts_smooth(state, Z, A, C, Q, R):
    """Rauch-Tung-Striebel fixed-interval smoother over a block.

    Runs the forward Kalman filter (same model arguments as
    ``kalman_apply``), then the backward recursion

        G_t = P_t Aᵀ (P⁻_{t+1})⁻¹
        x̂_t = x_t + G_t (x̂_{t+1} − x⁻_{t+1})
        P̂_t = P_t + G_t (P̂_{t+1} − P⁻_{t+1}) G_tᵀ

    as a reversed ``lax.scan`` — two linear passes, both jitted.
    Returns (Xs (T, n), Ps (T, n, n)): the smoothed means use ALL T
    measurements at every t (offline/burst post-processing — for
    streaming use kalman_apply).  The last step equals the filter.
    """
    A = jnp.asarray(A)
    C = jnp.atleast_2d(jnp.asarray(C))
    Q = jnp.asarray(Q)
    R = jnp.atleast_2d(jnp.asarray(R))

    def fstep(carry, z):
        x2, P2, xp, Pp = _kf_predict_update(carry[0], carry[1], z,
                                            A, C, Q, R)
        return (x2, P2), (x2, P2, xp, Pp)

    Z2 = jnp.atleast_2d(Z.T).T if Z.ndim == 1 else Z
    _, (Xf, Pf, Xp, Pp) = jax.lax.scan(fstep, state, Z2)

    def bstep(carry, inp):
        xs_next, Ps_next = carry
        x_f, P_f, xp_next, Pp_next = inp
        G = jnp.linalg.solve(Pp_next.T, (P_f @ A.T).T).T
        xs = x_f + G @ (xs_next - xp_next)
        Ps = P_f + G @ (Ps_next - Pp_next) @ G.T
        return (xs, Ps), (xs, Ps)

    # pair step t with the PREDICTED quantities of step t+1
    init = (Xf[-1], Pf[-1])
    seq = (Xf[:-1], Pf[:-1], Xp[1:], Pp[1:])
    _, (Xs, Ps) = jax.lax.scan(bstep, init, seq, reverse=True)
    Xs = jnp.concatenate([Xs, Xf[-1:]], axis=0)
    Ps = jnp.concatenate([Ps, Pf[-1:]], axis=0)
    return Xs, Ps


def steady_state_gain(A, C, Q, R, iters: int = 10_000, tol: float = 1e-12):
    """Asymptotic Kalman gain K∞ by iterating the discrete Riccati equation
    to a fixed point (host-side numpy — design time, like firdes).

    Returns (K, F) with F = (I − K C) A so the steady-state filter is
    x_k = F x_{k-1} + K z_k.
    """
    A = np.asarray(A, np.float64)
    C = np.atleast_2d(np.asarray(C, np.float64))
    Q = np.asarray(Q, np.float64)
    R = np.atleast_2d(np.asarray(R, np.float64))
    n = A.shape[0]
    P = np.eye(n)
    for _ in range(iters):
        Pp = A @ P @ A.T + Q
        S = C @ Pp @ C.T + R
        K = Pp @ C.T @ np.linalg.inv(S)
        P2 = (np.eye(n) - K @ C) @ Pp
        if np.max(np.abs(P2 - P)) < tol:
            P = P2
            break
        P = P2
    Pp = A @ P @ A.T + Q
    S = C @ Pp @ C.T + R
    K = Pp @ C.T @ np.linalg.inv(S)
    F = (np.eye(n) - K @ C) @ A
    return K, F


@partial(jax.jit, static_argnames=("method",))
def kalman_lti_apply(x0, Z, K, F, method: str = "parallel"):
    """Steady-state (LTI) Kalman filter:  x_k = F x_{k-1} + K z_k.

    x0: (n,) carry state.  Z: (T, m) or (T,) measurements.  Returns
    (X (T, n), x_T).  ``method="parallel"`` evaluates the affine linear
    recurrence with an O(log T)-depth associative scan (block-parallel,
    shardable); ``"scan"`` is the sequential reference path.
    """
    F = jnp.asarray(F)
    K = jnp.asarray(K)
    if K.ndim == 1:
        K = K[:, None]                      # (n,) -> (n, 1): one measurement
    Z2 = Z[:, None] if Z.ndim == 1 else Z
    B = Z2 @ K.T                                   # (T, n) inputs K z_k

    if method == "scan":
        def step(x, b):
            x2 = F @ x + b
            return x2, x2
        xT, X = jax.lax.scan(step, x0, B)
        return X, xT

    T = B.shape[0]
    Fs = jnp.broadcast_to(F, (T, *F.shape))
    # absorb the initial state into the first step's offset
    B0 = B.at[0].add(F @ x0)
    X = affine_scan(Fs, B0)
    return X, X[-1]


def make_kalman_lti(K, F, chunk: int = 256):
    """Build a jitted steady-state tracker ``apply(x0, Z) -> (X, x_T)``
    with the recurrence evaluated as matmuls via modal decomposition.

    ``K`` (n, m) and ``F`` (n, n) must be CONCRETE host arrays (design
    time, like steady_state_gain).  F = V diag(lam) V^-1 turns
    x_k = F x_{k-1} + K z_k into n independent SCALAR recurrences on the
    modal inputs u = V^-1 K z, each evaluated by
    :func:`linrec.chunked_first_order` (chunk matmul + log-depth carry
    scan) in place of the per-element (n, n) associative-scan path of
    ``kalman_lti_apply(method="parallel")``.  Falls back to that path
    when F is defective (non-diagonalizable).
    """
    K = np.atleast_2d(np.asarray(K, np.float64))
    if K.shape[0] == 1 and K.shape[1] > 1:
        K = K.T
    F = np.asarray(F, np.float64)
    n = F.shape[0]
    lam, V = np.linalg.eig(F)
    if np.linalg.cond(V) > 1e8:
        def apply_fallback(x0, Z):
            return kalman_lti_apply(x0, Z, jnp.asarray(K, jnp.float32),
                                    jnp.asarray(F, jnp.float32),
                                    method="parallel")
        return jax.jit(apply_fallback)
    Vinv = np.linalg.inv(V)
    real_modes = not np.iscomplexobj(lam) or np.max(np.abs(lam.imag)) == 0.0
    if real_modes:
        lam, V, Vinv = lam.real, V.real, Vinv.real
    # modal input map: u[m, t] = (V^-1 K z_t)[m]
    G = Vinv @ K                                  # (n, m) modal gains
    G0 = Vinv @ F                                 # folds x0 into u[:, 0]

    hi = jax.lax.Precision.HIGHEST

    @jax.jit
    def apply(x0, Z):
        Z2 = Z[:, None] if Z.ndim == 1 else Z     # (T, m) real measurements
        rdt = Z2.dtype
        # all small matmuls in REAL planes, at HIGHEST precision (see
        # linrec.chunked_first_order)
        Ur = (Z2 @ jnp.asarray(np.real(G).T).astype(rdt)).T    # (n, T)
        u0r = jnp.asarray(np.real(G0)).astype(rdt) @ x0
        Ur = Ur.at[:, 0].add(u0r)
        if real_modes:
            S = chunked_first_order(lam, Ur, chunk=chunk)      # (n, T) real
            X = jnp.matmul(S.T, jnp.asarray(V.T).astype(rdt), precision=hi)
        else:
            Ui = (Z2 @ jnp.asarray(np.imag(G).T).astype(rdt)).T
            Ui = Ui.at[:, 0].add(jnp.asarray(np.imag(G0)).astype(rdt) @ x0)
            S = chunked_first_order(lam, jax.lax.complex(Ur, Ui),
                                    chunk=chunk)
            # x_t = Re(V s_t):  Sr @ Vr.T - Si @ Vi.T
            X = (jnp.matmul(jnp.real(S).T,
                            jnp.asarray(np.real(V).T).astype(rdt),
                            precision=hi)
                 - jnp.matmul(jnp.imag(S).T,
                              jnp.asarray(np.imag(V).T).astype(rdt),
                              precision=hi))
        X = X.astype(rdt)
        return X, X[-1]

    return apply


def cv_model(dt: float, sigma_a: float, sigma_z: float):
    """Constant-velocity tracker model (position measured, white
    acceleration of std ``sigma_a``): returns (A, C, Q, R)."""
    A = np.array([[1.0, dt], [0.0, 1.0]])
    C = np.array([[1.0, 0.0]])
    # discretized white-acceleration process noise
    Q = sigma_a**2 * np.array([[dt**4 / 4, dt**3 / 2],
                               [dt**3 / 2, dt**2]])
    R = np.array([[sigma_z**2]])
    return A, C, Q, R


def alpha_beta_gains(tracking_index: float) -> tuple:
    """Kalata's closed-form steady-state gains for the constant-velocity
    tracker.  tracking_index Λ = sigma_a dt² / sigma_z.  Returns (α, β)."""
    L = float(tracking_index)
    r = (4 + L - np.sqrt(8 * L + L * L)) / 4
    alpha = 1 - r * r
    beta = 2 * (2 - alpha) - 4 * np.sqrt(1 - alpha)
    return float(alpha), float(beta)


class AlphaBetaTracker:
    """Streaming constant-velocity tracker (position in, smoothed
    position/velocity out) using the framework's block API.

    Equivalent to the steady-state Kalman filter of ``cv_model`` — the
    gains relate as α = K[0], β = K[1]·dt (pinned by tests).
    """

    def __init__(self, alpha: float, beta: float, dt: float = 1.0,
                 dtype=jnp.float32):
        self.alpha, self.beta, self.dt = float(alpha), float(beta), float(dt)
        a, b, dt_ = self.alpha, self.beta, self.dt
        # x = [pos, vel]; predict then correct with gains [a, b/dt]
        A = np.array([[1.0, dt_], [0.0, 1.0]])
        K = np.array([[a], [b / dt_]])
        C = np.array([[1.0, 0.0]])
        F = (np.eye(2) - K @ C) @ A
        self._F = jnp.asarray(F, dtype)
        self._K = jnp.asarray(K, dtype)
        self._x = jnp.zeros(2, dtype)

    def execute_block(self, z, method: str = "parallel"):
        """z: (T,) positions -> (T, 2) [pos, vel] estimates."""
        X, self._x = kalman_lti_apply(self._x, jnp.asarray(z, self._F.dtype),
                                      self._K, self._F, method=method)
        return X

    def reset(self):
        self._x = jnp.zeros_like(self._x)

    def __repr__(self):
        return (f"AlphaBetaTracker [alpha={self.alpha:.4f}] "
                f"[beta={self.beta:.4f}] [dt={self.dt}]")
