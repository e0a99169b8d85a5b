"""Kalman filtering: scan vs independent numpy, steady-state/LTI forms,
alpha-beta closed form, tracking behavior."""

import jax.numpy as jnp
import numpy as np

from solid_dsp_tpu.ops.kalman import (
    AlphaBetaTracker,
    alpha_beta_gains,
    cv_model,
    kalman_apply,
    kalman_init,
    kalman_lti_apply,
    steady_state_gain,
)


def _np_kalman(x0, P0, Z, A, C, Q, R):
    """Independent per-sample numpy Kalman filter."""
    x, P = x0.copy(), P0.copy()
    n = len(x0)
    out = []
    for z in Z:
        xp = A @ x
        Pp = A @ P @ A.T + Q
        S = C @ Pp @ C.T + R
        K = Pp @ C.T @ np.linalg.inv(S)
        x = xp + K @ (z - C @ xp)
        P = (np.eye(n) - K @ C) @ Pp
        out.append(x.copy())
    return np.array(out), x, P


def _sim_cv(T=400, dt=1.0, sigma_a=0.05, sigma_z=1.0, seed=0):
    rng = np.random.default_rng(seed)
    pos, vel = 0.0, 0.7
    traj, meas = [], []
    for _ in range(T):
        vel += sigma_a * dt * rng.standard_normal()
        pos += vel * dt
        traj.append([pos, vel])
        meas.append(pos + sigma_z * rng.standard_normal())
    return np.array(traj), np.array(meas)[:, None]


def test_kalman_scan_matches_numpy():
    A, C, Q, R = cv_model(1.0, 0.05, 1.0)
    _, Z = _sim_cv()
    x0 = np.zeros(2)
    P0 = 10.0 * np.eye(2)
    X_np, xf_np, _ = _np_kalman(x0, P0, Z, A, C, Q, R)

    state = kalman_init(jnp.asarray(x0), jnp.asarray(P0))
    X, (xf, Pf) = kalman_apply(state, jnp.asarray(Z), A, C, Q, R)
    np.testing.assert_allclose(np.asarray(X), X_np, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(np.asarray(xf), xf_np, rtol=1e-8)


def test_kalman_block_continuity():
    """Two half blocks == one full block (state carry is exact)."""
    A, C, Q, R = cv_model(1.0, 0.05, 1.0)
    _, Z = _sim_cv(seed=3)
    st = kalman_init(jnp.zeros(2), 10.0 * jnp.eye(2))
    Xa, st2 = kalman_apply(st, jnp.asarray(Z[:200]), A, C, Q, R)
    Xb, _ = kalman_apply(st2, jnp.asarray(Z[200:]), A, C, Q, R)
    st = kalman_init(jnp.zeros(2), 10.0 * jnp.eye(2))
    Xf, _ = kalman_apply(st, jnp.asarray(Z), A, C, Q, R)
    np.testing.assert_allclose(
        np.concatenate([np.asarray(Xa), np.asarray(Xb)]), np.asarray(Xf),
        rtol=1e-6, atol=1e-8)


def test_steady_state_gain_is_riccati_fixed_point():
    """Time-varying filter's gain converges to K_inf; the LTI filter with
    (K_inf, F) tracks the full filter after the transient."""
    A, C, Q, R = cv_model(1.0, 0.05, 1.0)
    K, F = steady_state_gain(A, C, Q, R)
    np.testing.assert_allclose(F, (np.eye(2) - K @ C) @ A, rtol=1e-12)

    _, Z = _sim_cv(T=600, seed=1)
    st = kalman_init(jnp.zeros(2), 10.0 * jnp.eye(2))
    X_full, _ = kalman_apply(st, jnp.asarray(Z), A, C, Q, R)
    X_lti, _ = kalman_lti_apply(jnp.zeros(2), jnp.asarray(Z), K, F,
                                method="scan")
    # identical asymptotically (after the Riccati transient dies out)
    np.testing.assert_allclose(np.asarray(X_full)[200:],
                               np.asarray(X_lti)[200:], atol=1e-3)


def test_lti_parallel_equals_scan():
    A, C, Q, R = cv_model(1.0, 0.05, 1.0)
    K, F = steady_state_gain(A, C, Q, R)
    _, Z = _sim_cv(T=1024, seed=2)
    Xp, xp = kalman_lti_apply(jnp.asarray(np.array([0.3, -0.1])),
                              jnp.asarray(Z), K, F, method="parallel")
    Xs, xs = kalman_lti_apply(jnp.asarray(np.array([0.3, -0.1])),
                              jnp.asarray(Z), K, F, method="scan")
    np.testing.assert_allclose(np.asarray(Xp), np.asarray(Xs),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(xp), np.asarray(xs),
                               rtol=1e-4, atol=1e-4)


def test_alpha_beta_equals_steady_state_kalman():
    """Kalata closed form == Riccati fixed point: alpha = K[0],
    beta = K[1] * dt, for several tracking indices."""
    dt = 1.0
    for sigma_a, sigma_z in [(0.05, 1.0), (0.5, 1.0), (0.01, 2.0)]:
        A, C, Q, R = cv_model(dt, sigma_a, sigma_z)
        K, _ = steady_state_gain(A, C, Q, R)
        L = sigma_a * dt**2 / sigma_z
        alpha, beta = alpha_beta_gains(L)
        assert abs(alpha - K[0, 0]) < 1e-6, (sigma_a, sigma_z)
        assert abs(beta - K[1, 0] * dt) < 1e-6, (sigma_a, sigma_z)


def test_alpha_beta_tracker_smooths_and_finds_velocity():
    traj, Z = _sim_cv(T=2000, sigma_a=0.02, sigma_z=1.0, seed=5)
    alpha, beta = alpha_beta_gains(0.02)
    trk = AlphaBetaTracker(alpha, beta)
    X = np.asarray(trk.execute_block(Z[:, 0].astype(np.float32)))
    # velocity estimate converges near the true (slowly wandering) velocity
    assert abs(float(np.mean(X[1000:, 1])) - float(np.mean(traj[1000:, 1]))) < 0.1
    # smoothed position beats the raw measurements
    e_raw = float(np.mean((Z[1000:, 0] - traj[1000:, 0]) ** 2))
    e_flt = float(np.mean((X[1000:, 0] - traj[1000:, 0]) ** 2))
    assert e_flt < e_raw / 2


def test_alpha_beta_block_continuity_parallel():
    _, Z = _sim_cv(T=1000, seed=6)
    z = Z[:, 0].astype(np.float32)
    alpha, beta = alpha_beta_gains(0.05)
    t1 = AlphaBetaTracker(alpha, beta)
    Xa = np.asarray(t1.execute_block(z[:500]))
    Xb = np.asarray(t1.execute_block(z[500:]))
    t2 = AlphaBetaTracker(alpha, beta)
    Xf = np.asarray(t2.execute_block(z))
    np.testing.assert_allclose(np.concatenate([Xa, Xb]), Xf,
                               rtol=1e-4, atol=1e-4)


def test_rts_smoother_matches_reference_and_beats_filter():
    from solid_dsp_tpu.ops.kalman import rts_smooth

    rng = np.random.default_rng(0)
    A, C, Q, R = cv_model(1.0, 0.05, 1.0)
    T = 400
    x = np.zeros(2)
    truth = []
    for _ in range(T):
        x = A @ x + np.array([0.5, 1.0]) * 0.05 * rng.standard_normal()
        truth.append(x.copy())
    truth = np.array(truth)
    z = truth[:, 0] + rng.standard_normal(T)

    st = kalman_init(np.zeros(2), np.eye(2) * 10)
    Xf, _ = kalman_apply(st, jnp.asarray(z), A, C, Q, R)
    Xs, Ps = rts_smooth(st, jnp.asarray(z), A, C, Q, R)
    Xf, Xs, Ps = np.asarray(Xf), np.asarray(Xs), np.asarray(Ps)

    # literal textbook forward/backward recursion in numpy
    xk, P = np.zeros(2), np.eye(2) * 10
    xf, Pf, xp, Pp = [], [], [], []
    for t in range(T):
        xpr, Ppr = A @ xk, A @ P @ A.T + Q
        S = C @ Ppr @ C.T + R
        K = Ppr @ C.T @ np.linalg.inv(S)
        xk = xpr + K @ (np.atleast_1d(z[t]) - C @ xpr)
        P = (np.eye(2) - K @ C) @ Ppr
        xf.append(xk), Pf.append(P), xp.append(xpr), Pp.append(Ppr)
    xs, Ps_ref = [None] * T, [None] * T
    xs[-1], Ps_ref[-1] = xf[-1], Pf[-1]
    for t in range(T - 2, -1, -1):
        G = Pf[t] @ A.T @ np.linalg.inv(Pp[t + 1])
        xs[t] = xf[t] + G @ (xs[t + 1] - xp[t + 1])
        Ps_ref[t] = Pf[t] + G @ (Ps_ref[t + 1] - Pp[t + 1]) @ G.T

    np.testing.assert_allclose(Xs, np.array(xs), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(Ps, np.array(Ps_ref), rtol=1e-9, atol=1e-9)
    # smoothing uses future data: strictly better position MSE, and the
    # final step coincides with the filter
    assert (np.mean((Xs[:, 0] - truth[:, 0]) ** 2)
            < 0.6 * np.mean((Xf[:, 0] - truth[:, 0]) ** 2))
    np.testing.assert_allclose(Xs[-1], Xf[-1], rtol=1e-9)
    # smoothed covariances are no larger than filtered ones (trace)
    tr_s = Ps[:, 0, 0] + Ps[:, 1, 1]
    assert np.all(tr_s <= np.array([p[0, 0] + p[1, 1] for p in Pf]) + 1e-9)


def test_chunked_first_order_matches_scan():
    """linrec.chunked_first_order vs the literal recurrence, real and
    complex modes, T not a multiple of the chunk."""
    from solid_dsp_tpu.ops.linrec import chunked_first_order

    rng = np.random.default_rng(3)
    T = 1234
    for lam in (0.93, 0.7 + 0.6j, -0.4):
        cx = np.iscomplexobj(np.asarray(lam))
        u = rng.standard_normal(T) + (1j * rng.standard_normal(T) if cx
                                      else 0.0)
        s_ref = np.empty(T, complex)
        s = 0.0
        for t in range(T):
            s = lam * s + u[t]
            s_ref[t] = s
        got = np.asarray(chunked_first_order(
            np.asarray([lam]), jnp.asarray(u)[None, :], chunk=128))[0]
        np.testing.assert_allclose(got, s_ref.real if not cx else s_ref,
                                   rtol=1e-10, atol=1e-10)


def test_make_kalman_lti_matches_scan():
    """Modal chunked evaluation == sequential scan (the matrix units fast path)."""
    from solid_dsp_tpu.ops.kalman import make_kalman_lti

    K, F = steady_state_gain(*cv_model(1.0, 0.05, 1.0))
    rng = np.random.default_rng(5)
    z = jnp.asarray(rng.standard_normal(5000))
    x0 = jnp.asarray(np.array([0.3, -0.2]))
    Xs, xs_T = kalman_lti_apply(x0, z, jnp.asarray(K), jnp.asarray(F),
                                method="scan")
    Xc, xc_T = make_kalman_lti(K, F)(x0, z)
    np.testing.assert_allclose(np.asarray(Xc), np.asarray(Xs),
                               rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(np.asarray(xc_T), np.asarray(xs_T),
                               rtol=1e-9, atol=1e-9)


def test_make_kalman_lti_real_modes():
    """A real-eigenvalue F exercises the all-real modal path."""
    from solid_dsp_tpu.ops.kalman import make_kalman_lti

    F = np.array([[0.9, 0.05], [0.0, 0.6]])
    K = np.array([[0.4], [0.1]])
    rng = np.random.default_rng(6)
    z = jnp.asarray(rng.standard_normal(3000))
    x0 = jnp.asarray(np.array([1.0, 0.5]))
    Xs, _ = kalman_lti_apply(x0, z, jnp.asarray(K), jnp.asarray(F),
                             method="scan")
    Xc, _ = make_kalman_lti(K, F)(x0, z)
    np.testing.assert_allclose(np.asarray(Xc), np.asarray(Xs),
                               rtol=1e-9, atol=1e-9)
