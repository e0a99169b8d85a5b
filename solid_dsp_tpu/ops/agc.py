"""AGC — automatic gain control with lock and 7-state squelch FSM.

Parity: reference ``src/auto_gain_control/mod.rs`` — execute (:214-246),
execute_block (:272-285), lock (:302-343), bandwidth (:356-386),
level/rssi/gain/scale accessors (:399-542), init (:568-586), squelch API
(:588-629), squelch FSM (:631-677).

Per-sample semantics (exactly the reference's):

    out  = x * gain
    E    = (1 - alpha) E + alpha |out|^2
    if lock: emit out
    else:
        if E > 1e-6:  gain *= exp(-alpha/2 * ln E)
        gain = min(gain, 1e6)
        update squelch FSM on rssi = -20 log10(gain)
        emit x (unscaled) if squelch mode == ENABLED else out * scale

This recurrence is data-dependent through the gain, so the exact path is a
``lax.scan`` carry (the poster-child sequential op, SURVEY §3.4); it
vectorizes over a leading channel axis, which is how it scales.  A
block-mode fast path (one gain update per block) is provided for
throughput-critical chains where per-sample gain glitches don't matter.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "SquelchMode", "agc_init", "agc_apply", "agc_apply_parallel",
    "agc_apply_block_mode", "AGC",
]


class SquelchMode:
    UNKNOWN = 0
    ENABLED = 1
    RISE = 2
    SIGNALHI = 3
    FALL = 4
    SIGNALLO = 5
    TIMEOUT = 6
    DISABLED = 7


def agc_init(dtype=jnp.float32, batch_shape: tuple = (), xp=jnp):
    """Initial AGC carry: (gain, energy, lock, squelch_mode, timer).

    ``xp=np`` builds the same structure host-side (numpy leaves) — the
    canonical constructor for code that must avoid device ops at init
    time (models/rx_chain.rx_chain_init); keep the layout changes HERE
    so host and device builders can never drift.
    """
    tree = {
        "gain": np.full(batch_shape, 1.0, dtype=np.dtype(dtype)),
        "energy": np.full(batch_shape, 1.0, dtype=np.dtype(dtype)),
        "lock": np.full(batch_shape, False),
        "mode": np.full(batch_shape, SquelchMode.DISABLED, dtype=np.int32),
        "timer": np.full(batch_shape, 0, dtype=np.int32),
    }
    if xp is np:
        return tree
    # device build: host numpy, then one transfer
    from ..utils.transfer import put_tree

    return put_tree(tree)


def _squelch_update(mode, timer, rssi, threshold, timeout):
    """Vectorized 7-state FSM (ref auto_gain_control/mod.rs:631-677)."""
    thr = rssi > threshold
    # FALL and SIGNALLO touch the timer
    timer = jnp.where(mode == SquelchMode.FALL, timeout, timer)
    timer = jnp.where(mode == SquelchMode.SIGNALLO, timer - 1, timer)

    new_mode = jnp.select(
        [
            mode == SquelchMode.ENABLED,
            mode == SquelchMode.RISE,
            mode == SquelchMode.SIGNALHI,
            mode == SquelchMode.FALL,
            mode == SquelchMode.SIGNALLO,
            mode == SquelchMode.TIMEOUT,
        ],
        [
            jnp.where(thr, SquelchMode.RISE, SquelchMode.ENABLED),
            jnp.where(thr, SquelchMode.SIGNALHI, SquelchMode.FALL),
            jnp.where(thr, SquelchMode.SIGNALHI, SquelchMode.FALL),
            jnp.where(thr, SquelchMode.SIGNALHI, SquelchMode.SIGNALLO),
            jnp.where(
                timer == 0,
                SquelchMode.TIMEOUT,
                jnp.where(thr, SquelchMode.SIGNALHI, SquelchMode.SIGNALLO),
            ),
            jnp.full_like(mode, SquelchMode.ENABLED),
        ],
        default=jnp.full_like(mode, SquelchMode.DISABLED),
    )
    return new_mode.astype(jnp.int32), timer


def _agc_scan(state, x, alpha, scale, squelch_threshold, squelch_timeout):
    """Sequential exact AGC (shared by agc_apply and the parallel fallback)."""
    x_t = jnp.moveaxis(x, -1, 0)  # (T, ...)

    def step(carry, x_n):
        gain, energy, lock, mode, timer = (
            carry["gain"], carry["energy"], carry["lock"],
            carry["mode"], carry["timer"],
        )
        out = x_n * gain.astype(x_n.dtype)
        ee = jnp.real(out * jnp.conj(out)).astype(energy.dtype)
        energy = (1.0 - alpha) * energy + ee * alpha

        # unlocked path
        gain_new = jnp.where(
            energy > 1e-6,
            gain * jnp.exp(-0.5 * alpha * jnp.log(energy)),
            gain,
        )
        gain_new = jnp.minimum(gain_new, 1e6)
        rssi = jnp.log10(gain_new) * -20.0
        mode_new, timer_new = _squelch_update(
            mode, timer, rssi, squelch_threshold, squelch_timeout
        )
        squelched = mode_new == SquelchMode.ENABLED
        out_unlocked = jnp.where(
            squelched, x_n, out * jnp.asarray(scale, dtype=x_n.dtype)
        )

        y = jnp.where(lock, out, out_unlocked)
        gain = jnp.where(lock, gain, gain_new)
        mode = jnp.where(lock, mode, mode_new)
        timer = jnp.where(lock, timer, timer_new)
        return (
            {"gain": gain, "energy": energy, "lock": lock,
             "mode": mode, "timer": timer},
            y,
        )

    new_state, y_t = jax.lax.scan(step, state, x_t)
    return jnp.moveaxis(y_t, 0, -1), new_state


@partial(jax.jit, static_argnames=())
def agc_apply(state, x, alpha, scale, squelch_threshold, squelch_timeout):
    """Exact per-sample AGC over a block via lax.scan.

    state: carry dict from agc_init (scalars or batched over channels);
    x: (..., T) with time as the LAST axis (scanned); leading axes vectorize.
    Returns (y, new_state).
    """
    return _agc_scan(state, x, alpha, scale, squelch_threshold, squelch_timeout)


def _newton_combine(left, right):
    """(A2, b2) o (A1, b1) = (A2 A1, A2 b1 + b2) for 2x2 linear recurrences.

    The affine maps ride as a 6-tuple of (T,) scalar arrays
    (a11, a12, a21, a22, b1, b2) rather than (T, 2, 2)/(T, 2) tensors:
    the tiny-matmul/einsum form would relayout 2x2-minor arrays, while
    this is pure elementwise FMA work at every scan level.
    """
    a11, a12, a21, a22, b1, b2 = left
    c11, c12, c21, c22, d1, d2 = right
    return (
        c11 * a11 + c12 * a21, c11 * a12 + c12 * a22,
        c21 * a11 + c22 * a21, c21 * a12 + c22 * a22,
        c11 * b1 + c12 * b2 + d1,
        c21 * b1 + c22 * b2 + d2,
    )


def _affine1_scan(a, b):
    """Prefix of the scalar recurrence s[t] = a[t] s[t-1] + b[t]
    (s[-1] folded into b[0]) via associative_scan — O(log T) depth,
    elementwise combines only."""
    def comb(l, r):
        al, bl = l
        ar, br = r
        return ar * al, ar * bl + br

    _, s = jax.lax.associative_scan(comb, (a, b))
    return s


@partial(jax.jit, static_argnames=("newton_iters", "coarse_stride"))
def agc_apply_parallel(state, x, alpha, scale, squelch_threshold,
                       squelch_timeout, newton_iters: int = 24,
                       coarse_stride: int = 32):
    """Exact-semantics AGC solved block-parallel (the fast exact path).

    The reference recurrence (auto_gain_control/mod.rs:214-246)

        E_n = (1-a) E_{n-1} + a |x_n|^2 g_{n-1}^2
        g_n = g_{n-1} * E_n^{-a/2}

    is NONLINEAR (energy couples to gain through |x*g|^2), so unlike the NCO
    phase it has no closed form.  But it is a smooth 2-state recurrence in
    s = (E, ln g), so we solve it with a Newton/DEER iteration: linearize the
    whole-trajectory fixed-point equation s_{n+1} = f(s_n, u_n) around a
    coarse guess, solve each correction pass delta_n = A_n delta_{n-1} + r_n
    with a 2x2 ``associative_scan`` (O(log T) depth, fully parallel), and
    repeat ``newton_iters`` times.  The squelch FSM does NOT feed back into
    the gain (mod.rs:240 runs after the gain update and only selects the
    output), so it is applied afterwards — skipped entirely when squelch is
    DISABLED, else as a cheap int-only scan.

    Exactness: if the final Newton residual exceeds tolerance, or the
    trajectory approaches either reference gate (E <= 1e-6 skip-update,
    g >= 1e6 clamp), we ``lax.cond``-fall back to the sequential scan, so the
    function always returns reference semantics.  Scalar (unbatched) state
    only; vmap for channel batches.

    Returns (y, new_state) like agc_apply.
    """
    rdt = state["energy"].dtype
    T = x.shape[-1]
    alpha = jnp.asarray(alpha, rdt)
    scale_c = jnp.asarray(scale, dtype=x.dtype)
    u = jnp.real(x * jnp.conj(x)).astype(rdt)
    tiny = jnp.asarray(np.finfo(np.dtype(rdt)).tiny * 1e3, rdt)
    eps = np.finfo(np.dtype(rdt)).eps
    tol = jnp.asarray(np.sqrt(eps), rdt)
    one_m = 1.0 - alpha

    def locked_branch(_):
        # gain frozen: y = x*g exactly; E_T is a plain weighted reduction
        g0 = state["gain"]
        y = x * g0.astype(x.dtype)
        kk = jnp.arange(T - 1, -1, -1, dtype=rdt)
        w = jnp.power(one_m, kk)
        e_t = jnp.power(one_m, jnp.asarray(T, rdt)) * state["energy"] \
            + alpha * g0 * g0 * jnp.dot(w, u)
        return y, {**state, "energy": e_t}

    def unlocked_branch(_):
        G0 = jnp.log(jnp.maximum(state["gain"], tiny))
        F0 = jnp.log(jnp.maximum(state["energy"], tiny))
        ln_clamp = jnp.asarray(np.log(1e6), rdt)

        # ---- coarse initializer: per-group fixed-point blend -------------
        # Within a stride-S group the AGC relaxes toward its fixed point
        # (E* = 1, g* = 1/sqrt(ubar)); blend entry state toward it at the
        # per-sample contraction rate (1-alpha)^S.  Rough is fine — the
        # clipped Newton iteration below repairs O(1) init errors.
        S = coarse_stride
        Tc = -(-T // S)
        u_pad = jnp.pad(u, (0, Tc * S - T)).reshape(Tc, S)
        ubar = jnp.mean(u_pad, axis=-1)
        rho = jnp.power(one_m, jnp.asarray(S, rdt))
        lnu = jnp.log(jnp.maximum(ubar, tiny))

        # both coarse recurrences are scalar AFFINE in the carry
        # (G_i = rho G_{i-1} + (1-rho) g_fp_i, then F given G), so they
        # parallelize as O(log Tc) associative scans instead of a
        # sequential lax.scan of ~Tc loop steps.
        g_fp = jnp.minimum(-0.5 * lnu, ln_clamp)
        aG = jnp.full_like(g_fp, rho)
        bG = (1.0 - rho) * g_fp
        bG = bG.at[0].add(rho * G0)
        Gc = _affine1_scan(aG, bG)
        f_t = lnu + 2.0 * Gc
        bF = (1.0 - rho) * f_t
        bF = bF.at[0].add(rho * F0)
        Fc = _affine1_scan(aG, bF)
        Fhat = jnp.repeat(Fc, S)[:T]
        Ghat = jnp.repeat(Gc, S)[:T]

        # ---- clipped Newton/DEER in log-energy coordinates ---------------
        # f(F,G) = (ln((1-a)e^F + a u e^{2G}),  G - a/2 * fF); the log-domain
        # Jacobian entries are bounded in (0,2) so the linearized correction
        # recurrence cannot overflow, and a trust-region clip of 2.0 keeps
        # far-from-basin steps sane.
        def f_eval(Fh, Gh):
            F_in = jnp.concatenate([F0[None], Fh[:-1]])
            G_in = jnp.concatenate([G0[None], Gh[:-1]])
            t1 = one_m * jnp.exp(F_in)
            t2 = alpha * u * jnp.exp(2.0 * G_in)
            den = jnp.maximum(t1 + t2, tiny)
            fF = jnp.log(den)
            fG = G_in - 0.5 * alpha * fF
            j11 = t1 / den
            j12 = 2.0 * t2 / den
            return G_in, fF, fG, j11, j12

        tol_iter = jnp.asarray(100.0 * eps, rdt)

        def newton_cond(carry):
            _, _, res, it = carry
            return (res > tol_iter) & (it < newton_iters)

        def newton_body(carry):
            Fh, Gh, _, it = carry
            _, fF, fG, j11, j12 = f_eval(Fh, Gh)
            rF = fF - Fh
            rG = fG - Gh
            dF, dG = jax.lax.associative_scan(
                _newton_combine,
                (j11, j12, -0.5 * alpha * j11, 1.0 - 0.5 * alpha * j12,
                 rF, rG))[4:]
            Fh = Fh + jnp.clip(dF, -2.0, 2.0)
            Gh = Gh + jnp.clip(dG, -2.0, 2.0)
            res = jnp.maximum(jnp.max(jnp.abs(rF)), jnp.max(jnp.abs(rG)))
            return Fh, Gh, res, it + 1

        Fhat, Ghat, _, _ = jax.lax.while_loop(
            newton_cond, newton_body,
            (Fhat, Ghat, jnp.asarray(np.inf, rdt), jnp.asarray(0, jnp.int32)),
        )

        G_in, fF, fG, _, _ = f_eval(Fhat, Ghat)
        res_f = jnp.max(jnp.abs(fF - Fhat))
        res_g = jnp.max(jnp.abs(fG - Ghat))
        ln_gate = jnp.asarray(np.log(1.01e-6), rdt)
        bad = (
            (res_f > tol) | (res_g > tol)
            | jnp.isnan(res_f) | jnp.isnan(res_g)
            | (jnp.min(fF) <= ln_gate)           # E<=1e-6 gate skips updates
            | (jnp.max(Ghat) >= ln_clamp - 10 * eps)  # gain clamp at 1e6
        )

        # ---- squelch FSM (output-select only; gains already solved) ----
        mode0, timer0 = state["mode"], state["timer"]

        def fsm_run(_):
            rssi = Ghat * jnp.asarray(-20.0 / np.log(10.0), rdt)

            def fsm_step(carry, rssi_n):
                m, t = carry
                m_new, t_new = _squelch_update(
                    m, t, rssi_n, squelch_threshold, squelch_timeout
                )
                return (m_new, t_new), m_new

            (m_t, t_t), modes = jax.lax.scan(fsm_step, (mode0, timer0), rssi)
            return modes, m_t, t_t

        def fsm_skip(_):
            return jnp.broadcast_to(mode0, (T,)), mode0, timer0

        modes, mode_t, timer_t = jax.lax.cond(
            mode0 == SquelchMode.DISABLED, fsm_skip, fsm_run, None
        )

        def newton_result(_):
            out = x * jnp.exp(G_in).astype(x.dtype)
            y = jnp.where(modes == SquelchMode.ENABLED, x, out * scale_c)
            new_state = {
                "gain": jnp.exp(Ghat[-1]).astype(rdt),
                "energy": jnp.exp(fF[-1]).astype(rdt),
                "lock": state["lock"],
                "mode": mode_t,
                "timer": timer_t,
            }
            return y, new_state

        def scan_fallback(_):
            return _agc_scan(state, x, alpha, scale,
                             squelch_threshold, squelch_timeout)

        return jax.lax.cond(bad, scan_fallback, newton_result, None)

    return jax.lax.cond(state["lock"], locked_branch, unlocked_branch, None)


def block_gain_update(state, ee, alpha, T):
    """Shared block-mode gain/energy update rule.

    ``ee`` is the (batched) mean |out|^2 over the T-sample block; single-chip
    and sharded block AGC both funnel through this so their semantics cannot
    drift (the sharded variant supplies a globally pmean-ed ``ee``).
    """
    gain = state["gain"]
    beta = 1.0 - (1.0 - alpha) ** T
    energy = (1.0 - beta) * state["energy"] + beta * ee
    gain = jnp.where(energy > 1e-6,
                     gain * jnp.exp(-0.5 * jnp.log(energy)), gain)
    gain = jnp.minimum(gain, 1e6)
    return {**state, "gain": gain, "energy": energy}


@jax.jit
def agc_apply_block_mode(state, x, alpha):
    """Fast block-mode AGC: one gain update per block (accelerator-native variant).

    Uses the block RMS for the energy estimate and applies a single gain to
    the whole block; converges like the reference with bandwidth ~ alpha*T.
    No squelch/lock handling — compose with agc_apply when those matter.
    """
    gain = state["gain"]
    # gain has the batch shape of x's leading dims; broadcast over time
    out = x * gain.astype(x.dtype)[..., None] if gain.ndim else x * gain.astype(x.dtype)
    ee = jnp.mean(jnp.real(out * jnp.conj(out)), axis=-1)
    return out, block_gain_update(state, ee, alpha, x.shape[-1])


class AGC:
    """Stateful AGC with the reference's API shape (ref auto_gain_control).

    method: "scan" (sequential exact) or "parallel" (exact semantics via the
    Newton solve with automatic scan fallback).
    """

    def __init__(self, dtype=None, method: str = "scan"):
        if method not in ("scan", "parallel"):
            raise ValueError(f"unknown AGC method {method!r}")
        self._method = method
        self._dtype = dtype or (jnp.float64 if jax.config.jax_enable_x64
                                else jnp.float32)
        self.bandwidth = 0.1
        self.alpha = 0.1
        self.scale = 1.0
        self.squelch_threshold = 0.0
        self.squelch_timeout = 100
        self._st = agc_init(self._dtype)

    # --- reference accessors -------------------------------------------
    def reset(self) -> None:
        mode = int(self._st["mode"])
        new = agc_init(self._dtype)
        if mode != SquelchMode.DISABLED:
            new["mode"] = jnp.asarray(SquelchMode.ENABLED, dtype=jnp.int32)
        self._st = new

    def lock(self) -> None:
        self._st = {**self._st, "lock": jnp.asarray(True)}

    def unlock(self) -> None:
        self._st = {**self._st, "lock": jnp.asarray(False)}

    def is_unlocked(self) -> bool:
        # parity quirk: the reference's is_unlocked returns the lock flag
        # itself (true when locked) — auto_gain_control/mod.rs:339-343
        return bool(self._st["lock"])

    def get_bandwidth(self) -> float:
        return self.bandwidth

    def set_bandwidth(self, bw: float) -> float:
        if not (0.0 <= bw <= 1.0):
            raise ValueError("bandwidth not in range [0, 1]")
        self.bandwidth = bw
        self.alpha = bw
        return bw

    def get_signal_level(self) -> float:
        return 1.0 / float(self._st["gain"])

    def set_signal_level(self, level: float) -> float:
        if level <= 0.0:
            raise ValueError("level is too low (0, inf)")
        self._st = {**self._st,
                    "gain": jnp.asarray(1.0 / level, dtype=self._dtype),
                    "energy": jnp.asarray(1.0, dtype=self._dtype)}
        return level

    def get_rssi(self) -> float:
        return float(np.log10(float(self._st["gain"])) * -20.0)

    def set_rssi(self, rssi: float) -> None:
        gain = max(10.0 ** (-rssi / 20.0), 1e-16)
        self._st = {**self._st,
                    "gain": jnp.asarray(gain, dtype=self._dtype),
                    "energy": jnp.asarray(1.0, dtype=self._dtype)}

    def get_gain(self) -> float:
        return float(self._st["gain"])

    def set_gain(self, gain: float) -> float:
        if gain <= 0.0:
            raise ValueError("gain is below threshold (0, inf)")
        self._st = {**self._st, "gain": jnp.asarray(gain, dtype=self._dtype)}
        return gain

    def get_scale(self) -> float:
        return self.scale

    def set_scale(self, scale: float) -> float:
        if scale <= 0.0:
            raise ValueError("scale is below threshold (0, inf)")
        self.scale = scale
        return scale

    def init(self, samples) -> float:
        """Seed gain from the RMS of a block (ref :568-586)."""
        samples = np.asarray(samples)
        if samples.size == 0:
            raise ValueError("need more than 0 samples to operate")
        # naive sequential accumulation for bit-parity with the reference's
        # loop (auto_gain_control/mod.rs:578-583); init is setup-time only
        e2 = np.real(samples * np.conj(samples)).astype(np.float64)
        x2 = 0.0
        for v in e2:
            x2 += float(v)
        level = np.sqrt(x2 / samples.size) + 1e-16
        return self.set_signal_level(level)

    # --- squelch ----------------------------------------------------------
    def squelch_enable(self) -> None:
        self._st = {**self._st,
                    "mode": jnp.asarray(SquelchMode.ENABLED, dtype=jnp.int32)}

    def squelch_disable(self) -> None:
        self._st = {**self._st,
                    "mode": jnp.asarray(SquelchMode.DISABLED, dtype=jnp.int32)}

    def is_squelch_enabled(self) -> bool:
        return int(self._st["mode"]) != SquelchMode.DISABLED

    def squelch_get_threshold(self) -> float:
        return self.squelch_threshold

    def squelch_set_threshold(self, t: float) -> None:
        self.squelch_threshold = t

    def squelch_get_timeout(self) -> int:
        return self.squelch_timeout

    def squelch_set_timeout(self, t: int) -> None:
        self.squelch_timeout = t

    def squelch_get_mode(self) -> int:
        return int(self._st["mode"])

    # --- execution ----------------------------------------------------------
    def execute_block(self, samples):
        samples = jnp.asarray(samples)
        fn = agc_apply_parallel if self._method == "parallel" else agc_apply
        y, self._st = fn(
            self._st, samples, self.alpha, self.scale,
            self.squelch_threshold, self.squelch_timeout,
        )
        return y

    def execute(self, sample):
        return self.execute_block(jnp.asarray([sample]))[0]

    def __repr__(self) -> str:
        return (
            f"AGC [Gain={self.get_gain():.5f}] [Scale={self.scale:.5f}] "
            f"[Bandwidth={self.bandwidth:.5f}] [Alpha={self.alpha:.5f}] "
            f"[Energy={float(self._st['energy']):.5f}]"
        )
