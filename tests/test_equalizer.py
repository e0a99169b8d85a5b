"""Adaptive equalizer: LMS convergence + optax training step."""

import jax.numpy as jnp
import numpy as np

from solid_dsp_tpu.models.equalizer import (
    LMSEqualizer,
    eq_apply,
    eq_init,
    make_equalizer_trainer,
)


def _channel(x, h):
    """Apply a multipath channel h (causal FIR) to x."""
    return np.convolve(x, h)[: len(x)]


def _qpsk_syms(n, seed=0):
    rng = np.random.default_rng(seed)
    return ((rng.integers(0, 2, n) * 2 - 1)
            + 1j * (rng.integers(0, 2, n) * 2 - 1)) / np.sqrt(2)


def test_lms_converges_on_multipath():
    h = np.array([1.0, 0.0, 0.35 - 0.2j, 0.0, -0.1j])
    tx = _qpsk_syms(20000)
    rx = _channel(tx, h).astype(np.complex64)

    eq = LMSEqualizer(ntaps=11, mu=0.1)
    B = 1000
    delay = 11 // 2
    mse = []
    for b in range(len(tx) // B):
        x = rx[b * B: (b + 1) * B]
        # training reference: transmitted symbols aligned to the equalizer
        # delay (decision-directed would work the same once open-eyed)
        d = np.roll(tx, delay)[b * B: (b + 1) * B]
        y = np.asarray(eq.execute_block(x, d))
        mse.append(float(np.mean(np.abs(y - d) ** 2)))
    assert mse[-1] < 0.01
    assert mse[-1] < mse[0] / 10


def test_eq_apply_streaming_continuity():
    taps, tail = eq_init(7)
    taps = taps.at[2].set(0.5 - 0.25j)
    rng = np.random.default_rng(3)
    x = (rng.standard_normal(256) + 1j * rng.standard_normal(256)).astype(
        np.complex64)
    ya, tail2 = eq_apply(taps, tail, jnp.asarray(x[:128]))
    yb, _ = eq_apply(taps, tail2, jnp.asarray(x[128:]))
    yfull, _ = eq_apply(taps, jnp.zeros_like(tail), jnp.asarray(x))
    np.testing.assert_allclose(
        np.concatenate([np.asarray(ya), np.asarray(yb)]),
        np.asarray(yfull), atol=1e-6)


def test_optax_trainer_reduces_loss():
    h = np.array([1.0, 0.3 + 0.1j, -0.15])
    tx = _qpsk_syms(8000, seed=5)
    rx = _channel(tx, h).astype(np.complex64)

    init, train_step = make_equalizer_trainer(9)
    taps, opt_state, tail = init()
    B = 500
    delay = 9 // 2
    losses = []
    for b in range(len(tx) // B):
        x = jnp.asarray(rx[b * B: (b + 1) * B])
        d = jnp.asarray(np.roll(tx, delay)[b * B: (b + 1) * B],
                        jnp.complex64)
        y, taps, opt_state, tail, loss = train_step(taps, opt_state, tail,
                                                    x, d)
        losses.append(float(loss))
    assert losses[-1] < losses[0] / 5
    assert losses[-1] < 0.05


# ---------------------------------------------------------------- r2: RLS


def _per_sample_rls_taps(x, d, n, lam, delta):
    """Independent per-sample RLS via direct normal-equation accumulation
    (complex128): R <- lam R + conj(v) v^T, p <- lam p + conj(v) d."""
    R = delta * np.eye(n, dtype=np.complex128)
    p = np.zeros(n, dtype=np.complex128)
    xp = np.concatenate([np.zeros(n - 1, np.complex128),
                         x.astype(np.complex128)])
    for t in range(len(x)):
        v = xp[t: t + n]                       # window, newest last
        R = lam * R + np.outer(np.conj(v), v)
        p = lam * p + np.conj(v) * d[t]
    return np.linalg.solve(R, p)


def test_rls_block_form_matches_per_sample_reference():
    """The matmul block normal-equation accumulation is algebraically equal to
    per-sample exponentially-weighted RLS at block boundaries."""
    from solid_dsp_tpu.models.equalizer import make_rls

    rng = np.random.default_rng(11)
    n, lam, delta = 7, 0.995, 1e-2
    x = (rng.standard_normal(600) + 1j * rng.standard_normal(600))
    d = (rng.standard_normal(600) + 1j * rng.standard_normal(600))

    init, step = make_rls(n, lam, delta, dtype=jnp.complex128)
    R, p, tail = init()
    B = 200
    for b in range(3):
        _, R, p, tail = step(R, p, tail,
                             jnp.asarray(x[b * B:(b + 1) * B]),
                             jnp.asarray(d[b * B:(b + 1) * B]))
    w_block = np.asarray(jnp.linalg.solve(R, p))
    w_ref = _per_sample_rls_taps(x, d, n, lam, delta)
    np.testing.assert_allclose(w_block, w_ref, rtol=1e-9, atol=1e-11)


def test_rls_converges_faster_than_lms():
    from solid_dsp_tpu.models.equalizer import RLSEqualizer

    h = np.array([1.0, 0.0, 0.35 - 0.2j, 0.0, -0.1j])
    tx = _qpsk_syms(4000, seed=2)
    rx = _channel(tx, h).astype(np.complex64)
    n, B, delay = 11, 500, 11 // 2
    d_all = np.roll(tx, delay)

    rls = RLSEqualizer(ntaps=n, lam=0.9999)
    lms = LMSEqualizer(ntaps=n, mu=0.1)
    mse_rls, mse_lms = [], []
    for b in range(len(tx) // B):
        x = rx[b * B:(b + 1) * B]
        d = d_all[b * B:(b + 1) * B]
        mse_rls.append(float(np.mean(np.abs(
            np.asarray(rls.execute_block(x, d)) - d) ** 2)))
        mse_lms.append(float(np.mean(np.abs(
            np.asarray(lms.execute_block(x, d)) - d) ** 2)))
    # RLS reaches its floor within the FIRST block (incl. startup transient)
    assert mse_rls[0] < 0.02
    assert mse_rls[0] < mse_lms[0] / 5
    assert mse_rls[-1] < 0.01


def test_nlms_scale_invariance():
    """Same dimensionless mu converges for inputs scaled by 1000x."""
    from solid_dsp_tpu.models.equalizer import eq_init, nlms_step

    h = np.array([1.0, 0.3 + 0.1j, -0.15])
    tx = _qpsk_syms(8000, seed=7)
    n, B, delay = 9, 500, 9 // 2
    d_all = np.roll(tx, delay)

    finals = []
    for scale in (1.0, 1000.0):
        rx = (_channel(tx, h) * scale).astype(np.complex64)
        taps, tail = eq_init(n)
        mse = None
        for b in range(len(tx) // B):
            x = jnp.asarray(rx[b * B:(b + 1) * B])
            d = jnp.asarray(d_all[b * B:(b + 1) * B] * scale, jnp.complex64)
            y, taps, tail = nlms_step(taps, tail, x, d, mu=0.5)
            mse = float(np.mean(np.abs(np.asarray(y) - np.asarray(d)) ** 2))
        finals.append(mse / scale**2)
        assert mse / scale**2 < 0.05, f"scale={scale}"
    # the normalized trajectories are identical regardless of input scale
    assert abs(finals[0] - finals[1]) < 1e-4 * finals[0] + 1e-9


def test_cma_blind_then_decision_directed():
    """CMA opens the eye with no training symbols; DD-LMS finishes the job.
    QPSK through multipath; check modulus error then phase-aligned SER."""
    from solid_dsp_tpu.models.equalizer import CMAEqualizer
    from solid_dsp_tpu.models.linear_mod import psk_constellation

    h = np.array([1.0, 0.0, 0.3 - 0.15j, 0.0, -0.08j])
    tx = _qpsk_syms(30000, seed=4)
    rx = _channel(tx, h).astype(np.complex64)
    n, B = 11, 1000
    points = psk_constellation(4)  # already (+-1 +-1j)/sqrt2

    eq = CMAEqualizer(ntaps=n, mu=0.2, r2=1.0)
    nb = len(tx) // B
    for b in range(nb // 2):                       # blind phase
        y = eq.execute_block(rx[b * B:(b + 1) * B])
    for b in range(nb // 2, nb):                   # decision-directed phase
        y = np.asarray(eq.execute_block(rx[b * B:(b + 1) * B],
                                        points=points))
    # modulus restored
    assert float(np.mean((np.abs(y) ** 2 - 1.0) ** 2)) < 0.05
    # align delay + phase (CMA leaves both ambiguous), then slice
    last_tx = tx[(nb - 1) * B: nb * B]
    best = (1e9, None)
    for dly in range(n + 1):
        ref = np.roll(tx, dly)[(nb - 1) * B: nb * B]
        rot = np.mean(y * np.conj(ref))
        if abs(rot) > 1e-9:
            err = float(np.mean(np.abs(y / (rot / abs(rot)) - ref) ** 2))
            best = min(best, (err, dly))
    assert best[0] < 0.1, f"post-CMA MSE {best}"


class TestFDAF:
    def _channel(self, rng, n=90):
        h = ((rng.standard_normal(n) + 1j * rng.standard_normal(n))
             * np.exp(-0.08 * np.arange(n)))
        return h / np.linalg.norm(h)

    def test_identifies_unknown_channel(self):
        from solid_dsp_tpu.models.equalizer import FDAFCanceller
        rng = np.random.default_rng(0)
        h = self._channel(rng)
        N = 40000
        x = (rng.standard_normal(N)
             + 1j * rng.standard_normal(N)).astype(np.complex64)
        d = np.convolve(x, h)[:N]
        c = FDAFCanceller(128, mu=0.5)
        e = np.asarray(c.execute_block(x, d))
        erle = 10 * np.log10(np.mean(np.abs(d[-5000:]) ** 2)
                             / np.mean(np.abs(e[-5000:]) ** 2))
        assert erle > 40.0, erle
        # the constrained update learns the causal FIR itself
        err = np.linalg.norm(c.taps[:90] - h) / np.linalg.norm(h)
        assert err < 0.01, err

    def test_colored_input_converges(self):
        # per-bin normalization: AR(1)-colored input (eigenvalue spread
        # ~1500) still converges fast — the whole point of FDAF over LMS
        import scipy.signal as sps
        from solid_dsp_tpu.models.equalizer import FDAFCanceller
        rng = np.random.default_rng(1)
        h = self._channel(rng)
        N = 40000
        x = sps.lfilter([1.0], [1.0, -0.95],
                        rng.standard_normal(N)).astype(np.complex64)
        x /= np.std(x)
        d = np.convolve(x, h)[:N]
        c = FDAFCanceller(128, mu=0.5)
        e = np.asarray(c.execute_block(x, d))
        erle = 10 * np.log10(np.mean(np.abs(d[-5000:]) ** 2)
                             / np.mean(np.abs(e[-5000:]) ** 2))
        assert erle > 35.0, erle

    def test_streaming_buffering_and_reset(self):
        from solid_dsp_tpu.models.equalizer import FDAFCanceller
        rng = np.random.default_rng(2)
        h = self._channel(rng, 30)
        N = 8192
        x = (rng.standard_normal(N)
             + 1j * rng.standard_normal(N)).astype(np.complex64)
        d = np.convolve(x, h)[:N]
        c1 = FDAFCanceller(64, mu=0.5)
        e1 = np.asarray(c1.execute_block(x, d))
        c2 = FDAFCanceller(64, mu=0.5)
        # ragged splits exercise the internal buffering
        parts = [np.asarray(c2.execute_block(x[a:b], d[a:b]))
                 for a, b in [(0, 100), (100, 1111), (1111, 5000),
                              (5000, N)]]
        e2 = np.concatenate(parts)
        np.testing.assert_allclose(e1[:len(e2)], e2, atol=1e-4)
        c2.reset()
        assert np.allclose(np.asarray(c2.taps), 0)
        import pytest
        with pytest.raises(ValueError):
            FDAFCanceller(0)
