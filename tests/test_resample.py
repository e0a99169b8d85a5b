"""Arbitrary-ratio resampler tests.

Golden truth: zero-stuffed full convolution for the halfband
interpolator, and complex-tone fidelity (projection SNR against the
ideal output tone) plus alias/image rejection for the PFB chains.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from solid_dsp_tpu.ops.halfband import firdes_halfband
from solid_dsp_tpu.ops.resample import (
    ArbitraryResampler, HalfbandInterpolator, PfbArbitraryResampler,
    halfband_interpolate)


def _tone_snr(resampler, rate, f_in, n=200000, trim=None):
    x = np.exp(2j * np.pi * f_in * np.arange(n))
    y = np.asarray(resampler.execute_block(jnp.asarray(x)))
    trim = min(len(y) // 4, 4000) if trim is None else trim
    y = y[trim: len(y) - trim]
    ref = np.exp(2j * np.pi * (f_in / rate) * np.arange(len(y)))
    a = np.mean(np.conj(ref) * y)
    err = y - a * ref
    return 10 * np.log10(np.mean(np.abs(y) ** 2)
                         / np.mean(np.abs(err) ** 2))


def test_halfband_interpolate_equals_zero_stuffed_conv():
    rng = np.random.default_rng(0)
    h = firdes_halfband(6, 70.0)
    c = (len(h) - 1) // 2
    x = rng.standard_normal(200) + 1j * rng.standard_normal(200)
    u = np.zeros(400, complex)
    u[0::2] = x
    ref = 2 * np.convolve(u, h)[:400]
    y, _ = halfband_interpolate(jnp.asarray(h),
                                jnp.zeros(c, jnp.complex128),
                                jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(y), ref, atol=1e-12)


def test_halfband_interpolator_streaming_invariance():
    rng = np.random.default_rng(1)
    x = rng.standard_normal(1000) + 1j * rng.standard_normal(1000)
    h1, h2 = HalfbandInterpolator(8), HalfbandInterpolator(8)
    ya = np.asarray(h1.execute_block(jnp.asarray(x)))
    yb = np.concatenate([np.asarray(h2.execute_block(jnp.asarray(b)))
                         for b in np.split(x, [137, 400, 777])])
    np.testing.assert_allclose(ya, yb, atol=1e-6)
    assert len(ya) == 2000


@pytest.mark.parametrize("rate,f_in,min_db", [
    (0.37, 0.10, 60.0),        # halfband + PFB decimation
    (1 / np.pi, 0.12, 60.0),   # irrational
    (0.503, 0.15, 60.0),       # just under 1: pure PFB
    (0.9, 0.30, 60.0),         # near-unity, high occupancy
    (1.7, 0.35, 58.0),         # interpolation, signal near fpass
    (np.pi, 0.30, 60.0),       # irrational interpolation
])
def test_arbitrary_resampler_tone_fidelity(rate, f_in, min_db):
    r = ArbitraryResampler(rate, dtype=jnp.complex128)
    snr = _tone_snr(r, rate, f_in)
    assert snr > min_db, (rate, f_in, snr)


def test_large_ratio_decimation():
    r = ArbitraryResampler(0.01, dtype=jnp.complex128)
    snr = _tone_snr(r, 0.01, 0.003, n=2_000_000, trim=2000)
    assert snr > 70.0, snr
    # stencil stays small: the 2^k halfbands absorb the bulk ratio
    pfb = [s for s in r.stages if isinstance(s, PfbArbitraryResampler)]
    assert pfb and pfb[0].P <= 64


def test_antialias_rejection():
    # tone above the output Nyquist must be crushed by >= ~65 dB
    rate = 0.41
    r = ArbitraryResampler(rate, fpass=0.4, stop_band_attenuation=70.0,
                           dtype=jnp.complex128)
    x = np.exp(2j * np.pi * 0.35 * np.arange(100000))  # out Nyq = 0.205
    y = np.asarray(r.execute_block(jnp.asarray(x)))[2000:-2000]
    assert 10 * np.log10(np.mean(np.abs(y) ** 2) + 1e-30) < -65.0


def test_image_rejection_on_interpolation():
    # interpolating a tone: images at f_in/rate +- k/rate must be absent
    rate = 2.6
    r = ArbitraryResampler(rate, dtype=jnp.complex128)
    f_in = 0.2
    x = np.exp(2j * np.pi * f_in * np.arange(60000))
    y = np.asarray(r.execute_block(jnp.asarray(x)))[4000:-4000]
    Y = np.abs(np.fft.fft(y * np.hanning(len(y)))) ** 2
    f = np.fft.fftfreq(len(y))
    main = Y[np.argmin(np.abs(f - f_in / rate))]
    img_band = np.abs(np.abs(f) - (1.0 - f_in) / rate) < 0.01
    assert 10 * np.log10(Y[img_band].max() / main) < -55.0


def test_streaming_block_invariance():
    rng = np.random.default_rng(2)
    x = rng.standard_normal(30000) + 1j * rng.standard_normal(30000)
    # 0.37 and 0.2 build halfband cascades (alignment buffer exercised
    # by the odd split points); 0.713/1.402 are pure PFB paths
    for rate in (0.713, 1.402, 0.37, 0.2):
        r1 = ArbitraryResampler(rate, dtype=jnp.complex128)
        r2 = ArbitraryResampler(rate, dtype=jnp.complex128)
        ya = np.asarray(r1.execute_block(jnp.asarray(x)))
        yb = np.concatenate([np.asarray(r2.execute_block(jnp.asarray(b)))
                             for b in np.split(x, [7001, 11111, 20003])])
        assert abs(len(ya) - len(yb)) <= 1, rate
        n = min(len(ya), len(yb))
        np.testing.assert_allclose(ya[:n], yb[:n], atol=1e-9)


def test_odd_block_lengths_with_halfband_cascade():
    # regression: halfband stages need even blocks; the remainder buffer
    # must absorb ragged lengths transparently
    rng = np.random.default_rng(4)
    x = rng.standard_normal(10001) + 1j * rng.standard_normal(10001)
    r = ArbitraryResampler(0.2, dtype=jnp.complex128)   # k=2 -> align 4
    y1 = np.asarray(r.execute_block(jnp.asarray(x)))     # len % 4 == 1
    r2 = ArbitraryResampler(0.2, dtype=jnp.complex128)
    parts = [np.asarray(r2.execute_block(jnp.asarray(b)))
             for b in np.split(x, [503, 504, 7777])]     # 1-sample block
    y2 = np.concatenate(parts)
    n = min(len(y1), len(y2))
    assert n > 1900
    np.testing.assert_allclose(y1[:n], y2[:n], atol=1e-9)


def test_output_length_and_passthrough():
    rng = np.random.default_rng(3)
    x = (rng.standard_normal(50000)
         + 1j * rng.standard_normal(50000)).astype(np.complex64)
    for rate in (0.37, 1.0, 2.5):
        r = ArbitraryResampler(rate)
        y = np.asarray(r.execute_block(jnp.asarray(x)))
        assert abs(len(y) - rate * len(x)) < 200, (rate, len(y))
    assert "identity" in repr(ArbitraryResampler(1.0))


def test_complex64_accuracy():
    r = ArbitraryResampler(0.77, dtype=jnp.complex64)
    snr = _tone_snr(r, 0.77, 0.2, n=100000)
    assert snr > 50.0, snr


def test_reset_and_validation():
    r = ArbitraryResampler(0.6, dtype=jnp.complex128)
    x = jnp.asarray(np.ones(5000, np.complex128))
    y1 = np.asarray(r.execute_block(x))
    r.reset()
    y2 = np.asarray(r.execute_block(x))
    np.testing.assert_allclose(y1, y2, atol=1e-12)
    with pytest.raises(ValueError):
        ArbitraryResampler(0.0)
    with pytest.raises(ValueError):
        ArbitraryResampler(0.5, fpass=0.6)
    with pytest.raises(ValueError):
        PfbArbitraryResampler(-1.0)
    with pytest.raises(ValueError):
        PfbArbitraryResampler(1.0, cutoff=0.7)


def test_pfb_batched_bank_matches_single_channel():
    rng = np.random.default_rng(5)
    xb = (rng.standard_normal((4, 20000))
          + 1j * rng.standard_normal((4, 20000)))
    bank = PfbArbitraryResampler(1.37, dtype=jnp.complex128,
                                 batch_shape=(4,))
    yb = np.asarray(bank.execute_block(jnp.asarray(xb)))
    single = PfbArbitraryResampler(1.37, dtype=jnp.complex128)
    y2 = np.asarray(single.execute_block(jnp.asarray(xb[2])))
    np.testing.assert_allclose(yb[2], y2, atol=0)
    # streaming with shared positions across the bank
    bank.reset()
    parts = [np.asarray(bank.execute_block(jnp.asarray(b)))
             for b in np.split(xb, [7000, 13000], axis=1)]
    np.testing.assert_allclose(np.concatenate(parts, axis=1), yb,
                               atol=1e-9)


def test_flush_recovers_the_tail():
    # one-shot conversion: execute_block + flush must cover the whole
    # recording (without flush the cascade's group delay is lost)
    rng = np.random.default_rng(6)
    n = 40000
    x = np.exp(2j * np.pi * 0.003 * np.arange(n))
    for rate in (0.01, 0.37, 2.5):
        r = ArbitraryResampler(rate, dtype=jnp.complex128)
        y = np.asarray(r.execute_block(jnp.asarray(x)))
        tail = np.asarray(r.flush())
        total = len(y) + len(tail)
        assert total >= int(round(n * rate)), (rate, total)
        # the flushed tail carries the real signal, not zeros
        if rate <= 0.5:
            assert np.abs(tail[: max(1, len(tail) // 4)]).max() > 0.1
    # identity flush is empty
    assert len(np.asarray(ArbitraryResampler(1.0).flush())) == 0


# ---------------------------------------------------------------- round 5
# jittable grid engines (ops/gridresample.py): exact fixed-point positions


def test_grid_positions_exact():
    """base/mu from the int32 fixed-point grid == f64 reference for
    multiple blocks and ratios (including the carry across blocks)."""
    from solid_dsp_tpu.ops.gridresample import (
        grid_advance, grid_n_valid, grid_positions, plan_ratio)

    for ratio in (1.1875, 48000 / 44100, 1 / 0.37, 0.4, 31.0, 1 / 15.0):
        L = 4096
        plan = plan_ratio(ratio, L)
        rq = plan.ratio
        t0 = jnp.zeros((), jnp.int32)
        t_ref = 0.0
        for blk in range(4):
            n = int(np.asarray(grid_n_valid(plan, t0)))
            base, mu = grid_positions(plan, t0, plan.n_pad)
            base, mu = np.asarray(base)[:n], np.asarray(mu)[:n]
            t_exact = t_ref + np.arange(n) * rq
            assert np.array_equal(
                base, np.floor(t_exact + 1e-9).astype(int)), (ratio, blk)
            mu_ref = t_exact - np.floor(t_exact + 1e-9)
            assert np.max(np.abs(mu - mu_ref)) < 1e-6, (ratio, blk)
            t0 = grid_advance(plan, t0)
            t_ref = t_ref + n * rq - L


def test_farrow_grid_engine_matches_f64_reference():
    """make_farrow_resampler vs an exact f64 cubic-Lagrange evaluation
    at the quantized ratio: > 120 dB (the engine's only approximation
    is the 2^-20 mu quantization)."""
    from solid_dsp_tpu.ops.farrow import make_farrow_resampler
    from solid_dsp_tpu.ops.gridresample import plan_ratio

    ratio = 48000 / 44100
    L = 4096
    rq = plan_ratio(ratio, L).ratio
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(3 * L)
         + 1j * rng.standard_normal(3 * L)).astype(np.complex128)
    ext = np.concatenate([np.zeros(3, complex), x])
    t = np.arange(int(3 * L / rq) + 2) * rq
    t = t[t < 3 * L]
    b = np.floor(t).astype(int)
    mu = t - b
    w = np.stack([-mu * (mu - 1) * (mu - 2) / 6,
                  (mu + 1) * (mu - 1) * (mu - 2) / 2,
                  -(mu + 1) * mu * (mu - 2) / 2,
                  (mu + 1) * mu * (mu - 1) / 6], -1)
    ref = (np.stack([ext[b + i] for i in range(4)], -1) * w).sum(-1)

    init, apply, plan = make_farrow_resampler(rq, L, dtype=jnp.complex128)
    st = init()
    outs = []
    for i in range(3):
        y, nv, st = apply(st, jnp.asarray(x[i * L: (i + 1) * L]))
        outs.append(np.asarray(y)[: int(nv)])
    got = np.concatenate(outs)
    assert len(got) == len(ref)
    snr = 10 * np.log10(np.mean(np.abs(ref) ** 2)
                        / (np.mean(np.abs(got - ref) ** 2) + 1e-300))
    assert snr > 120.0, snr


def test_pfb_grid_engine_matches_legacy_at_dyadic_ratio():
    """make_pfb_resampler == PfbArbitraryResampler when the ratio is
    already dyadic (both paths then evaluate identical positions)."""
    from solid_dsp_tpu.ops.gridresample import plan_ratio
    from solid_dsp_tpu.ops.resample import make_pfb_resampler

    ratio = plan_ratio(1 / 0.37, 4096).ratio   # dyadic by construction
    L = 4096
    rng = np.random.default_rng(1)
    x = (rng.standard_normal(3 * L)
         + 1j * rng.standard_normal(3 * L)).astype(np.complex64)
    leg = PfbArbitraryResampler(ratio, dtype=jnp.complex64)
    ys = np.concatenate([np.asarray(leg.execute_block(
        jnp.asarray(x[i * L: (i + 1) * L]))) for i in range(3)])
    init, apply, plan = make_pfb_resampler(ratio, L)
    st = init()
    outs = []
    for i in range(3):
        y, nv, st = apply(st, jnp.asarray(x[i * L: (i + 1) * L]))
        outs.append(np.asarray(y)[: int(nv)])
    got = np.concatenate(outs)
    assert len(got) == len(ys)
    assert np.max(np.abs(got - ys)) < 1e-4   # legacy's f32 chunk error


def test_arb_functional_matches_class_per_block():
    """make_arb_resampler == ArbitraryResampler when the internal stage
    ratios are exactly dyadic (zero quantization divergence between the
    float and fixed-point position streams; non-dyadic ratios differ by
    the documented < 0.5 ppm rate quantization)."""
    from solid_dsp_tpu.ops.resample import make_arb_resampler

    rng = np.random.default_rng(3)
    # rates chosen so each PFB stage ratio is a dyadic rational:
    # 1/(2 * 1.3515625), 2^20/419430 (pfb ratio dyadic), 1/1.296875
    for rate in (1.0 / (2.0 * 1.3515625), float(2 ** 20) / 419430.0,
                 1.0 / 1.296875):
        L = 8192
        x = (rng.standard_normal(3 * L)
             + 1j * rng.standard_normal(3 * L)).astype(np.complex64)
        cls = ArbitraryResampler(rate, dtype=jnp.complex64)
        ys = np.concatenate([np.asarray(cls.execute_block(
            jnp.asarray(x[i * L: (i + 1) * L]))) for i in range(3)])
        init, apply, n_pad = make_arb_resampler(rate, L)
        st = init()
        outs = []
        for i in range(3):
            y, nv, st = apply(st, jnp.asarray(x[i * L: (i + 1) * L]))
            outs.append(np.asarray(y)[: int(nv)])
        got = np.concatenate(outs)
        assert abs(len(got) - len(ys)) <= 2, rate
        n1 = len(outs[0])
        err = np.max(np.abs(got[:n1] - ys[:n1]))
        assert err < 2e-4, (rate, err)
