"""SNR acceptance tests for the 5 driver configs (BASELINE.md §A).

The acceptance bound is >= 60 dB output SNR vs reference semantics.  The
float64/complex128 paths in this framework ARE reference semantics (they
reproduce the Rust doctest constants exactly — see golden tests); here the
production complex64 path is measured against the complex128 path on
each driver config and must clear 60 dB with margin.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from solid_dsp_tpu.design import firdes
from solid_dsp_tpu.models.channelizer import PolyphaseChannelizer
from solid_dsp_tpu.models.rx_chain import RxChainConfig, make_rx_chain
from solid_dsp_tpu.ops import fir as fir_ops
from solid_dsp_tpu.ops.fft import windowed_fft


def snr_db(ref: np.ndarray, test: np.ndarray) -> float:
    ref = np.asarray(ref, dtype=np.complex128)
    test = np.asarray(test, dtype=np.complex128)
    err = ref - test
    p_sig = float(np.mean(np.abs(ref) ** 2))
    p_err = float(np.mean(np.abs(err) ** 2))
    if p_err == 0.0:
        return np.inf
    return 10.0 * np.log10(p_sig / p_err)


def _tone(n, f, amp=0.5, seed=0):
    rng = np.random.default_rng(seed)
    k = np.arange(n)
    return amp * np.exp(2j * np.pi * f * k) + 0.01 * (
        rng.standard_normal(n) + 1j * rng.standard_normal(n))


def test_config1_fir_64tap_1m_tone():
    """64-tap complex FIR on a 1M-sample tone: c64 vs c128 >= 60 dB."""
    n = 1 << 20
    taps = firdes.firdes_kaiser(64, 0.1, 60.0, 0.0)
    x = _tone(n, 0.03)

    y64, _ = fir_ops.fir_apply(jnp.asarray(taps, jnp.complex64),
                               fir_ops.fir_init(64, jnp.complex64),
                               jnp.asarray(x, jnp.complex64))
    y128, _ = fir_ops.fir_apply(jnp.asarray(taps, jnp.complex128),
                                fir_ops.fir_init(64, jnp.complex128),
                                jnp.asarray(x, jnp.complex128))
    assert snr_db(np.asarray(y128), np.asarray(y64)) >= 60.0


def test_config1_fft_vs_matmul_methods():
    """FIR method cross-check: fft overlap-save vs conv path, c128."""
    taps = firdes.firdes_kaiser(64, 0.1, 60.0, 0.0)
    x = _tone(1 << 16, 0.03)
    ya, _ = fir_ops.fir_apply(jnp.asarray(taps, jnp.complex128),
                              fir_ops.fir_init(64, jnp.complex128),
                              jnp.asarray(x), method="fft")
    yb, _ = fir_ops.fir_apply(jnp.asarray(taps, jnp.complex128),
                              fir_ops.fir_init(64, jnp.complex128),
                              jnp.asarray(x), method="matmul")
    assert snr_db(np.asarray(ya), np.asarray(yb)) >= 100.0


@pytest.mark.parametrize("window", ["hamming", "blackman_harris"])
def test_config2_windowed_fft_chirp(window):
    """4096-pt windowed FFT on a chirp: c64 vs c128 >= 60 dB."""
    n = 4096
    k = np.arange(n)
    chirp = np.exp(1j * np.pi * 0.4 * k * k / n)
    X64 = windowed_fft(jnp.asarray(chirp, jnp.complex64), window=window)
    X128 = windowed_fft(jnp.asarray(chirp, jnp.complex128), window=window)
    assert snr_db(np.asarray(X128), np.asarray(X64)) >= 60.0


@pytest.mark.parametrize("P,Q", [(3, 2), (1, 8)])
def test_config3_rational_resampler(P, Q):
    """Polyphase rational resampler 3/2 and 1/8: c64 vs c128 >= 60 dB."""
    taps = firdes.firdes_kaiser(48 * max(P, 1), 0.4 / max(P, Q), 60.0, 0.0)
    x = _tone(1 << 15, 0.01)

    def run(dtype):
        rs = fir_ops.RationalResampler(taps, P, Q, dtype=dtype)
        return np.asarray(rs.execute_block(jnp.asarray(x, dtype)))

    y64 = run(jnp.complex64)
    y128 = run(jnp.complex128)
    assert snr_db(y128, y64) >= 60.0


def test_config4_full_rx_chain():
    """NCO -> FIR -> AGC -> FM chain: c64 vs c128 >= 60 dB on demod out."""
    n = 1 << 16
    from solid_dsp_tpu.models.fm import fm_modulate

    msg = np.sin(2 * np.pi * 0.002 * np.arange(n))
    iq, _ = fm_modulate(jnp.asarray(msg, jnp.float64), 0.1)
    x = (np.asarray(iq) * 0.5
         * np.exp(2j * np.pi * (0.2 / (2 * np.pi)) * np.arange(n)))

    def run(dtype):
        cfg = RxChainConfig(dtype=dtype, nco_mode="exact", agc_mode="block",
                            demod="fm")
        init, apply = make_rx_chain(cfg)
        out, _ = apply(init(), jnp.asarray(x, dtype))
        return np.asarray(out)

    y64 = run(jnp.complex64)
    y128 = run(jnp.complex128)
    assert snr_db(y128, y64) >= 60.0


def test_config4_fast_nco_mode_snr():
    """The 'fast' factorized NCO keeps the chain above 60 dB too."""
    n = 1 << 16
    x = _tone(n, 0.2 / (2 * np.pi) + 0.001, amp=0.1)

    def run(mode, dtype):
        cfg = RxChainConfig(dtype=dtype, nco_mode=mode, agc_mode="block",
                            demod="none")
        init, apply = make_rx_chain(cfg)
        out, _ = apply(init(), jnp.asarray(x, dtype))
        return np.asarray(out)

    y_ref = run("exact", jnp.complex128)
    y_fast = run("fast", jnp.complex64)
    assert snr_db(y_ref, y_fast) >= 60.0


def test_config5_channelizer_256():
    """256-channel polyphase channelizer: c64 vs c128 >= 60 dB."""
    M = 256
    L = M * 64
    rng = np.random.default_rng(2)
    x = (rng.standard_normal(L) + 1j * rng.standard_normal(L))

    c64 = PolyphaseChannelizer(M, 8, dtype=jnp.complex64)
    c128 = PolyphaseChannelizer(M, 8, dtype=jnp.complex128)
    Y64 = np.asarray(c64.execute_block(jnp.asarray(x, jnp.complex64)))
    Y128 = np.asarray(c128.execute_block(jnp.asarray(x, jnp.complex128)))
    assert snr_db(Y128, Y64) >= 60.0


# --------------------------------------------------------------------------
# Independent reference models (the SNR suite must not be circular).
# Each config below is gated against a model built from a DIFFERENT
# mechanism than the implementation under test, so a shared algorithmic bug
# cannot pass: direct-sum DFT vs the FFT engine, per-branch numpy convolve
# in the reference's coefficient layout vs the polyphase matmul, and
# mix->filter->decimate vs the fused gather+einsum+IDFT channelizer.
# --------------------------------------------------------------------------

@pytest.mark.parametrize("window", ["hamming", "blackman_harris"])
def test_config2_windowed_fft_vs_direct_dft(window):
    """Independent model: O(N^2) direct-sum windowed DFT in numpy."""
    from solid_dsp_tpu.design.windows import get_window

    n = 4096
    k = np.arange(n)
    chirp = np.exp(1j * np.pi * 0.4 * k * k / n)
    w = np.asarray(get_window(window, n), dtype=np.float64)
    # direct sum, forward non-normalized — the reference's convention
    # (fft has no 1/N on forward transforms; BASELINE.md note)
    W = np.exp(-2j * np.pi * np.outer(k, k) / n)
    X_direct = W @ (w * chirp)

    X = np.asarray(windowed_fft(jnp.asarray(chirp, jnp.complex128),
                                window=window))
    assert snr_db(X_direct, X) >= 100.0


def _interp_branch_convolve(x, coefs, P):
    """Independent interpolator: per-branch numpy convolve in the
    reference's coefficient layout (fir/interp.rs:27-100, pfb.rs:34-42:
    out[n*P + f] = sum_k eff[f + (L-1-k)*P] * x[n-k])."""
    c = np.asarray(coefs, dtype=np.complex128)
    sub_len = int(np.ceil(len(c) / P))
    eff = np.zeros(sub_len * P, dtype=np.complex128)
    eff[: len(c)] = c
    out = np.empty(len(x) * P, dtype=np.complex128)
    for f in range(P):
        cf = eff[f::P][::-1]  # eff[f + (L-1-k)P], k = 0..L-1
        out[f::P] = np.convolve(x, cf)[: len(x)]
    return out


@pytest.mark.parametrize("P,Q", [(3, 2), (1, 8)])
def test_config3_resampler_vs_independent_model(P, Q):
    """RationalResampler vs zero-stuff+convolve+select, 1e5+ samples."""
    rng = np.random.default_rng(7)
    n = 1 << 17
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    taps = firdes.firdes_kaiser(48 * max(P, 1), 0.4 / max(P, Q), 60.0, 0.0)

    up = _interp_branch_convolve(x, taps, P)
    y_ref = up[::Q]

    rs = fir_ops.RationalResampler(taps, P, Q, dtype=jnp.complex128)
    # split-block execution also exercises the phase carry
    y = np.concatenate([
        np.asarray(rs.execute_block(jnp.asarray(x[: n // 4], jnp.complex128))),
        np.asarray(rs.execute_block(jnp.asarray(x[n // 4:], jnp.complex128))),
    ])
    assert len(y) == len(y_ref)
    assert snr_db(y_ref, y) >= 100.0


def test_config3_ref_sim_spot_check():
    """Anchor the vectorized independent model itself against the
    per-sample RefInterpFIR simulator on a short stream."""
    from ref_sim import RefInterpFIR

    rng = np.random.default_rng(8)
    x = rng.standard_normal(256) + 1j * rng.standard_normal(256)
    taps = firdes.firdes_kaiser(31, 0.2, 60.0, 0.0)
    got = _interp_branch_convolve(x, taps, 3)
    want = RefInterpFIR(taps, 3).execute_block(x)
    np.testing.assert_allclose(got, want, atol=1e-10)


def _channelizer_mix_filter_decimate(x, h, M):
    """Independent channelizer: per-channel mix-down by m/M, lowpass with
    the prototype, decimate by M (textbook DDC bank; no PFB, no IDFT)."""
    x = np.asarray(x, dtype=np.complex128)
    h = np.asarray(h, dtype=np.complex128)
    n = np.arange(len(x))
    T = len(x) // M
    Y = np.empty((T, M), dtype=np.complex128)
    for m in range(M):
        v = x * np.exp(-2j * np.pi * m * n / M)
        conv = np.convolve(v, h)
        Y[:, m] = conv[: T * M : M]
    return Y


def test_config5_channelizer_vs_mix_filter_decimate():
    """64-channel bank vs brute-force DDC bank (time-domain convolve)."""
    M, K = 64, 8
    L = M * 256
    rng = np.random.default_rng(9)
    x = rng.standard_normal(L) + 1j * rng.standard_normal(L)

    c = PolyphaseChannelizer(M, K, dtype=jnp.complex128)
    Y = np.asarray(c.execute_block(jnp.asarray(x, jnp.complex128)))
    Y_ref = _channelizer_mix_filter_decimate(x, np.asarray(c.taps), M)
    assert snr_db(Y_ref, Y) >= 100.0


def test_config5_channelizer_256_vs_fft_conv_model():
    """256-channel bank vs an independent numpy-FFT overlap-free model
    (linear convolution via zero-padded np.fft, no gathers, no einsum)."""
    M, K = 256, 8
    L = M * 64
    rng = np.random.default_rng(10)
    x = rng.standard_normal(L) + 1j * rng.standard_normal(L)

    c = PolyphaseChannelizer(M, K, dtype=jnp.complex128)
    Y = np.asarray(c.execute_block(jnp.asarray(x, jnp.complex128)))

    h = np.asarray(c.taps, dtype=np.complex128)
    n = np.arange(L)
    T = L // M
    nfft = int(2 ** np.ceil(np.log2(L + len(h) - 1)))
    H = np.fft.fft(h, nfft)
    mixers = np.exp(-2j * np.pi * np.outer(np.arange(M), n) / M)  # (M, L)
    V = np.fft.fft(x[None, :] * mixers, nfft, axis=-1)
    conv = np.fft.ifft(V * H[None, :], axis=-1)[:, : T * M]
    Y_ref = conv[:, ::M].T  # (T, M)
    assert snr_db(Y_ref, Y) >= 100.0


def test_config4_chain_group_delay_bound():
    """End-to-end chain delay within the designed group-delay bound
    (BASELINE.json north star: 'within reference group-delay bound')."""
    from solid_dsp_tpu.analysis.group_delay import fir_group_delay
    from solid_dsp_tpu.models.fm import fm_modulate

    n = 1 << 16
    f_msg = 0.001
    cfg = RxChainConfig(dtype=jnp.complex128, nco_mode="exact",
                        agc_mode="parallel", demod="fm",
                        decimation=4, fir_taps=64)
    msg = np.sin(2 * np.pi * f_msg * np.arange(n))
    iq, _ = fm_modulate(jnp.asarray(msg, jnp.float64), cfg.fm_kf)
    x = (np.asarray(iq)
         * np.exp(1j * cfg.carrier_freq * np.arange(n)))

    init, apply = make_rx_chain(cfg)
    out, _ = apply(init(), jnp.asarray(x, jnp.complex128))
    out = np.asarray(out).real
    out = out / (np.std(out) + 1e-30)

    # expected delay in output samples: FIR group delay at the message
    # band over the decimation factor (NCO mix and FM discriminator are
    # zero-delay phase operations up to half a sample)
    taps = cfg.design_taps()
    gd_in = float(fir_group_delay(taps, 0.0))
    expected = gd_in / cfg.decimation

    # measure: cross-correlate demod out vs the decimated message
    msg_d = msg[:: cfg.decimation]
    msg_d = msg_d / (np.std(msg_d) + 1e-30)
    skip = 2048  # drop the AGC/filter transient
    seg = out[skip: skip + 8192]
    lags = np.arange(0, 64)
    corr = [float(np.dot(seg, msg_d[skip - l: skip - l + 8192]))
            for l in lags]
    lag = int(lags[int(np.argmax(corr))])
    assert abs(lag - expected) <= 1.0, (lag, expected)


def test_config4_full_chain_vs_per_sample_reference_sim():
    """Close the LAST circularity: the entire config-4 chain (LUT NCO ->
    decimating FIR -> EXACT AGC -> FM discriminator) against a pure-python
    per-sample simulator built from the ref_sim components — a completely
    independent mechanism from the block/jit implementation."""
    from ref_sim import RefAGC, RefDecimFIR, RefNCO

    n = 4096
    rng = np.random.default_rng(21)
    x = (0.1 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
         + 0.3 * np.exp(1j * 0.2 * np.arange(n)))

    cfg = RxChainConfig(carrier_freq=0.2, decimation=4, fir_taps=64,
                        agc_bandwidth=0.01, agc_mode="parallel",
                        nco_mode="lut", demod="fm", dtype=jnp.complex128)
    init, apply = make_rx_chain(cfg)
    got, _ = apply(init(), jnp.asarray(x, jnp.complex128))
    got = np.asarray(got)

    # --- independent per-sample simulation -----------------------------
    nco = RefNCO()
    nco.set_frequency(0.2)
    taps = cfg.design_taps()
    dfir = RefDecimFIR(taps, 1.0, cfg.decimation)
    agc = RefAGC()
    agc.alpha = cfg.agc_bandwidth
    agc.threshold = -1e30

    mixed = np.empty(n, dtype=np.complex128)
    for i in range(n):
        mixed[i] = x[i] * (nco.cos() - 1j * nco.sin())
        nco.step()
    y = dfir.execute_block(mixed)
    y = agc.execute_block(y)
    prev = np.concatenate([[1.0 + 0j], y[:-1]])  # fm_demod_init = 1+0j
    want = np.angle(y * np.conj(prev)) / (2.0 * np.pi * cfg.fm_kf)

    assert snr_db(want, got) >= 100.0
