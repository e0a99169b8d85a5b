"""ChannelBank: channelizer + IIR biquad bank + per-channel AGC."""

import numpy as np
import pytest

from solid_dsp_tpu.models.channel_bank import ChannelBank, design_channel_sos


def test_design_channel_sos_is_lowpass():
    sos = design_channel_sos(0.2)
    assert sos.shape == (2, 5)
    # unity DC gain per section: sum(b) / (1 + sum(a)) == 1
    for s in sos:
        dc = (s[0] + s[1] + s[2]) / (1.0 + s[3] + s[4])
        assert abs(dc - 1.0) < 1e-6
    # Nyquist ~ 0 for a lowpass: H(-1) = (b0 - b1 + b2)/(1 - a1 + a2)
    for s in sos:
        ny = (s[0] - s[1] + s[2]) / (1.0 - s[3] + s[4])
        assert abs(ny) < 1e-6


def test_channel_bank_selects_and_filters():
    M = 16
    bank = ChannelBank(M, taps_per_branch=8, agc_bandwidth=0.05)
    c = 3
    L = M * 400
    x = (0.05 * np.exp(2j * np.pi * (c / M) * np.arange(L))).astype(
        np.complex64)
    Y = np.asarray(bank.execute_block(x))
    assert Y.shape == (400, M)
    power = np.mean(np.abs(Y[100:]) ** 2, axis=0)
    assert power.argmax() == c
    # AGC brings the occupied channel toward unit magnitude over blocks
    for _ in range(30):
        Y = np.asarray(bank.execute_block(x))
    mag = np.mean(np.abs(Y[:, c]))
    assert 0.9 < mag < 1.1


def test_channel_bank_streaming_continuity():
    M = 8
    sos = design_channel_sos(0.3)
    b1 = ChannelBank(M, sos=sos)
    b2 = ChannelBank(M, sos=sos)
    rng = np.random.default_rng(0)
    L = M * 200
    x = (rng.standard_normal(2 * L) + 1j * rng.standard_normal(2 * L)
         ).astype(np.complex64)
    Ya = np.asarray(b1.execute_block(x[:L]))
    Yb = np.asarray(b1.execute_block(x[L:]))
    Yfull = np.asarray(b2.execute_block(x))
    got = np.concatenate([Ya, Yb], axis=0)
    np.testing.assert_allclose(got, Yfull, atol=3e-5)


def test_channel_bank_repr_reset():
    bank = ChannelBank(8)
    assert "ChannelBank" in repr(bank)
    bank.execute_block(np.ones(8 * 64, np.complex64))
    bank.reset()
    st = bank.state
    assert float(np.abs(np.asarray(st["iir"])).max()) == 0.0
