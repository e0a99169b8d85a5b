"""PolyphaseChannelizer against a float64 numpy polyphase bank.

The reference (chip_smoke.ref_channelizer, shared with the on-card smoke)
follows the definition in models/channelizer.py:

    z[t, r] = sum_k h[k M + r] x[(t - k) M - r]
    Y[t, m] = sum_r z[t, r] e^{+2 pi i m r / M}

where x[-1], x[-2], ... are the carried tail (zeros at stream start).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from chip_smoke import ref_channelizer
from solid_dsp_tpu.models.channelizer import (PolyphaseChannelizer,
                                              channelizer_taps)


def _snr_db(ref, got):
    err = np.sum(np.abs(np.asarray(got) - ref) ** 2)
    return 10 * np.log10(np.sum(np.abs(ref) ** 2) / max(err, 1e-300))


def _cx(n, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(n) + 1j * rng.standard_normal(n)


@pytest.mark.parametrize("M,K", [(16, 8), (64, 4), (8, 7), (256, 8)])
@pytest.mark.parametrize("dtype,gate", [(jnp.complex64, 90.0),
                                        (jnp.complex128, 200.0)])
def test_channelizer_matches_float64_reference(M, K, dtype, gate):
    x = _cx(M * 40, M + K)
    ch = PolyphaseChannelizer(M, K, dtype=dtype)
    Y = np.asarray(ch.execute_block(jnp.asarray(x, dtype)))
    ref, _ = ref_channelizer(channelizer_taps(M, K), x, M, K)
    assert Y.shape == ref.shape == (40, M)
    assert _snr_db(ref, Y) >= gate


@pytest.mark.parametrize("M,K", [(16, 8), (32, 3)])
def test_channelizer_streaming_matches_reference(M, K):
    """Three carried blocks == the float64 bank over the whole stream."""
    x = _cx(M * 96, 1)
    ch = PolyphaseChannelizer(M, K, dtype=jnp.complex128)
    got = np.concatenate([np.asarray(ch.execute_block(jnp.asarray(b)))
                          for b in np.split(x, 3)])
    ref, _ = ref_channelizer(channelizer_taps(M, K), x, M, K)
    assert _snr_db(ref, got) >= 200.0


def test_tone_lands_in_right_channel():
    """A +c/M tone must appear in channel c."""
    M, K = 32, 8
    c = 5
    L = M * 200
    x = np.exp(2j * np.pi * (c / M) * np.arange(L)).astype(np.complex64)
    Y = PolyphaseChannelizer(M, K).execute_block(jnp.asarray(x))
    power = np.mean(np.abs(np.asarray(Y))[K * 2:], axis=0)  # skip transient
    assert power.argmax() == c
    others = np.delete(power, c)
    assert power[c] > 20 * others.max()


def test_channelizer_rejects_unaligned_block():
    ch = PolyphaseChannelizer(16, 8)
    with pytest.raises(ValueError):
        ch.execute_block(jnp.zeros(16 * 4 + 3, jnp.complex64))
