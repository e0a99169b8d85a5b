"""Multi-channel biquad-cascade bank (ops/iir.iir_bank_apply).

The bank runs one direct-form II cascade over C channels as a scan over
time.  References: a per-sample numpy loop of the same recurrence, the
single-channel IIRFilter, and scipy.signal.sosfilt in float64.
"""

import jax.numpy as jnp
import numpy as np
import pytest
from scipy import signal

from solid_dsp_tpu.models.channel_bank import design_channel_sos
from solid_dsp_tpu.ops.iir import iir_bank_apply, iir_bank_init


def _np_sos_ref(sos, x):
    """Direct-form II cascade, per channel, in numpy (the bank's spec)."""
    S = sos.shape[0]
    T, C = x.shape
    w1 = np.zeros((S, C), np.complex128)
    w2 = np.zeros((S, C), np.complex128)
    y = np.empty_like(x, dtype=np.complex128)
    for t in range(T):
        v = x[t].astype(np.complex128)
        for s in range(S):
            b0, b1, b2, a1, a2 = sos[s]
            w0 = v - a1 * w1[s] - a2 * w2[s]
            v = b0 * w0 + b1 * w1[s] + b2 * w2[s]
            w2[s] = w1[s]
            w1[s] = w0
        y[t] = v
    return y


def _butter_sos():
    """A stable 2-section lowpass (hand-computed biquads)."""
    return np.array([
        [0.0675, 0.1349, 0.0675, -1.1430, 0.4128],
        [0.25, 0.5, 0.25, -0.9, 0.3],
    ], dtype=np.float32)


def _cx(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
            ).astype(np.complex64)


def _sosfilt(sos5, x):
    """scipy.signal.sosfilt (float64) along time for (S, 5) rows."""
    sos6 = np.concatenate([sos5[:, :3], np.ones((len(sos5), 1)),
                           sos5[:, 3:]], axis=1).astype(np.float64)
    return signal.sosfilt(sos6, x.astype(np.complex128), axis=0)


def _snr_db(ref, got):
    err = np.sum(np.abs(np.asarray(got) - ref) ** 2)
    return 10 * np.log10(np.sum(np.abs(ref) ** 2) / max(err, 1e-300))


def test_iir_bank_matches_numpy():
    sos = _butter_sos()
    T, C = 300, 16
    x = _cx((T, C), 3)
    st = iir_bank_init(sos.shape[0], C)
    y, st2 = iir_bank_apply(jnp.asarray(sos), st, jnp.asarray(x))
    y_ref = _np_sos_ref(sos, x)
    np.testing.assert_allclose(np.asarray(y), y_ref.astype(np.complex64),
                               atol=2e-5, rtol=0)
    assert st2.shape == (2 * sos.shape[0], C)


def test_iir_bank_streaming_and_partial_tiles():
    """Two blocks with the carried state == one block (odd lengths)."""
    sos = _butter_sos()
    T, C = 250, 8
    x = _cx((2 * T, C), 4)
    st = iir_bank_init(sos.shape[0], C)
    ya, st = iir_bank_apply(jnp.asarray(sos), st, jnp.asarray(x[:T]))
    yb, _ = iir_bank_apply(jnp.asarray(sos), st, jnp.asarray(x[T:]))
    y2 = np.concatenate([np.asarray(ya), np.asarray(yb)], axis=0)
    y_ref = _np_sos_ref(sos, x)
    np.testing.assert_allclose(y2, y_ref.astype(np.complex64),
                               atol=3e-5, rtol=0)


def test_iir_bank_matches_iirfilter():
    """Same transfer function as ops.iir.IIRFilter (NORMAL form)."""
    from solid_dsp_tpu.ops.iir import IIRFilter

    sos = _butter_sos()[:1]  # single biquad == single NORMAL IIR
    b = sos[0, :3].astype(np.float64)
    a = np.array([1.0, sos[0, 3], sos[0, 4]], dtype=np.float64)
    x = _cx(200, 5)
    st = iir_bank_init(1, 1)
    y, _ = iir_bank_apply(jnp.asarray(sos), st, jnp.asarray(x[:, None]))
    f = IIRFilter(b, a, dtype=jnp.complex128)
    y_ref = np.asarray(f.execute_block(jnp.asarray(x, jnp.complex128)))
    np.testing.assert_allclose(np.asarray(y)[:, 0],
                               y_ref.astype(np.complex64), atol=2e-5)


def test_iir_bank_per_channel_coefficients():
    """(S, 5, C) per-channel cascades match per-channel numpy references."""
    S, C, T = 2, 8, 200
    sos_pc = np.stack(
        [design_channel_sos(0.1 + 0.03 * c) for c in range(C)], axis=-1
    )  # (S, 5, C)
    x = _cx((T, C), 6)
    st = iir_bank_init(S, C)
    y, _ = iir_bank_apply(jnp.asarray(sos_pc), st, jnp.asarray(x))
    for c in range(C):
        y_ref = _np_sos_ref(sos_pc[:, :, c], x[:, c: c + 1])
        np.testing.assert_allclose(np.asarray(y)[:, c], y_ref[:, 0].astype(
            np.complex64), atol=3e-5, err_msg=f"channel {c}")


@pytest.mark.parametrize("order,cutoff", [(2, 0.25), (4, 0.25), (4, 0.05),
                                          (8, 0.1)])
@pytest.mark.parametrize("dtype", [jnp.complex64, jnp.complex128])
def test_iir_bank_matches_sosfilt(order, cutoff, dtype):
    """Shared cascade on every channel vs scipy.signal.sosfilt (f64)."""
    sos = design_channel_sos(cutoff, order)
    T, C = 1000, 6
    x = _cx((T, C), order)
    st = iir_bank_init(sos.shape[0], C, dtype)
    y, _ = iir_bank_apply(jnp.asarray(sos), st, jnp.asarray(x, dtype))
    ref = _sosfilt(sos, x)
    gate = 90.0 if dtype == jnp.complex64 else 200.0
    assert _snr_db(ref, y) >= gate


def test_iir_bank_streaming_matches_sosfilt():
    """Four carried blocks == sosfilt over the whole stream."""
    sos = design_channel_sos(0.2, 4)
    T, C = 257, 4
    x = _cx((4 * T, C), 9)
    st = iir_bank_init(sos.shape[0], C)
    ys = []
    for i in range(4):
        y, st = iir_bank_apply(jnp.asarray(sos), st,
                               jnp.asarray(x[i * T:(i + 1) * T]))
        ys.append(np.asarray(y))
    assert _snr_db(_sosfilt(sos, x), np.concatenate(ys)) >= 90.0


def test_iir_bank_per_channel_matches_sosfilt():
    """Per-channel (S, 5, C) cascades, each channel vs its own sosfilt."""
    C = 5
    sos_pc = np.stack([design_channel_sos(0.05 + 0.08 * c) for c in
                       range(C)], axis=-1)
    x = _cx((600, C), 10)
    y, _ = iir_bank_apply(jnp.asarray(sos_pc), iir_bank_init(2, C),
                          jnp.asarray(x))
    for c in range(C):
        ref = _sosfilt(sos_pc[:, :, c], x[:, c])
        assert _snr_db(ref, np.asarray(y)[:, c]) >= 90.0, c
