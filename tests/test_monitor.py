"""SpectrumMonitor occupancy-tracking tests."""

import jax.numpy as jnp
import numpy as np
import pytest

from solid_dsp_tpu.models.monitor import SpectrumMonitor


def _tone(f, n, amp):
    return amp * np.exp(2j * np.pi * f * np.arange(n))


def test_burst_events_on_known_channels():
    rng = np.random.default_rng(0)
    M, B = 64, 64 * 256
    mon = SpectrumMonitor(M, high_db=10, low_db=6)
    for b in range(24):
        x = 0.05 * (rng.standard_normal(B) + 1j * rng.standard_normal(B))
        if 3 <= b < 10:
            x = x + _tone(5 / M, B, 1.0)
        if 12 <= b < 16:
            x = x + _tone(20 / M, B, 0.7)
        rel = mon.execute_block(x.astype(np.complex64))
        assert rel.shape == (M,)
    chans = sorted(e["channel"] for e in mon.events)
    assert chans == [5, 20]
    ev5 = next(e for e in mon.events if e["channel"] == 5)
    assert ev5["start_block"] == 3
    # release lags the burst end by the EMA memory, bounded
    assert 10 <= ev5["end_block"] <= 16
    assert ev5["peak_rel_db"] > 25
    s = mon.summary()
    assert s["blocks"] == 24 and s["events"] == 2
    assert 5 in s["duty_cycle"] and 20 in s["duty_cycle"]


def test_still_active_channel_reported():
    rng = np.random.default_rng(1)
    M, B = 32, 32 * 128
    mon = SpectrumMonitor(M)
    for b in range(8):
        x = 0.05 * (rng.standard_normal(B) + 1j * rng.standard_normal(B))
        if b >= 2:
            x = x + _tone(9 / M, B, 1.0)
        mon.execute_block(x.astype(np.complex64))
    assert mon.active == [9]
    assert mon.events == []          # not yet closed
    assert "1 events" not in repr(mon)


def test_quiet_band_emits_nothing():
    rng = np.random.default_rng(2)
    M, B = 32, 32 * 128
    mon = SpectrumMonitor(M)
    for _ in range(10):
        x = 0.05 * (rng.standard_normal(B)
                    + 1j * rng.standard_normal(B))
        mon.execute_block(x.astype(np.complex64))
    assert mon.events == [] and mon.active == []


def test_validation():
    with pytest.raises(ValueError):
        SpectrumMonitor(high_db=5, low_db=6)
    with pytest.raises(ValueError):
        SpectrumMonitor(alpha=0.0)
    mon = SpectrumMonitor(64)
    with pytest.raises(ValueError):
        mon.execute_block(np.ones(100, np.complex64))
