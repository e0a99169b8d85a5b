"""Spectrum survey: channelize a wideband capture, detect occupied
channels, then estimate SNR and classify the modulation of each.

Composes the 64-channel polyphase bank, the energy detector, the blind
M2M4 SNR estimator, and the moment-hypothesis modulation classifier.

    python examples/spectrum_survey.py
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

if not _os.environ.get("SOLID_DSP_EXAMPLES_ACCEL"):
    import jax as _jax

    _jax.config.update("jax_platforms", "cpu")


import jax.numpy as jnp
import numpy as np

from solid_dsp_tpu.analysis.snr import snr_m2m4
from solid_dsp_tpu.models.channelizer import (PolyphaseChannelizer,
                                              PolyphaseSynthesizer)
from solid_dsp_tpu.models.linear_mod import constellation
from solid_dsp_tpu.models.modclass import classify


def _burst(scheme, m, n, rng):
    pts = np.asarray(constellation(scheme, m))
    pts = pts / np.sqrt(np.mean(np.abs(pts) ** 2))
    return pts[rng.integers(0, m, n)]


def main() -> None:
    M = 64
    T = 4096                   # channel-rate samples
    rng = np.random.default_rng(0)
    # occupied channels: (index, scheme, order, amplitude)
    plan = [(7, "psk", 4, 1.0), (19, "qam", 16, 0.8), (41, "psk", 2, 0.5)]

    # fill the plan channels with symbol streams and build the wideband
    # signal with the synthesis bank (the transmit dual of the analyzer)
    Ytx = np.zeros((T, M), np.complex128)
    for c, scheme, m, amp in plan:
        Ytx[:, c] = amp * _burst(scheme, m, T, rng)
    synth = PolyphaseSynthesizer(num_channels=M, taps_per_branch=8)
    x = np.asarray(synth.execute_block(jnp.asarray(Ytx)))
    x = x + 0.02 * (rng.standard_normal(len(x))
                    + 1j * rng.standard_normal(len(x)))
    x = x.astype(np.complex64)

    ch = PolyphaseChannelizer(num_channels=M, taps_per_branch=8)
    Y = np.asarray(ch.execute_block(jnp.asarray(x)))    # (T, M)
    Y = Y[64:]                                          # drop filter warmup

    powers = np.mean(np.abs(Y) ** 2, axis=0)
    floor = np.median(powers)
    # occupied = above the floor AND a local peak (critically-sampled
    # channels leak a transition-band shoulder into their neighbors)
    above = powers > 10 * floor
    peak = (powers >= np.roll(powers, 1)) & (powers >= np.roll(powers, -1))
    occupied = np.nonzero(above & peak)[0]
    print(f"noise floor {10 * np.log10(floor):.1f} dB; "
          f"{len(occupied)} occupied channels")

    found = {}
    for c in occupied:
        z = jnp.asarray(Y[:, c])
        snr_db = 10 * np.log10(float(snr_m2m4(z)) + 1e-12)
        label, _ = classify(z)
        found[int(c)] = (label, snr_db)
        print(f"  ch {c:2d}: {str(label):14s} SNR {snr_db:5.1f} dB")

    expect = {c: (s, m) for c, s, m, _ in plan}
    assert set(found) == set(expect), (found, expect)
    for c, (s, m) in expect.items():
        assert found[c][0] == (s, m), (c, found[c])
    print("survey OK")


if __name__ == "__main__":
    main()
