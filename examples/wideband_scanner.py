"""Wideband scanner example: drop tones into a wide band, channelize with
the 64-channel polyphase bank + per-channel IIR + AGC (ChannelBank), and
report which channels are occupied.

    python examples/wideband_scanner.py
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

# Demos default to the host CPU so they run everywhere; set
# SOLID_DSP_EXAMPLES_ACCEL=1 to use the accelerator.
if not _os.environ.get("SOLID_DSP_EXAMPLES_ACCEL"):
    import jax as _jax

    _jax.config.update("jax_platforms", "cpu")


import numpy as np

from solid_dsp_tpu.models.channel_bank import ChannelBank


def main() -> None:
    M = 64
    rng = np.random.default_rng(0)
    occupied = sorted(rng.choice(M, size=5, replace=False))
    L = M * 2048
    t = np.arange(L)
    x = 0.002 * (rng.standard_normal(L) + 1j * rng.standard_normal(L))
    for c in occupied:
        f = (c / M) + 0.2 / M * (rng.random() - 0.5)  # inside channel c
        x = x + 0.05 * np.exp(2j * np.pi * f * t + 2j * np.pi * rng.random())
    x = x.astype(np.complex64)

    bank = ChannelBank(M, taps_per_branch=8, agc_bandwidth=0.0)
    Y = np.asarray(bank.execute_block(x))      # (T, M)
    power_db = 10 * np.log10(np.mean(np.abs(Y[64:]) ** 2, axis=0) + 1e-20)
    floor = np.median(power_db)
    hits = sorted(int(c) for c in np.nonzero(power_db > floor + 15)[0])

    print(f"injected channels: {[int(c) for c in occupied]}")
    print(f"detected channels: {hits}  (floor {floor:.1f} dB)")
    assert hits == [int(c) for c in occupied], "detection mismatch"
    print("scanner OK")


if __name__ == "__main__":
    main()
