"""OFDM link example: full transmit -> multipath channel + CFO + noise ->
Schmidl-Cox sync -> CFO correction -> pilot equalization -> SER.

    python examples/ofdm_link.py
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

# Demos default to the host CPU so they run everywhere; set
# SOLID_DSP_EXAMPLES_ACCEL=1 to use the accelerator.
if not _os.environ.get("SOLID_DSP_EXAMPLES_ACCEL"):
    import jax as _jax

    _jax.config.update("jax_platforms", "cpu")


import jax.numpy as jnp
import numpy as np

from solid_dsp_tpu.models import ofdm, qpsk

NFFT, CP, NACT = 64, 16, 48


def main() -> None:
    rng = np.random.default_rng(1)
    T = 40
    tx_idx = rng.integers(0, 4, (T, NACT))
    syms = np.asarray(qpsk.qpsk_modulate_symbols(jnp.asarray(tx_idx)))
    pilot = np.asarray(qpsk.qpsk_modulate_symbols(
        jnp.asarray(np.zeros(NACT, np.int64))))

    pre = ofdm.schmidl_cox_preamble(NFFT, CP)
    frame = np.concatenate([
        pre,
        np.asarray(ofdm.ofdm_modulate(
            jnp.asarray(np.concatenate([pilot[None], syms]), jnp.complex64),
            NFFT, CP, NACT)),
    ])

    # channel: random delay + multipath + CFO + AWGN
    delay = int(rng.integers(50, 400))
    h = np.array([1.0, 0.0, 0.35 - 0.2j, 0.0, 0.1j])
    cfo = 0.0012
    stream = np.concatenate([np.zeros(delay), frame, np.zeros(128)])
    stream = np.convolve(stream, h)[: len(stream)]
    stream *= np.exp(2j * np.pi * cfo * np.arange(len(stream)))
    stream += 0.02 * (rng.standard_normal(len(stream))
                      + 1j * rng.standard_normal(len(stream)))
    stream = stream.astype(np.complex64)

    start, cfo_hat = ofdm.schmidl_cox_sync(jnp.asarray(stream), NFFT, CP)
    print(f"sync: start={int(start)} (preamble body at {delay + CP}), "
          f"cfo_hat={float(cfo_hat):.6f} (true {cfo})")

    derot = stream * np.exp(-2j * np.pi * float(cfo_hat)
                            * np.arange(len(stream)))
    frame0 = int(start) + NFFT - CP // 2
    Y = ofdm.ofdm_demodulate(
        jnp.asarray(derot[frame0: frame0 + (T + 1) * (NFFT + CP)]),
        NFFT, CP, NACT)
    H = ofdm.estimate_channel(Y[0], jnp.asarray(pilot, jnp.complex64))
    got = np.asarray(qpsk.qpsk_slice(ofdm.equalize(Y[1:], H)))

    ser = float((got != tx_idx).mean())
    print(f"SER = {ser:.4f} over {T * NACT} symbols")
    assert ser < 0.01
    print("link OK")


if __name__ == "__main__":
    main()
