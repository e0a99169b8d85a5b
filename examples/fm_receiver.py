"""FM receiver example: synthesize a broadcast-style signal, record it as
ci16 IQ, then demodulate it with the flagship RxChain streamed through the
native C++ prefetch pump.

    python examples/fm_receiver.py [recording.ci16]
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

# Demos default to the host CPU so they run everywhere; set
# SOLID_DSP_EXAMPLES_ACCEL=1 to use the accelerator.
if not _os.environ.get("SOLID_DSP_EXAMPLES_ACCEL"):
    import jax as _jax

    _jax.config.update("jax_platforms", "cpu")


import sys
import tempfile

import jax.numpy as jnp
import numpy as np

from solid_dsp_tpu.models.fm import fm_modulate
from solid_dsp_tpu.models.rx_chain import RxChain
from solid_dsp_tpu.runtime import StreamPump, write_iq
from solid_dsp_tpu.utils.metrics import MetricsCollector


def make_recording(path: str, n: int = 1 << 20) -> np.ndarray:
    """Two-tone message, FM modulated, upconverted, quantized to ci16."""
    t = np.arange(n)
    msg = (0.7 * np.sin(2 * np.pi * 0.0008 * t)
           + 0.3 * np.sin(2 * np.pi * 0.0031 * t))
    iq, _ = fm_modulate(jnp.asarray(msg, jnp.float32), kf=0.08)
    carrier = np.exp(2j * np.pi * (0.2 / (2 * np.pi)) * t)
    write_iq(path, (np.asarray(iq) * 0.25 * carrier).astype(np.complex64),
             "ci16")
    return msg


def main() -> None:
    path = sys.argv[1] if len(sys.argv) > 1 else tempfile.mktemp(".ci16")
    msg = make_recording(path)
    print(f"recording: {path}")

    chain = RxChain(carrier_freq=0.2, decimation=4, fir_taps=64,
                    demod="fm", fm_kf=0.08, nco_mode="exact",
                    agc_mode="block", dtype=jnp.complex64)
    mc = MetricsCollector(sink=lambda m: print("  " + m.to_json()))

    audio = []
    with StreamPump(path, fmt="ci16", block=1 << 18) as pump:
        for block in pump:
            block = block[: len(block) - len(block) % 4]
            if len(block):
                audio.append(np.asarray(mc.measure(chain, block)))
    audio = np.concatenate(audio)

    m4 = msg[::4][: len(audio)]
    corr = np.corrcoef(audio[1000:], m4[1000: len(audio)])[0, 1]
    print(f"demodulated {len(audio)} audio samples; "
          f"message correlation = {corr:.4f}")


if __name__ == "__main__":
    main()
