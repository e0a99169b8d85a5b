"""Framed packet link: PacketModem bursts through an impaired channel.

    bytes -> CRC-32 -> scramble -> FEC (Viterbi or LDPC) -> QPSK/RRC
          -> [ZC,ZC] preamble -> channel (offset, CFO, phase, AWGN)
          -> FrameSync -> soft LLRs -> decode -> CRC check

Sweeps Es/N0 and prints packet success rates for both FEC schemes.

    python examples/packet_link.py
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(
    _os.path.abspath(__file__))))

if not _os.environ.get("SOLID_DSP_EXAMPLES_ACCEL"):
    import jax as _jax

    _jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np

from solid_dsp_tpu.models import channel as ch
from solid_dsp_tpu.models.packet import PacketModem


def run_scheme(fec_scheme: str, esn0_db_list, n_packets=8, seed=0) -> None:
    pm = PacketModem(payload_bytes=64, fec_scheme=fec_scheme)
    rng = np.random.default_rng(seed)
    print(f"\n{fec_scheme}: n={pm.n_coded} coded bits, "
          f"{pm.frame_samples} samples/burst")
    for esn0 in esn0_db_list:
        ok = 0
        for k in range(n_packets):
            data = bytes(rng.integers(0, 256, 64, dtype=np.uint8))
            iq = np.asarray(pm.transmit(data))
            n_total = len(iq) + 600
            off = int(rng.integers(100, 500))
            x = np.zeros(n_total, complex)
            x[off: off + len(iq)] = iq
            x = np.array(ch.apply_cfo(jnp.asarray(x),
                                      float(rng.uniform(-5e-4, 5e-4)),
                                      float(rng.uniform(0, 6.28))))
            # symbol energy ~ 1/sps spread over sps samples; reference the
            # burst's own mean power for the target Es/N0
            p_sig = np.mean(np.abs(iq) ** 2)
            sigma = np.sqrt(p_sig / 10 ** (esn0 / 10) / 2)
            x += sigma * (rng.normal(size=n_total)
                          + 1j * rng.normal(size=n_total))
            got, info = pm.receive(jnp.asarray(x))
            ok += int(info["crc_ok"] and got == data)
        print(f"  Es/N0 {esn0:5.1f} dB: {ok}/{n_packets} packets OK")


def main() -> int:
    esn0 = [0.0, 2.0, 4.0, 8.0]
    run_scheme("conv", esn0)
    run_scheme("ldpc", esn0)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
