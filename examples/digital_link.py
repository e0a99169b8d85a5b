"""Digital QPSK link: every link block in one signal path.

    bits -> LinearModem (RRC) -> TxChain upconversion
         -> channel: AWGN + DC offset + IQ imbalance + CFO
         -> ImpairmentCorrector -> downconvert + decimate
         -> 4th-power carrier recovery -> Oerder-Meyr timing -> slicer -> BER

    python examples/digital_link.py
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

if not _os.environ.get("SOLID_DSP_EXAMPLES_ACCEL"):
    import jax as _jax

    _jax.config.update("jax_platforms", "cpu")
    _jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np

from solid_dsp_tpu.models import impairments as imp
from solid_dsp_tpu.models import linear_mod as lm
from solid_dsp_tpu.models import qpsk
from solid_dsp_tpu.models.timing import symbol_sync_block
from solid_dsp_tpu.models.tx_chain import TxChain, TxChainConfig
from solid_dsp_tpu.ops import nco as nco_ops
from solid_dsp_tpu.ops import fir as fir_ops
from solid_dsp_tpu.design import firdes


def main() -> int:
    rng = np.random.default_rng(7)
    n_bits = 4000
    sps, P, fc = 4, 2, 0.9  # samples/symbol, tx interpolation, carrier

    # ---------------- transmit ----------------
    modem = lm.LinearModem(scheme="psk", m=4, sps=sps, dtype=jnp.complex128)
    bits = rng.integers(0, 2, n_bits)
    bb = np.asarray(modem.modulate(bits))
    tx = TxChain(TxChainConfig(modulation="none", carrier_freq=fc,
                               interpolation=P, dtype=jnp.complex128))
    iq = np.asarray(tx.execute_block(bb))
    print(f"tx: {n_bits} bits -> {len(iq)} samples at carrier {fc:.2f} rad")

    # ---------------- channel ----------------
    cfo = 3e-4  # residual carrier offset, cycles/sample
    k = np.arange(len(iq))
    rxs = iq * np.exp(2j * np.pi * cfo * k)
    rxs = np.asarray(imp.apply_iq_imbalance(jnp.asarray(rxs), 0.6, 4.0,
                                            dc=0.04 - 0.02j))
    rxs = rxs + 0.02 * (rng.standard_normal(len(rxs))
                        + 1j * rng.standard_normal(len(rxs)))
    print(f"channel: CFO {cfo}, 0.6 dB / 4deg IQ imbalance, DC, AWGN")

    # ---------------- receive ----------------
    corr = imp.ImpairmentCorrector(dtype=jnp.complex128)
    rxs = np.asarray(corr.execute_block(rxs))
    print(f"impairments corrected: dc_hat={corr.dc:.3f}, |k_hat|="
          f"{abs(corr.k):.4f}")

    # downconvert + decimate back to the modem rate (sps per symbol)
    theta = nco_ops.constrain(fc)
    mixed, _ = nco_ops.mix_down_block(jnp.asarray(rxs), jnp.uint32(0),
                                      theta, None, "exact")
    lp = firdes.firdes_kaiser(64, 0.5 / P, 60.0, 0.0)
    lp = lp / np.sum(lp)
    y, _, _ = fir_ops.fir_decim_apply(
        jnp.asarray(lp, jnp.complex128),
        fir_ops.fir_init(64, jnp.complex128), jnp.int32(0), mixed,
        jnp.asarray(1.0, jnp.complex128), P)

    # carrier recovery (4th power) + matched filter + symbol timing
    y, f_hat, _ = qpsk.qpsk_carrier_block(jnp.asarray(y))
    print(f"carrier recovery: residual f_hat={float(f_hat)/(2*np.pi):.2e} "
          "cycles/sample")
    y = lm.matched_filter(y, sps)
    syms, tau = symbol_sync_block(jnp.asarray(y), sps)
    print(f"timing recovery: tau={float(tau):.3f} samples")

    # slice + count errors over the aligned run (search small offsets and
    # the QPSK pi/2 phase ambiguity)
    want = np.asarray(lm.bits_to_symbols(bits, 2))
    pts = lm.psk_constellation(4)
    got_pts = np.asarray(syms)
    got_pts = got_pts / (np.sqrt(np.mean(np.abs(got_pts) ** 2)) + 1e-30)
    best_ber = 1.0
    for rot in range(4):
        cand = np.asarray(lm.slice_symbols(
            jnp.asarray(got_pts * np.exp(1j * rot * np.pi / 2)), pts))
        for off in range(0, 30):
            nmin = min(len(cand) - off, len(want)) - 20
            if nmin <= 100:
                continue
            errs = np.mean(cand[off: off + nmin] != want[:nmin])
            best_ber = min(best_ber, errs)
    print(f"symbol error rate: {best_ber:.4f} over ~{len(want)} symbols")
    assert best_ber < 0.01, "link failed"
    print("link OK")
    return 0


if __name__ == "__main__":
    sys_exit = main()
    raise SystemExit(sys_exit)
