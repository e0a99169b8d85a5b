"""Blind signal characterization: detect -> rate -> CFO -> classify -> demod.

An unknown burst appears somewhere in a noisy capture.  Without being
told anything about it, the pipeline:

1. finds the burst (energy detector with hysteresis),
2. blind-estimates the SYMBOL RATE from the cyclostationary symbol-clock
   feature (analysis.cyclo.estimate_symbol_rate),
3. blind-estimates the CARRIER OFFSET from the 4th-power spectral line
   (QPSK strips modulation at x^4; analysis.estimate.tone_freq_fft),
4. corrects the CFO, recovers symbol timing (Oerder-Meyr),
5. classifies the constellation (moment hypothesis tests), and
6. demodulates and reports EVM + SNR.

    python examples/blind_characterize.py
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

if not _os.environ.get("SOLID_DSP_EXAMPLES_ACCEL"):
    import jax as _jax

    _jax.config.update("jax_platforms", "cpu")


import jax.numpy as jnp
import numpy as np

from solid_dsp_tpu.analysis.cyclo import estimate_symbol_rate
from solid_dsp_tpu.analysis.estimate import tone_freq_fft
from solid_dsp_tpu.analysis.snr import evm
from solid_dsp_tpu.models import linear_mod as lm
from solid_dsp_tpu.models.channel import apply_cfo
from solid_dsp_tpu.models.detect import BurstDetector
from solid_dsp_tpu.models.modclass import classify
from solid_dsp_tpu.models.timing import oerder_meyr_offset


def main() -> None:
    rng = np.random.default_rng(7)

    # ---- the unknown transmitter (hidden from the receiver side) ----
    SPS_TRUE, CFO_TRUE, M_TRUE = 7, 0.0137, 4
    n_sym = 3000
    sym = np.asarray(lm.constellation("psk", M_TRUE))[
        rng.integers(0, M_TRUE, n_sym)]
    burst = np.asarray(lm.pulse_shape(
        jnp.asarray(sym.astype(np.complex64)), SPS_TRUE, flush=True))
    burst = np.asarray(apply_cfo(burst, CFO_TRUE, 0.3))
    gap = 6000
    x = 0.05 * (rng.standard_normal(2 * gap + burst.size)
                + 1j * rng.standard_normal(2 * gap + burst.size))
    x = x.astype(np.complex64)
    x[gap: gap + burst.size] += burst

    # ---- 1. burst detection -------------------------------------------
    det = BurstDetector(window=256, high_db=-15.0, low_db=-19.0)
    r = det.execute_block(jnp.asarray(x))
    rises = [int(v) for v in np.asarray(r["rises"]) if v >= 0]
    falls = [int(v) for v in np.asarray(r["falls"]) if v >= 0]
    b0, b1 = rises[0], falls[0]
    print(f"burst: [{b0}, {b1}) (true [{gap}, {gap + burst.size}))")
    y = np.asarray(x[b0:b1])

    # ---- 2. blind symbol rate (cyclic feature) ------------------------
    r = estimate_symbol_rate(y, 1 / 24, 1 / 3)
    sps_est = 1.0 / r["alpha_hat"]
    print(f"symbol rate: alpha={r['alpha_hat']:.6f} -> "
          f"sps={sps_est:.3f} (true {SPS_TRUE})")

    # ---- 3. blind CFO (4th-power line at 4*cfo) ------------------------
    y4 = (y / (np.abs(y) + 1e-12)) ** 4
    cfo_est = float(tone_freq_fft(jnp.asarray(y4.astype(np.complex64)))) / 4
    print(f"cfo: {cfo_est:+.6f} (true {CFO_TRUE:+.6f})")

    # ---- 4. correct + timing ------------------------------------------
    y = np.asarray(apply_cfo(y, -cfo_est))
    sps = int(round(sps_est))
    yb = y[: (y.size // sps) * sps]
    mf = np.asarray(lm.matched_filter(jnp.asarray(yb), sps))
    tau = float(oerder_meyr_offset(jnp.asarray(mf), sps))
    k0 = int(round(tau)) % sps
    syms = mf[k0::sps]
    syms = syms / np.sqrt(np.mean(np.abs(syms) ** 2) + 1e-30)

    # ---- 5. classify + 6. demodulate ----------------------------------
    label, scores = classify(jnp.asarray(syms.astype(np.complex64)))
    print(f"classified: {label}")
    pts = np.asarray(lm.constellation("psk", 4))
    # fold out the residual common phase with a 4th-power estimate
    rot = np.angle(np.mean(syms ** 4)) / 4
    syms = syms * np.exp(-1j * (rot + np.pi / 4))
    hard = np.asarray(lm.slice_symbols(jnp.asarray(
        syms.astype(np.complex64)), pts))
    e = float(evm(jnp.asarray(syms.astype(np.complex64)),
                  jnp.asarray(pts[hard])))
    print(f"EVM {e * 100:.1f}% (SNR ~{-20 * np.log10(e + 1e-12):.1f} dB) "
          f"over {len(syms)} symbols")


if __name__ == "__main__":
    main()
