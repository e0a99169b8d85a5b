"""Transmit linearization example: OFDM waveform -> crest-factor reduction
-> memory-polynomial DPD -> Saleh PA, with PAPR / EVM / ACPR before and
after each stage.

    python examples/tx_linearization.py
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

if not _os.environ.get("SOLID_DSP_EXAMPLES_ACCEL"):
    import jax as _jax

    _jax.config.update("jax_platforms", "cpu")


import jax.numpy as jnp
import numpy as np

from solid_dsp_tpu.analysis.spectral import welch_psd
from solid_dsp_tpu.models.cfr import band_mask, cfr_icf, papr_db
from solid_dsp_tpu.models.dpd import dpd_learn, mp_apply, saleh_pa


def evm_db(y, ref):
    g = np.vdot(ref, y) / np.vdot(ref, ref)
    e = y - g * ref
    return float(10 * np.log10(np.real(np.vdot(e, e)
                                       / np.vdot(g * ref, g * ref))))


def acpr_db(sig, occupied):
    p = np.fft.fftshift(np.asarray(welch_psd(jnp.asarray(sig),
                                             nfft=1024, hop=512)))
    m = np.fft.fftshift(band_mask(1024, occupied + 0.06)) > 0
    return float(10 * np.log10(np.sum(p[~m]) / np.sum(p[m])))


def main() -> None:
    n, occ, rms = 1 << 15, 0.25, 0.24
    rng = np.random.default_rng(0)
    X = np.zeros(n, np.complex128)
    half = int(n * occ / 2)
    idx = np.r_[np.arange(1, half), np.arange(n - half, n)]
    X[idx] = np.exp(2j * np.pi * rng.random(len(idx)))
    x = np.fft.ifft(X) * np.sqrt(n / len(idx))
    x = (rms * x / np.sqrt(np.mean(np.abs(x) ** 2))).astype(np.complex64)

    print(f"waveform: {n} samples, {occ:.0%} occupied, rms {rms}")
    print(f"  raw PAPR {float(papr_db(jnp.asarray(x))):.1f} dB, "
          f"peak {np.max(np.abs(x)):.3f} "
          f"(Saleh linearizable peak ~0.466)")

    # 1. CFR: pull peaks inside the PA's linearizable range
    thr = rms * 10 ** (5.0 / 20)
    xc = cfr_icf(jnp.asarray(x), thr,
                 jnp.asarray(band_mask(n, occ + 0.02)), iters=6)
    xc_np = np.asarray(xc)
    print(f"  after CFR: PAPR {float(papr_db(xc)):.1f} dB, "
          f"peak {np.max(np.abs(xc_np)):.3f}, "
          f"CFR EVM {evm_db(xc_np, x):.1f} dB")

    # 2. PA without DPD
    y_raw = np.asarray(saleh_pa(xc))
    print(f"  PA alone:    EVM {evm_db(y_raw, xc_np):6.1f} dB, "
          f"ACPR {acpr_db(y_raw, occ):6.1f} dB")

    # 3. DPD (indirect learning) then PA
    coefs, g = dpd_learn(saleh_pa, xc, order=7, memory=1, iters=3)
    y_dpd = np.asarray(saleh_pa(mp_apply(coefs, xc, 7, 1)))
    print(f"  CFR+DPD+PA:  EVM {evm_db(y_dpd, xc_np):6.1f} dB, "
          f"ACPR {acpr_db(y_dpd, occ):6.1f} dB")
    assert evm_db(y_dpd, xc_np) < evm_db(y_raw, xc_np) - 15
    print("tx linearization OK")


if __name__ == "__main__":
    main()
