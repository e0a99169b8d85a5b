"""2x2 MIMO link + Alamouti diversity, end to end.

    Part A — spatial multiplexing: two independent QPSK streams through a
    Rayleigh 2x2 channel; ZF vs LMMSE vs exact-ML joint detection SER.
    Part B — Alamouti 2x1 STBC at the same total power vs a SISO link:
    transmit diversity turns deep fades into the sum channel |h0|^2+|h1|^2.
    Part C — per-tone detection inside an OFDM frame (one-tap MIMO per
    subcarrier): the batched detectors run over all (symbol, subcarrier)
    pairs in one call — accelerator-shaped joint detection.

    python examples/mimo_link.py
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

from solid_dsp_tpu.models.mimo import (
    alamouti_decode, alamouti_encode, mimo_capacity, ml_detect,
    mmse_detect, slice_nearest, zf_detect)

QPSK = np.array([1 + 1j, 1 - 1j, -1 + 1j, -1 - 1j]) / np.sqrt(2)


def main() -> int:
    rng = np.random.default_rng(11)
    snr_db = 12.0
    nv = 10 ** (-snr_db / 10)

    # ---------- A: 2x2 spatial multiplexing ----------
    N = 50_000
    H = (rng.standard_normal((N, 2, 2))
         + 1j * rng.standard_normal((N, 2, 2))) / np.sqrt(2)
    si = rng.integers(0, 4, (N, 2))
    s = QPSK[si]
    y = (np.einsum("nrt,nt->nr", H, s)
         + (rng.standard_normal((N, 2)) + 1j * rng.standard_normal((N, 2)))
         * np.sqrt(nv * 2 / 2))

    def ser(idx):
        return float(np.mean(np.asarray(idx) != si))

    e_zf = ser(slice_nearest(zf_detect(H, y), QPSK)[0])
    e_mmse = ser(slice_nearest(mmse_detect(H, y, nv * 2), QPSK)[0])
    e_ml = ser(ml_detect(H, y, jnp.asarray(QPSK))[0])
    cap = float(np.mean(np.asarray(mimo_capacity(H, 10 ** (snr_db / 10)))))
    print(f"A: 2x2 multiplexing at {snr_db:.0f} dB — SER  "
          f"ZF {e_zf:.4f} | MMSE {e_mmse:.4f} | ML {e_ml:.4f}   "
          f"(ergodic capacity {cap:.1f} b/use)")
    assert e_ml < e_mmse < e_zf

    # ---------- B: Alamouti 2x1 vs SISO ----------
    M = 200_000
    bi = rng.integers(0, 4, M)
    b = QPSK[bi]
    noise = (rng.standard_normal(M) + 1j * rng.standard_normal(M)
             ) * np.sqrt(nv / 2)
    tx = np.asarray(alamouti_encode(b)) / np.sqrt(2)   # total power split
    h = (rng.standard_normal((M // 2, 2))
         + 1j * rng.standard_normal((M // 2, 2))) / np.sqrt(2)
    yb = np.sum(tx * np.repeat(h, 2, axis=0), axis=-1) + noise
    sh, g = alamouti_decode(yb, jnp.asarray(h))
    soft = np.asarray(sh) / np.maximum(np.asarray(g), 1e-30) * np.sqrt(2)
    e_ala = float(np.mean(np.asarray(slice_nearest(soft, QPSK)[0]) != bi))
    h1 = (rng.standard_normal(M) + 1j * rng.standard_normal(M)) / np.sqrt(2)
    e_siso = float(np.mean(np.asarray(
        slice_nearest((h1 * b + noise) / h1, QPSK)[0]) != bi))
    print(f"B: Alamouti 2x1 SER {e_ala:.4f} vs SISO {e_siso:.4f} "
          f"(same total power — diversity gain x{e_siso / e_ala:.1f})")
    assert e_ala < e_siso

    # ---------- C: MIMO-OFDM, one-tap detection per subcarrier ----------
    n_sym, n_sc = 20, 256
    # frequency-selective 2x2 channel: L-tap impulse responses per pair
    L = 8
    ht = (rng.standard_normal((2, 2, L))
          + 1j * rng.standard_normal((2, 2, L))) / np.sqrt(2 * L)
    Hf = np.fft.fft(ht, n_sc, axis=-1)                 # (2, 2, n_sc)
    Hf = np.moveaxis(Hf, -1, 0)                        # (n_sc, 2, 2)
    Hgrid = np.broadcast_to(Hf, (n_sym, n_sc, 2, 2))
    si3 = rng.integers(0, 4, (n_sym, n_sc, 2))
    s3 = QPSK[si3]
    y3 = (np.einsum("fsrt,fst->fsr", Hgrid, s3)
          + (rng.standard_normal((n_sym, n_sc, 2))
             + 1j * rng.standard_normal((n_sym, n_sc, 2)))
          * np.sqrt(nv * 2 / 2))
    idx3, _ = ml_detect(Hgrid, y3, jnp.asarray(QPSK))  # one batched call
    e_ofdm = float(np.mean(np.asarray(idx3) != si3))
    print(f"C: MIMO-OFDM {n_sym}x{n_sc} grid, joint-ML per tone in one "
          f"call — SER {e_ofdm:.4f}")
    assert e_ofdm < 0.1
    print("ok")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
