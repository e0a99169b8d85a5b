"""Cyclostationary analysis: time-smoothed cyclic periodograms.

Digitally modulated signals are cyclostationary: their autocorrelation is
periodic in the symbol clock (and, for non-circular constellations like
BPSK/GMSK, in twice the carrier).  The spectral correlation function
(SCF) S_x^alpha(f) exposes those hidden periodicities as ridges at cycle
frequencies alpha, enabling detection and classification of signals far
below the noise floor where energy detection (models/detect.py) fails,
and complementing the moment-based classifier (models/modclass.py).

The estimator here is the time-smoothed cyclic periodogram: frequency
shift the signal by ±alpha/2, STFT both branches, and average the
cross-products over frames,

    S_x^alpha(f) ~= mean_p  X_p^+(f) * conj(X_p^-(f)),
    X^{+/-} = STFT( x(n) * exp(-/+ j*pi*alpha*n) ),

which keeps the inter-frame cycle-phase rotation automatically correct
(the full-length modulation carries the exp(-j*2*pi*alpha*hop*p) frame
compensation the FFT-accumulation method applies explicitly).  The whole
candidate-alpha grid evaluates as one batched STFT stack — frames x
alphas x nfft — so the work is windowed-FFT dominated and lands on the
batched-FFT/matmul path, exactly like analysis/spectral.py.

The normalized magnitude (spectral coherence)

    C_x^alpha(f) = |S_x^alpha(f)| / sqrt( S^0(f + a/2) * S^0(f - a/2) )

is scale-free in [0, 1] and is what the detector thresholds.

References: Gardner, "Exploitation of spectral redundancy in cyclo-
stationary signals" (IEEE SP Mag 1991); the reference framework has no
counterpart (its analysis layer stops at PSD/group delay) — this extends
solid_dsp_tpu's analysis surface the same way radar/array_proc extended
the model surface.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .spectral import _window_taps, frame_signal

__all__ = ["cyclic_spectrum", "cycle_profile", "detect_cyclic_features",
           "estimate_symbol_rate"]


@partial(jax.jit, static_argnames=("nfft", "hop", "window", "conjugate",
                                   "coherent_frames"))
def cyclic_spectrum(x, alphas, nfft: int = 256, hop: int = 64,
                    window: str = "hann", conjugate: bool = False,
                    coherent_frames: int | None = None):
    """SCF and spectral coherence on a grid of cycle frequencies.

    x: (N,) complex baseband.  alphas: (A,) cycle frequencies in cycles/
    sample (the symbol-rate feature of a linear modem at ``sps`` samples/
    symbol sits at alpha = 1/sps; the conjugate carrier feature of BPSK
    at offset f0 sits at alpha = 2*f0 with ``conjugate=True``).

    CYCLE RESOLUTION: a genuine feature is only ~1/len(x) wide in alpha
    when all P frames average coherently — the grid must contain the true
    cycle frequency to within ~1/(2 len(x)).  For coarse scanning pass
    ``coherent_frames=Q``: frames then average coherently only within
    groups of Q (magnitudes averaged across groups), widening the alpha
    tolerance to ~1/(Q*hop) at a sqrt(P/Q) SNR cost.  See
    estimate_symbol_rate for the two-stage coarse->fine search.

    Returns (scf, coherence), both (A, nfft) with the frequency axis in
    natural FFT bin order (bin k = k/nfft cycles/sample), matching
    analysis/spectral.welch_psd.  coherence is |scf| normalized by the
    branch PSDs, in [0, 1].  With coherent_frames set, scf is the
    magnitude of the segment averages (phase is discarded).
    """
    x = jnp.asarray(x)
    if not jnp.issubdtype(x.dtype, jnp.complexfloating):
        x = x.astype(jnp.complex64)
    alphas = jnp.asarray(alphas, jnp.float32)
    n = jnp.arange(x.shape[-1], dtype=jnp.float32)
    # branch modulators: x * exp(-j pi a n) places X(f + a/2) at f
    ph = jnp.pi * alphas[:, None] * n[None, :]
    rot = jnp.exp(-1j * ph.astype(jnp.float32)).astype(x.dtype)
    up = x[None, :] * rot                      # (A, N): spectrum shifted DOWN
    base = jnp.conj(x) if conjugate else x
    dn = base[None, :] * jnp.conj(rot)         # (A, N): shifted UP

    taps = jnp.asarray(_window_taps(window, nfft), x.real.dtype)

    def stft_all(y):
        fr = jax.vmap(lambda v: frame_signal(v, nfft, hop))(y)  # (A,P,nfft)
        return jnp.fft.fft(fr * taps[None, None, :], axis=-1)

    Xp = stft_all(up)
    Xm = stft_all(dn)
    prod = Xp * jnp.conj(Xm)                                    # (A,P,nfft)
    if coherent_frames is None:
        scf = jnp.mean(prod, axis=1)                            # (A, nfft)
        mag = jnp.abs(scf)
    else:
        Q = int(coherent_frames)
        P = prod.shape[1]
        G = P // Q
        seg = jnp.mean(prod[:, :G * Q].reshape(prod.shape[0], G, Q, nfft),
                       axis=2)
        mag = jnp.mean(jnp.abs(seg), axis=1)                    # (A, nfft)
        scf = mag.astype(prod.dtype)
    psd_p = jnp.mean(jnp.abs(Xp) ** 2, axis=1)
    psd_m = jnp.mean(jnp.abs(Xm) ** 2, axis=1)
    coh = mag / jnp.sqrt(psd_p * psd_m + 1e-30)
    return scf, coh


def cycle_profile(x, alphas, nfft: int = 256, hop: int = 64,
                  window: str = "hann", conjugate: bool = False,
                  coherent_frames: int | None = None):
    """Max spectral coherence over f per candidate alpha — the 1-D
    "alpha profile" used for cycle-frequency scanning."""
    _, coh = cyclic_spectrum(x, alphas, nfft, hop, window, conjugate,
                             coherent_frames)
    return jnp.max(coh, axis=-1)


def detect_cyclic_features(x, alphas, nfft: int = 256, hop: int = 64,
                           window: str = "hann", conjugate: bool = False,
                           threshold: float | None = None):
    """Scan an alpha grid and report detected cycle frequencies.

    With ``threshold=None`` a data-driven gate is used:
    max(median + 6 * MAD, 1.5 * median), robust because genuine features
    are sparse in alpha while the noise-only profile (a max of Rayleigh
    magnitudes over f) concentrates tightly around its median.
    Returns a dict with the profile, the boolean detections, and the
    strongest alpha (alpha_hat, as a float, nan if nothing detected).
    """
    alphas = np.asarray(alphas, np.float32)
    prof = np.asarray(cycle_profile(x, alphas, nfft, hop, window, conjugate))
    return _gate_profile(alphas, prof, threshold)


def _gate_profile(alphas, prof, threshold):
    if threshold is None:
        med = float(np.median(prof))
        mad = float(np.median(np.abs(prof - med))) + 1e-12
        threshold = max(med + 6.0 * mad, 1.5 * med)
    hits = prof > threshold
    alpha_hat = float(alphas[int(np.argmax(prof))]) if hits.any() else float("nan")
    return {"alphas": alphas, "profile": prof, "detected": hits,
            "threshold": float(threshold), "alpha_hat": alpha_hat,
            "peak": float(prof.max())}


def estimate_symbol_rate(x, lo: float, hi: float, nfft: int = 256,
                         hop: int = 64, window: str = "hann",
                         coherent_frames: int = 8,
                         conjugate: bool = False) -> dict:
    """Blind symbol-rate search on [lo, hi] cycles/sample, coarse -> fine.

    Stage 1 scans at the widened tolerance 1/(coherent_frames*hop) using
    segmented (incoherent) averaging; stage 2 re-evaluates a dense fully-
    coherent grid (step 1/(2N)) around the coarse peak.  Returns the
    detect_cyclic_features dict of the fine stage plus "alpha_coarse".

    Linear modems at sps samples/symbol put the feature at alpha = 1/sps;
    pass ``conjugate=True`` to search doubled-carrier features instead.
    """
    x = jnp.asarray(x)
    N = int(x.shape[-1])
    tol = 1.0 / (coherent_frames * hop)
    coarse = np.arange(lo, hi, tol / 2, dtype=np.float64)
    if coarse.size < 2:
        raise ValueError("search range narrower than the coarse step")
    prof_c = np.asarray(cycle_profile(
        x, coarse.astype(np.float32), nfft, hop, window, conjugate,
        coherent_frames))
    a0 = float(coarse[int(np.argmax(prof_c))])
    fine = np.arange(max(lo, a0 - tol), min(hi, a0 + tol), 0.5 / N,
                     dtype=np.float64)
    prof_f = np.asarray(cycle_profile(
        x, fine.astype(np.float32), nfft, hop, window, conjugate))
    out = _gate_profile(fine.astype(np.float32), prof_f, None)
    out["alpha_coarse"] = a0
    return out
