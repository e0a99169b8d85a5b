"""Front-end impairment estimation and correction: DC offset, IQ imbalance.

Real radio front ends inject a DC spur (LO leakage) and IQ gain/phase
imbalance (image spur); every production SDR stack corrects both before
demodulation.  The reference has nothing here.  All estimators are batch
reductions (means / second moments), so they are one pass over the block
elementwise and shard trivially.

Model: received r = dc + alpha * s + beta * conj(s) for the true signal s
(the conj term IS the IQ imbalance).  The blind estimator assumes s is
proper (E[s^2] = 0, true for noise-like/PSK/QAM signals), so

    dc    = E[r]
    c2    = E[(r - dc)^2]        (improperness — driven by beta)
    p     = E[|r - dc|^2]
    beta/alpha ~= c2 / p         (first order in beta)

and the correction y = (r - dc) - (beta/alpha) * conj(r - dc) restores a
proper signal (image suppressed to second order).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "noise_blanker",
    "estimate_dc", "estimate_iq_imbalance", "correct",
    "apply_iq_imbalance", "image_rejection_db", "ImpairmentCorrector",
]


@jax.jit
def estimate_dc(x):
    """LO-leakage estimate: the complex mean over the block."""
    return jnp.mean(x, axis=-1)


@jax.jit
def estimate_iq_imbalance(x):
    """Blind imbalance ratio k = beta/alpha from second moments.

    Returns the complex k such that y = x0 - k * conj(x0) (x0 = x - dc)
    suppresses the image.  Assumes the underlying signal is proper.
    """
    x0 = x - jnp.mean(x, axis=-1, keepdims=True)
    c2 = jnp.mean(x0 * x0, axis=-1)
    p = jnp.mean(x0 * jnp.conj(x0), axis=-1).real
    # E[r0^2] = 2 alpha beta p_s and E[|r0|^2] ~= |alpha|^2 p_s, so
    # c2/p = 2 beta/conj(alpha); the canceller coefficient is beta/conj(alpha)
    # — hence the factor 1/2 (overcorrecting by 2x mirrors the image at
    # equal power, leaving IRR unchanged)
    return 0.5 * c2 / (p + 1e-30)


@jax.jit
def correct(x, dc, k):
    """Apply DC removal + image cancellation: (x - dc) - k conj(x - dc)."""
    x0 = x - dc[..., None] if jnp.ndim(dc) else x - dc
    kk = k[..., None] if jnp.ndim(k) else k
    return x0 - kk * jnp.conj(x0)


def apply_iq_imbalance(s, gain_db: float, phase_deg: float, dc=0.0):
    """Synthesize an impaired signal (for tests / simulation).

    Standard model: I' = g_i cos-path, Q' = g_q sin-path with phase skew:
        r = dc + alpha s + beta conj(s),
        alpha = (1 + g e^{-j phi}) / 2,  beta = (1 - g e^{+j phi}) / 2
    with g = 10^(gain_db/20), phi = phase_deg in radians.
    """
    g = 10.0 ** (gain_db / 20.0)
    phi = np.deg2rad(phase_deg)
    alpha = 0.5 * (1.0 + g * np.exp(-1j * phi))
    beta = 0.5 * (1.0 - g * np.exp(1j * phi))
    s = jnp.asarray(s)
    return dc + alpha * s + beta * jnp.conj(s)


def image_rejection_db(x) -> float:
    """IRR metric: power of the proper part over the improper part."""
    x0 = np.asarray(x) - np.mean(np.asarray(x))
    c2 = abs(np.mean(x0 * x0))
    p = float(np.mean(np.abs(x0) ** 2))
    return float(10.0 * np.log10(p / (c2 + 1e-30)))


from functools import partial


def ema_correct(x, dc_prev, k_prev, bandwidth, primed):
    """Shared estimate + EMA-blend + correct step.

    ``primed`` may be a python bool or a traced bool (jnp.where handles
    both) — the streaming class and the rx chain's in-jit stage both
    funnel through this so the blend rule cannot drift between them.
    Returns (y, dc, k).
    """
    dc_new = estimate_dc(x)
    k_new = estimate_iq_imbalance(x).astype(dc_prev.dtype)
    b = bandwidth
    use = jnp.asarray(primed)
    dc = jnp.where(use, (1.0 - b) * dc_prev + b * dc_new, dc_new)
    k = jnp.where(use, (1.0 - b) * k_prev + b * k_new, k_new)
    return correct(x, dc, k), dc, k


@partial(jax.jit, static_argnames=("primed",))
def _corrector_block(x, dc_prev, k_prev, bandwidth, primed: bool):
    """Estimate + EMA + correct as one dispatch."""
    return ema_correct(x, dc_prev, k_prev, bandwidth, primed)


class ImpairmentCorrector:
    """Streaming corrector with EMA-tracked estimates.

    Estimates update as exponential moving averages over blocks (bandwidth
    per block, not per sample — front-end impairments drift slowly), so
    the jitted correction path stays one multiply-add per sample.
    """

    def __init__(self, bandwidth: float = 0.1, dtype=jnp.complex64):
        if not (0.0 < bandwidth <= 1.0):
            raise ValueError("bandwidth in (0, 1]")
        self.bandwidth = float(bandwidth)
        self._dc = jnp.zeros((), dtype)
        self._k = jnp.zeros((), dtype)
        self._primed = False

    @property
    def dc(self) -> complex:
        return complex(self._dc)

    @property
    def k(self) -> complex:
        return complex(self._k)

    def execute_block(self, x):
        x = jnp.asarray(x, self._dc.dtype)
        y, self._dc, self._k = _corrector_block(
            x, self._dc, self._k, self.bandwidth, self._primed)
        self._primed = True
        return y

    def reset(self):
        self._dc = jnp.zeros_like(self._dc)
        self._k = jnp.zeros_like(self._k)
        self._primed = False

    def __repr__(self):
        return (f"ImpairmentCorrector [dc={self.dc:.2g}] [k={self.k:.2g}] "
                f"[bw={self.bandwidth}]")


@jax.jit
def noise_blanker(x, k: float = 6.0):
    """Impulse-noise blanker: zero samples whose envelope exceeds
    ``k`` * (robust scale), the classic SDR front-end defense against
    ignition/lightning/radar impulses.

    The scale is the median absolute envelope / 0.6745-ish for a complex
    signal — robust to the impulses themselves (a mean-based threshold
    would be dragged up by the very spikes it should remove).  Returns
    (cleaned, blanked_fraction).
    """
    r = jnp.abs(x)
    scale = jnp.median(r, axis=-1, keepdims=True)
    keep = r <= k * jnp.maximum(scale, 1e-30)
    y = jnp.where(keep, x, 0.0)
    return y, 1.0 - jnp.mean(keep.astype(jnp.float32), axis=-1)
