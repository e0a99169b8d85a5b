"""Parameter estimation: tone frequency/phase, time-delay (GCC-PHAT).

Estimation primitives that sit under the synchronizers (models/timing.py,
models/framesync.py) and beside the array layer (models/array_proc.py):

* ``tone_freq_kay`` — Kay's weighted phase-difference estimator, the
  closed-form near-CRLB single-tone frequency estimator at moderate+ SNR
  (Kay, IEEE T-ASSP 1989).  One elementwise pass + a dot product, no
  search.
* ``tone_freq_fft`` — coarse periodogram argmax + Jacobsen/Quinn-style
  3-point complex-ratio interpolation; robust from low SNR and over the
  full Nyquist range, accuracy ~ 1/(10 N nfft_pad) cycles/sample.
* ``tone_phase`` / ``tone_amplitude`` — ML scalar estimates given a
  frequency.
* ``tdoa_gcc_phat`` — generalized cross-correlation with phase transform
  for time-difference-of-arrival between two sensors, with parabolic
  sub-sample refinement.  FFT-dominated, one fused jit.

The reference framework has no estimation layer (SURVEY §2 stops at the
signal chain); these extend the analysis surface the way radar/
array_proc extended models.  All estimators are block-functional jits
that batch with ``jax.vmap``.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["tone_freq_kay", "tone_freq_fft", "tone_phase",
           "tone_amplitude", "tdoa_gcc_phat"]


@jax.jit
def tone_freq_kay(x) -> jnp.ndarray:
    """Kay's estimator: frequency of a single complex tone in noise.

    x: (N,) complex.  Returns f in cycles/sample, in (-0.5, 0.5).
    Near-CRLB above ~8 dB SNR; the smoothing window w_k downweights the
    noisy ends of the phase-difference sequence.
    """
    x = jnp.asarray(x)
    n = x.shape[-1]
    d = x[1:] * jnp.conj(x[:-1])          # phase increments
    k = jnp.arange(n - 1, dtype=jnp.float32)
    # Kay's optimal parabolic weights (sum to 1).  They must weight the
    # ANGLES — that is what implements the var ~ 1/N^3 phase-slope
    # regression; a weighted vector sum degenerates to a single-step
    # increment estimate (~65x CRLB measured at 15 dB, N=1024).
    w = 1.5 * n / (n * n - 1.0) * (1.0 - ((2 * k - (n - 2)) / n) ** 2)
    # de-rotate by a coarse increment estimate first so the per-sample
    # angles sit near 0 and never wrap, even for f near +/-0.5
    coarse = jnp.angle(jnp.sum(d))
    ang = coarse + jnp.sum(w * jnp.angle(d * jnp.exp(-1j * coarse)))
    ang = (ang + jnp.pi) % (2 * jnp.pi) - jnp.pi
    return ang / (2 * jnp.pi)


@partial(jax.jit, static_argnames=("pad", "newton_iters"))
def tone_freq_fft(x, pad: int = 4, newton_iters: int = 2) -> jnp.ndarray:
    """ML single-tone frequency: padded periodogram argmax + Newton.

    x: (N,) complex.  pad: zero-padding factor for the coarse stage.
    Returns f in cycles/sample in [-0.5, 0.5).  The coarse argmax lands
    within 1/(2*pad*N) of the peak; Newton iterations on the exact
    periodogram P(f) = |sum x_n e^{-j2pi f n}|^2 then converge to the ML
    estimate (CRLB-attaining), with no window-shape bias — the 3-point
    complex-ratio corrections (Jacobsen/Quinn) assume an UNPADDED grid
    and mis-step on a padded one.
    """
    x = jnp.asarray(x)
    n = x.shape[-1]
    m = pad * n
    X = jnp.fft.fft(x, m)
    k = jnp.argmax(jnp.abs(X))
    f = k.astype(jnp.float32) / m
    idx = jnp.arange(n, dtype=jnp.float32)
    half_step = 0.5 / m

    def newton(f, _):
        e = jnp.exp(-2j * jnp.pi * f * idx).astype(x.dtype)
        s0 = jnp.sum(x * e)
        s1 = jnp.sum(idx * x * e)
        s2 = jnp.sum(idx * idx * x * e)
        c = -2 * jnp.pi
        # P' = 2 Re[S' conj(S)],  P'' = 2 Re[S'' conj(S)] + 2|S'|^2
        d1 = 2 * jnp.real(1j * c * s1 * jnp.conj(s0))
        d2 = (2 * jnp.real(-(c ** 2) * s2 * jnp.conj(s0))
              + 2 * jnp.abs(1j * c * s1) ** 2)
        step = jnp.where(d2 < 0, -d1 / d2, 0.0)
        return f + jnp.clip(step, -half_step, half_step), None

    f, _ = jax.lax.scan(newton, f, None, length=newton_iters)
    return jnp.where(f >= 0.5, f - 1.0, f)


@jax.jit
def tone_phase(x, f) -> jnp.ndarray:
    """ML phase (radians at sample 0) of a tone at known frequency f."""
    x = jnp.asarray(x)
    n = jnp.arange(x.shape[-1], dtype=jnp.float32)
    c = jnp.exp(-2j * jnp.pi * f * n)
    return jnp.angle(jnp.sum(x * c))


@jax.jit
def tone_amplitude(x, f) -> jnp.ndarray:
    """ML amplitude of a complex tone at known frequency f."""
    x = jnp.asarray(x)
    n = jnp.arange(x.shape[-1], dtype=jnp.float32)
    c = jnp.exp(-2j * jnp.pi * f * n)
    return jnp.abs(jnp.sum(x * c)) / x.shape[-1]


@partial(jax.jit, static_argnames=("max_lag",))
def tdoa_gcc_phat(x, y, max_lag: int) -> tuple:
    """GCC-PHAT time difference of arrival: delay of y relative to x.

    x, y: (N,) (real or complex).  Returns (tau, corr) — the sub-sample
    delay estimate in samples (positive = y lags x), clipped to
    [-max_lag, max_lag], and the (2*max_lag+1,) PHAT correlation around
    zero lag for inspection.  The phase transform whitens the spectrum so
    the peak sharpness is set by bandwidth, not by the source PSD.
    """
    x = jnp.asarray(x)
    y = jnp.asarray(y)
    n = x.shape[-1]
    nfft = 2 * n                           # linear (not circular) corr
    X = jnp.fft.fft(x, nfft)
    Y = jnp.fft.fft(y, nfft)
    S = Y * jnp.conj(X)
    S = S / (jnp.abs(S) + 1e-12)           # PHAT weighting
    cc = jnp.fft.ifft(S)
    # lags -max_lag..max_lag: ifft index l = delay of y (mod nfft)
    idx = jnp.arange(-max_lag, max_lag + 1) % nfft
    c = jnp.abs(cc[idx]) if jnp.iscomplexobj(x) else jnp.real(cc[idx])
    k = jnp.argmax(c)
    # parabolic sub-sample refinement on the correlation peak
    cm = c[jnp.clip(k - 1, 0, 2 * max_lag)]
    c0 = c[k]
    cp = c[jnp.clip(k + 1, 0, 2 * max_lag)]
    den = cm - 2 * c0 + cp
    delta = jnp.where(jnp.abs(den) < 1e-12, 0.0,
                      0.5 * (cm - cp) / den)
    delta = jnp.clip(delta, -0.5, 0.5)
    tau = (k - max_lag).astype(jnp.float32) + delta
    return tau, c
