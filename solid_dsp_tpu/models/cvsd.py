"""CVSD: continuously variable slope delta 1-bit voice codec.

The classic military/Bluetooth-SCO voice codec (MIL-STD-188-113,
Bluetooth SCO): each sample is encoded as ONE bit — the sign of the
prediction error — while the step size adapts through a SYLLABIC
filter: a leaky first-order integrator that gets a fixed boost
``gamma`` whenever the last ``n_history`` bits agree (slope overload)
and otherwise decays by ``beta`` toward the ``delta_min`` floor.  The
reconstruction accumulator also leaks (``leak``).  Both leaks make the
decoder forget channel bit errors geometrically — a purely
multiplicative step adaptation (the naive textbook variant) never
re-synchronizes after a flip because the step RATIO persists until a
clamp is hit (measured: a single bit error left a permanent 1.34x gain
split); the syllabic form decays it to zero in ~100 samples (tested).

Completes the audio-codec member of the framework family (liquid-dsp's
``audio`` module has exactly this codec; the reference library has
none).

Rate/quality: CVSD is an OVERSAMPLED codec — run it at 2-8x the audio
Nyquist rate (16-64 kbps for telephone voice).  At 4x oversampling the
defaults measure ~27 dB in-band SNR on a two-tone voice-band signal
(tests/test_cvsd.py); at 1x it degrades to a few dB, which is inherent
to 1-bit delta modulation, not a tuning artifact.

Formulation: the recursion is inherently per-sample (the step-size
state feeds back through the comparator), so encode/decode run as
``lax.scan`` with a (reference, step, bit-history) carry — the same
honest-sequential treatment as ops/agc.py's exact path.  Both directions
batch over leading axes via the scan body being elementwise, and the
decoder is the encoder's reconstruction loop verbatim, so
decode(encode(x)) tracks the encoder's internal reference exactly
(asserted in tests).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

__all__ = ["cvsd_encode", "cvsd_decode", "CVSD"]

_BETA, _GAMMA, _DMIN, _DMAX, _LEAK = 0.9, 0.01, 0.001, 0.2, 0.98


def _step_update(step, hist_agree, beta: float, gamma: float,
                 dmin: float, dmax: float):
    """Syllabic filter: leaky integrator + overload boost, clamped."""
    s = beta * step + jnp.where(hist_agree, gamma, 0.0)
    return jnp.clip(s, dmin, dmax)


@partial(jax.jit, static_argnames=("n_history",))
def cvsd_encode(x, beta: float = _BETA, gamma: float = _GAMMA,
                delta_min: float = _DMIN, delta_max: float = _DMAX,
                n_history: int = 3, leak: float = _LEAK):
    """Encode real samples (..., N) in [-1, 1] to bits (..., N) {0, 1}.

    beta: syllabic decay per sample (< 1).  gamma: step boost on slope
    overload.  delta_min/max: step bounds.  n_history: consecutive
    equal bits that signal overload.  leak: accumulator leak.
    """
    if n_history < 1:
        raise ValueError("n_history must be >= 1")
    x = jnp.asarray(x)
    if x.dtype.kind != "f":
        x = x.astype(jnp.float32)
    B = x.shape[:-1]
    ref0 = jnp.zeros(B, x.dtype)
    step0 = jnp.full(B, delta_min, x.dtype)
    hist0 = jnp.zeros(B + (n_history,), jnp.int32)

    def body(carry, xn):
        ref, step, hist = carry
        bit = (xn >= ref).astype(jnp.int32)
        hist = jnp.concatenate([hist[..., 1:], bit[..., None]], axis=-1)
        agree = jnp.all(hist == hist[..., :1], axis=-1)
        step = _step_update(step, agree, beta, gamma, delta_min,
                            delta_max)
        ref = leak * ref + jnp.where(bit == 1, step, -step)
        ref = jnp.clip(ref, -1.0, 1.0)
        return (ref, step, hist), bit

    _, bits = jax.lax.scan(body, (ref0, step0, hist0),
                           jnp.moveaxis(x, -1, 0))
    return jnp.moveaxis(bits, 0, -1)


@partial(jax.jit, static_argnames=("n_history",))
def cvsd_decode(bits, beta: float = _BETA, gamma: float = _GAMMA,
                delta_min: float = _DMIN, delta_max: float = _DMAX,
                n_history: int = 3, leak: float = _LEAK):
    """Decode bits (..., N) {0, 1} back to samples (..., N).

    Runs the encoder's reconstruction recursion: the decoded output IS
    the encoder's internal reference trajectory.  Follow with a lowpass
    at the audio bandwidth to remove the granular staircase.
    """
    if n_history < 1:
        raise ValueError("n_history must be >= 1")
    bits = jnp.asarray(bits).astype(jnp.int32)
    B = bits.shape[:-1]
    ref0 = jnp.zeros(B, jnp.float32)
    step0 = jnp.full(B, delta_min, jnp.float32)
    hist0 = jnp.zeros(B + (n_history,), jnp.int32)

    def body(carry, bit):
        ref, step, hist = carry
        hist = jnp.concatenate([hist[..., 1:], bit[..., None]], axis=-1)
        agree = jnp.all(hist == hist[..., :1], axis=-1)
        step = _step_update(step, agree, beta, gamma, delta_min,
                            delta_max)
        ref = leak * ref + jnp.where(bit == 1, step, -step)
        ref = jnp.clip(ref, -1.0, 1.0)
        return (ref, step, hist), ref

    _, y = jax.lax.scan(body, (ref0, step0, hist0),
                        jnp.moveaxis(bits, -1, 0))
    return jnp.moveaxis(y, 0, -1)


class CVSD:
    """Stateless block codec wrapper (encode/decode whole utterances)."""

    def __init__(self, beta: float = _BETA, gamma: float = _GAMMA,
                 delta_min: float = _DMIN, delta_max: float = _DMAX,
                 n_history: int = 3, leak: float = _LEAK):
        if not (0.0 < beta < 1.0):
            raise ValueError("beta in (0, 1)")
        if gamma <= 0.0:
            raise ValueError("gamma must be > 0")
        if not (0.0 < delta_min <= delta_max):
            raise ValueError("need 0 < delta_min <= delta_max")
        if not (0.0 < leak <= 1.0):
            raise ValueError("leak in (0, 1]")
        if n_history < 1:
            raise ValueError("n_history must be >= 1")
        self.beta = float(beta)
        self.gamma = float(gamma)
        self.delta_min = float(delta_min)
        self.delta_max = float(delta_max)
        self.n_history = int(n_history)
        self.leak = float(leak)

    def encode(self, x):
        return cvsd_encode(x, self.beta, self.gamma, self.delta_min,
                           self.delta_max, self.n_history, self.leak)

    def decode(self, bits):
        return cvsd_decode(bits, self.beta, self.gamma, self.delta_min,
                           self.delta_max, self.n_history, self.leak)

    def __repr__(self):
        return (f"CVSD [beta={self.beta}] [gamma={self.gamma}] "
                f"[delta=({self.delta_min},{self.delta_max})] "
                f"[history={self.n_history}]")
