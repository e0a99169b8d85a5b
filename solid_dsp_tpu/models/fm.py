"""FM modulation / demodulation + broadcast-stereo MPX decoding.

New capability (the reference's modulation layer is an empty stub —
src/modulation/am/mod.rs is 0 bytes); semantics follow the classic analog
conventions: baseband complex FM with modulation index kf (radians per
sample per unit message amplitude).

Both directions are pure block ops:
* modulate: phase integration is a cumulative sum (parallel prefix — O(log n)
  depth), carried across blocks by a phase scalar;
* demodulate: y[n] = angle(x[n] conj(x[n-1])) / (2 pi kf), carried by one
  previous sample.  No sequential scan anywhere.

The broadcast layer decodes the stereo multiplex that rides the FM
discriminator output (the classic WFM application): 19 kHz pilot
extraction by complex mix + centered lowpass (zero extra phase for the
symmetric FIR), 38 kHz subcarrier regeneration by squaring the unit pilot
phasor (no PLL needed — fully block-parallel), synchronous L-R detection,
matrixing, and one-pole de-emphasis.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["fm_modulate", "fm_demodulate", "fm_demod_init",
           "fm_stereo_mpx", "fm_stereo_decode",
           "deemphasis_init", "deemphasis_apply"]


@partial(jax.jit, static_argnames=())
def fm_modulate(msg: jnp.ndarray, kf: float, phase0=0.0):
    """Complex-baseband FM: out[n] = exp(j (phase0 + 2 pi kf cumsum(msg))).

    Returns (iq, phase_end) for block streaming.
    """
    dphase = 2.0 * jnp.pi * kf * msg
    phase = phase0 + jnp.cumsum(dphase, axis=-1)
    iq = jnp.exp(1j * phase)
    return iq, phase[..., -1] % (2.0 * jnp.pi)


def fm_demod_init(dtype=jnp.complex64, batch_shape: tuple = ()):
    """Carry: the previous sample (1 + 0j so the first output is 0);
    host-built, then transferred."""
    from ..utils.transfer import full_device

    return full_device(batch_shape, 1.0, dtype)


@partial(jax.jit, static_argnames=())
def fm_demodulate(state, x: jnp.ndarray, kf: float):
    """Phase-difference discriminator.

    y[n] = arg(x[n] conj(x[n-1])) / (2 pi kf); returns (y, new_state).
    """
    prev = jnp.concatenate([state[..., None], x[..., :-1]], axis=-1)
    d = x * jnp.conj(prev)
    y = jnp.angle(d) / (2.0 * jnp.pi * kf)
    return y, x[..., -1]


# ------------------------------------------------------ broadcast stereo

_PILOT_HZ = 19_000.0


def fm_stereo_mpx(left, right, fs: float, pilot_level: float = 0.1):
    """Compose the broadcast stereo multiplex (the transmit-side dual).

    mpx = 0.45(L+R) + pilot sin(2 pi 19k t) + 0.45(L-R) sin(2 pi 38k t);
    audio must already be band-limited to 15 kHz.
    """
    from .channel import host_wrapped_phase

    left = jnp.asarray(left)
    right = jnp.asarray(right)
    # exact host-side mod-1 phases: a float32 (or silently-downgraded
    # float64) 2*pi*f*n jitters once n > 2^24 on long blocks
    th = jnp.asarray(host_wrapped_phase(left.shape[-1], _PILOT_HZ / fs))
    th2 = jnp.asarray(host_wrapped_phase(left.shape[-1],
                                         2.0 * _PILOT_HZ / fs))
    mpx = (0.45 * (left + right)
           + pilot_level * jnp.sin(th).astype(left.dtype)
           + 0.45 * (left - right) * jnp.sin(th2).astype(left.dtype))
    return mpx


def _filt_same(x, h):
    """Centered same-length FIR (symmetric taps -> zero phase)."""
    from ..ops.fir import conv1d_mxu

    h = jnp.asarray(h, x.dtype)
    c = (h.shape[-1] - 1) // 2
    z = jnp.zeros(x.shape[:-1] + (c,), x.dtype)
    return conv1d_mxu(jnp.concatenate([z, x, z], axis=-1), h)


def fm_stereo_decode(mpx, fs: float, deemphasis_tau: float = 0.0):
    """Stereo MPX -> (left, right, pilot_amplitude).

    Whole-block decoder (edges carry filter transients): the pilot is
    isolated by a complex 19 kHz mix + narrow centered lowpass, the 38 kHz
    subcarrier is the squared unit pilot phasor re-shifted (sin(2 theta) —
    exact doubling, no PLL), L-R comes out of a synchronous product
    detector, and both audio rails go through the SAME centered 15 kHz
    lowpass so they stay sample-aligned for matrixing.  ``deemphasis_tau``
    (seconds, e.g. 75e-6) optionally applies the receiver de-emphasis.
    """
    from ..design.firdes import firdes_kaiser

    from .channel import host_wrapped_phase

    mpx = jnp.asarray(mpx)
    rdt = mpx.dtype
    th = jnp.asarray(host_wrapped_phase(mpx.shape[-1], _PILOT_HZ / fs))
    rot = jnp.exp(-1j * th)

    # pilot isolation: +-1 kHz around 19 kHz
    h_pilot = np.asarray(firdes_kaiser(401, 1_000.0 / fs, 60.0, 0.0))
    h_pilot = h_pilot / np.sum(h_pilot)
    p_bb = _filt_same(mpx.astype(jnp.complex128 if rdt == jnp.float64
                                 else jnp.complex64) * rot, h_pilot)
    amp = jnp.abs(p_bb)
    pilot_amp = 2.0 * jnp.mean(amp)          # sin amplitude = 2|analytic|
    u = p_bb / (amp + 1e-30)
    # pilot sin(theta) has analytic phasor e^{j(theta - pi/2)}; squaring
    # gives e^{j(2 theta - pi)} whose Im is -sin(2 theta) -> negate
    carrier38 = -jnp.imag((u * jnp.conj(rot)) ** 2).astype(rdt)

    h_audio = np.asarray(firdes_kaiser(201, 15_000.0 / fs, 60.0, 0.0))
    h_audio = h_audio / np.sum(h_audio)
    mono = _filt_same(mpx, h_audio)                       # 0.45 (L+R)
    diff = _filt_same(2.0 * mpx * carrier38, h_audio)     # 0.45 (L-R)
    left = (mono + diff) / 0.9
    right = (mono - diff) / 0.9
    if deemphasis_tau > 0.0:
        left, _ = deemphasis_apply(
            deemphasis_init(rdt), left, deemphasis_tau * fs)
        right, _ = deemphasis_apply(
            deemphasis_init(rdt), right, deemphasis_tau * fs)
    return left, right, pilot_amp


def deemphasis_init(dtype=jnp.float32, batch_shape: tuple = ()):
    """Carry for the one-pole de-emphasis IIR (w-state)."""
    from ..ops.iir import iir_init

    return iir_init(1, dtype=dtype, batch_shape=batch_shape)


def deemphasis_apply(state, x, tau_samples: float):
    """One-pole de-emphasis y[n] = a x[n] + (1-a) y[n-1], a = 1-e^{-1/tau}.

    The discrete match of the broadcast RC network (tau = 75 us in the
    Americas, 50 us elsewhere, times fs); unity DC gain.  Runs through the
    framework IIR engine (parallel method).  Returns (y, new_state).
    """
    from ..ops.iir import iir_apply

    a = 1.0 - np.exp(-1.0 / float(tau_samples))
    x = jnp.asarray(x)
    b = jnp.asarray([a], x.dtype)
    a_tail = jnp.asarray([-(1.0 - a)], x.dtype)
    return iir_apply(b, a_tail, state, x)
