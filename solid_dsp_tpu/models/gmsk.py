"""MSK / GMSK modem (minimum-shift keying, Gaussian-filtered MSK).

New model family on the framework's existing primitives (the reference's
modulation module is an empty stub, src/modulation/mod.rs:1 — demodulation
capability is driver-required, cf. SURVEY.md §2 #33):

* MSK is CPFSK with modulation index h = 1/2: each bit advances the
  carrier phase by exactly +-pi/2 over one symbol.  Modulation reuses the
  FM phase accumulator (models/fm.py), so phase continuity across blocks
  is carried for free.
* GMSK shapes the frequency pulse with a Gaussian lowpass of
  bandwidth-time product BT (0.3 for GSM, 0.5 for DECT) before the same
  phase integration.  The shaping convolution is the standard conv
  path (ops/fir.py::conv1d_mxu) with an explicit tail carry.

Two receivers, spanning the classic quality/complexity trade:

* ``gmsk_demod_discriminator`` — noncoherent limiter-discriminator:
  receive lowpass -> FM phase-difference discriminator -> integrate&dump.
  Streaming `(state, x) -> (bits, state)`, cheap, tolerates frequency
  offset; needs ~16 dB Eb/N0 for BER ~1e-2 (detector-class limit).
* ``gmsk_demod_matched`` — coherent Laurent receiver: matched filter
  with the principal Laurent pulse C0 (extracted at design time by a
  least-squares fit of the exact modulated waveform onto the
  pseudo-symbol model s[n] ~ sum_k j^{A_k} c0[n - k*sps]), symbol-rate
  sampling, per-symbol decisions on the alternating quadrature axis
  (adjacent-symbol ISI of C0 lands on the orthogonal axis), then the
  A_k -> a_k sign-product map.  Burst-oriented; BER ~1e-3 at 8 dB Eb/N0.

All filtering rides conv1d_mxu (one contraction); design-time pulse
extraction is host-side numpy, embedded in jit as constants.
"""

from __future__ import annotations

import math
from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np

from . import fm as fm_mod
from ..design.firdes import firdes_kaiser
from ..ops.fir import conv1d_mxu

__all__ = [
    "gaussian_pulse_taps",
    "laurent_pulse",
    "msk_modulate",
    "msk_demod_coherent",
    "gmsk_mod_init",
    "gmsk_modulate",
    "gmsk_demod_init",
    "gmsk_demod_discriminator",
    "gmsk_demod_delay_symbols",
    "gmsk_demod_matched",
]


def gaussian_pulse_taps(bt: float, sps: int, span_symbols: int = 4) -> np.ndarray:
    """Gaussian frequency-pulse taps (host-side numpy constant).

    The continuous GMSK frequency pulse is the convolution of a
    one-symbol rectangle with a Gaussian of 3-dB bandwidth-time product
    ``bt`` (closed form via erf).  Discretized at ``sps`` samples/symbol
    over ``2*span_symbols`` symbols and normalized to unit sum, so
    integrating the pulse advances the phase by exactly the per-symbol
    phase step (pi/2 scaled in by the modulator).
    """
    if bt <= 0 or sps < 1 or span_symbols < 1:
        raise ValueError("bt > 0, sps >= 1, span_symbols >= 1 required")
    n = int(2 * span_symbols * sps) + 1
    t = (np.arange(n) - (n - 1) / 2.0) / sps  # symbol units
    alpha = 2.0 * np.pi * bt / np.sqrt(np.log(2.0))
    erf = np.vectorize(math.erf)
    g = 0.5 * (erf(alpha * (t + 0.5) / math.sqrt(2.0))
               - erf(alpha * (t - 0.5) / math.sqrt(2.0)))
    g = np.maximum(g, 0.0)
    return (g / g.sum()).astype(np.float64)


# ------------------------------------------------------------ modulation

def msk_modulate(bits, sps: int, phase0=0.0):
    """MSK: bits {0,1} -> complex baseband, h = 1/2 CPFSK.

    Each bit holds instantaneous frequency +-1/(4 sps) cycles/sample for
    sps samples, i.e. +-pi/2 phase per symbol.  Returns (iq, phase_end).
    """
    nrz = 2.0 * jnp.asarray(bits, jnp.float32) - 1.0
    f_inst = jnp.repeat(nrz, sps, axis=-1) / (4.0 * sps)
    return fm_mod.fm_modulate(f_inst, 1.0, phase0)


def gmsk_mod_init(bt: float = 0.3, sps: int = 8, span_symbols: int = 4,
                  dtype=jnp.float32):
    """Modulator carry: (shaping-filter tail, accumulated phase)."""
    ntaps = 2 * span_symbols * sps + 1
    return (jnp.zeros((ntaps - 1,), dtype), jnp.zeros((), dtype))


@partial(jax.jit, static_argnames=("sps", "bt", "span_symbols"))
def gmsk_modulate(state, bits, sps: int, bt: float = 0.3,
                  span_symbols: int = 4):
    """GMSK: bits -> complex baseband via Gaussian-shaped frequency pulse.

    state = (tail, phase0) from ``gmsk_mod_init``.  Returns
    (iq, new_state).  Output length = len(bits) * sps; the shaping delay
    of span_symbols symbols is absorbed by the tail carry, as in every
    other streaming filter here.
    """
    tail, phase0 = state
    taps = gaussian_pulse_taps(bt, sps, span_symbols)  # host constant
    nrz = 2.0 * jnp.asarray(bits, tail.dtype) - 1.0
    f_nrz = jnp.repeat(nrz, sps, axis=-1) / (4.0 * sps)
    ext = jnp.concatenate([tail, f_nrz], axis=-1)
    f_shaped = conv1d_mxu(ext, jnp.asarray(taps, tail.dtype))
    iq, phase_end = fm_mod.fm_modulate(f_shaped, 1.0, phase0)
    new_tail = ext[..., -(taps.shape[0] - 1):]
    return iq, (new_tail, phase_end.astype(tail.dtype))


def msk_demod_coherent(x, sps: int, phase0=0.0):
    """Coherent MSK demodulation by phase-trajectory decoding.

    The phase at symbol boundary k is phase0 + (pi/2) * sum_{i<=k} a_i,
    so the bit is the sign of the per-symbol phase INCREMENT.  Works on
    clean/high-SNR signals (e.g. loopback tests); use the GMSK receivers
    for noisy channels.
    """
    T = x.shape[-1] // sps
    ph = jnp.unwrap(jnp.angle(x[..., : T * sps]))
    bound = ph[..., sps - 1:: sps]
    inc = jnp.diff(bound, axis=-1)
    first = bound[..., :1] - phase0
    inc = jnp.concatenate([first, inc], axis=-1)
    return (inc > 0).astype(jnp.int32)


# ---------------------------------------- noncoherent discriminator rx

def _rx_lowpass_taps(sps: int) -> np.ndarray:
    """Pre-discriminator receive lowpass: Kaiser, cutoff 0.75/sps
    (~(1+BT)/2T passband), unit DC gain."""
    h = np.asarray(firdes_kaiser(4 * sps + 1, 0.75 / sps, 60.0, 0.0))
    return h / h.sum()


def gmsk_demod_delay_symbols(sps: int, span_symbols: int = 4) -> int:
    """End-to-end mod+discriminator-demod latency in symbols: shaping
    delay (span_symbols) + receive-lowpass group delay (2 symbols)."""
    del sps
    return span_symbols + 2


def gmsk_demod_init(bt: float = 0.3, sps: int = 8, span_symbols: int = 4,
                    dtype=jnp.complex64):
    """Discriminator-demod carry: (rx-filter tail, FM discriminator state)."""
    del bt, span_symbols
    ntaps = 4 * sps + 1
    return (jnp.zeros((ntaps - 1,), dtype), fm_mod.fm_demod_init(dtype))


@partial(jax.jit, static_argnames=("sps", "bt", "span_symbols"))
def gmsk_demod_discriminator(state, x, sps: int, bt: float = 0.3,
                             span_symbols: int = 4):
    """Limiter-discriminator GMSK receiver (noncoherent, streaming).

    Receive lowpass -> FM discriminator -> integrate&dump over each
    symbol -> sign.  len(x) must be a multiple of sps.  Returns
    (bits, new_state); output bit k corresponds to transmitted bit
    k - gmsk_demod_delay_symbols(...).
    """
    del bt  # rx filter is pulse-bandwidth based, not matched
    rx_tail, fm_state = state
    taps = _rx_lowpass_taps(sps)
    ext = jnp.concatenate([rx_tail, x], axis=-1)
    xf = conv1d_mxu(ext, jnp.asarray(taps, x.dtype))
    freq, new_fm = fm_mod.fm_demodulate(fm_state, xf, 1.0)
    T = x.shape[-1] // sps
    per_sym = freq[..., : T * sps].reshape(*freq.shape[:-1], T, sps)
    bits = (jnp.mean(per_sym, axis=-1) > 0).astype(jnp.int32)
    new_tail = ext[..., -(taps.shape[0] - 1):]
    return bits, (new_tail, new_fm)


# ------------------------------------------------ coherent Laurent rx

@lru_cache(maxsize=8)
def laurent_pulse(bt: float, sps: int, span_symbols: int = 4,
                  pulse_symbols: int = 10) -> np.ndarray:
    """Principal Laurent pulse C0, extracted by least squares (host-side).

    Modulates a fixed random training sequence and solves
    ``s[n] ~ sum_k j^{A_k} p[n - k*sps]`` for p (pulse_symbols*sps taps,
    covering the shaping delay).  The returned pulse is normalized so the
    matched-filter symbol statistic has unit signal gain
    (``p / ||p||^2``); the LS residual (~2% power for BT=0.3) is the
    energy in the higher-order Laurent terms.
    """
    rng = np.random.default_rng(0x6A5C)
    ntr = 256
    tb = rng.integers(0, 2, ntr)
    # modulate the training burst in pure numpy (design time: no device
    # round-trip)
    taps = gaussian_pulse_taps(bt, sps, span_symbols)
    f_nrz = np.repeat(2.0 * tb - 1.0, sps) / (4.0 * sps)
    ext = np.concatenate([np.zeros(len(taps) - 1), f_nrz])
    f_shaped = np.convolve(ext, taps, mode="valid")
    s = np.exp(2j * np.pi * np.cumsum(f_shaped))
    beta = np.exp(1j * np.pi / 2 * np.cumsum(2 * tb - 1))
    P = pulse_symbols * sps
    N = len(s)
    M = np.zeros((N, P), complex)
    eye = np.eye(P)
    for k in range(ntr):
        n0 = k * sps
        hi = min(P, N - n0)
        if hi > 0:
            M[n0:n0 + hi, :hi] += beta[k] * eye[:hi, :hi]
    p, *_ = np.linalg.lstsq(M, s, rcond=None)
    return p / (np.linalg.norm(p) ** 2)


@partial(jax.jit, static_argnames=("sps", "bt", "span_symbols"))
def gmsk_demod_matched(x, sps: int, bt: float = 0.3, span_symbols: int = 4):
    """Coherent Laurent-approximation GMSK receiver (burst-oriented).

    Matched-filters with C0 (one strided correlation), samples at the
    symbol rate, de-rotates by j^-k, decides s_k = sign(Im z_k) on the
    alternating quadrature axis (C0's +-1-symbol ISI is orthogonal
    there), and maps back: a_0 = s_0, a_k = s_k * s_{k-1}.

    Assumes the burst was modulated from gmsk_mod_init state (zero phase,
    zero tail).  Returns one bit per symbol, aligned to the transmitted
    bits (no extra delay — the shaping latency is inside C0).  The burst's
    final span_symbols bits are only fully decodable if the transmitter
    flushed its shaping filter (pad span_symbols trailing bits).
    """
    p = laurent_pulse(bt, sps, span_symbols)  # host constant
    P = p.shape[0]
    T = x.shape[-1] // sps
    ext = jnp.concatenate(
        [x, jnp.zeros((*x.shape[:-1], P - sps), x.dtype)], axis=-1)
    y = conv1d_mxu(ext, jnp.asarray(np.conj(p), x.dtype))[..., ::sps][..., :T]
    k = jnp.arange(T)
    z = y * jnp.exp(-0.5j * jnp.pi * k).astype(x.dtype)
    s = jnp.where(jnp.imag(z) > 0, 1, -1)
    # a_0 = s_0, a_k = s_k s_{k-1}; a concatenate, not a scatter
    a = jnp.concatenate([s[..., :1], s[..., 1:] * s[..., :-1]], axis=-1)
    return ((a + 1) // 2).astype(jnp.int32)
