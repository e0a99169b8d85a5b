"""M-ary FSK modem (continuous-phase frequency-shift keying).

New capability on the framework's existing primitives: modulation is FM of
a symbol staircase (phase-continuous by construction, carried across blocks
by the FM phase accumulator); demodulation is either

* ``fsk_demod_discriminator`` — FM discriminator + integrate&dump + slicer
  (cheap, non-coherent, rides the existing fm/fir machinery), or
* ``fsk_demod_matched`` — bank of tone correlators (the optimal
  non-coherent detector): one reshape + matmul against M complex tones —
  pure matmul work, and the natural multi-channel formulation.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from . import fm as fm_mod

__all__ = ["fsk_tones", "fsk_modulate", "fsk_demod_discriminator",
           "fsk_demod_matched"]


def fsk_tones(m_ary: int, separation: float) -> np.ndarray:
    """Symmetric tone frequencies (cycles/sample): m-ary levels spaced by
    ``separation``, centered on 0."""
    m = int(m_ary)
    return (np.arange(m) - (m - 1) / 2.0) * separation


@partial(jax.jit, static_argnames=("sps", "m_ary", "separation"))
def fsk_modulate(symbols, sps: int, m_ary: int, separation: float,
                 phase0=0.0):
    """CPFSK: symbols (ints 0..M-1) -> complex baseband at sps samp/sym.

    Returns (iq, phase_end); phase is continuous within and across blocks.
    """
    tones = jnp.asarray(fsk_tones(m_ary, separation))
    f_inst = jnp.repeat(jnp.take(tones, symbols), sps, axis=-1)
    # FM with kf = 1: instantaneous frequency = f_inst cycles/sample
    return fm_mod.fm_modulate(f_inst, 1.0, phase0)


@partial(jax.jit, static_argnames=("sps", "m_ary", "separation"))
def fsk_demod_discriminator(state, x, sps: int, m_ary: int,
                            separation: float):
    """FM discriminator -> integrate&dump per symbol -> nearest level.

    Returns (symbols, new_state); len(x) must be a multiple of sps.
    """
    freq, new_state = fm_mod.fm_demodulate(state, x, 1.0)
    T = x.shape[-1] // sps
    per_sym = freq[..., : T * sps].reshape(*freq.shape[:-1], T, sps)
    est = jnp.mean(per_sym, axis=-1)  # cycles/sample per symbol
    tones = jnp.asarray(fsk_tones(m_ary, separation), est.dtype)
    return jnp.argmin(jnp.abs(est[..., None] - tones), axis=-1), new_state


@partial(jax.jit, static_argnames=("sps", "m_ary", "separation"))
def fsk_demod_matched(x, sps: int, m_ary: int, separation: float):
    """Non-coherent tone-correlator bank: argmax_m |sum_n x e^{-j2pi f_m n}|.

    One strided multi-output correlation — conv1d_mxu with an (sps, M)
    tone bank and stride sps (the same matmul path as every other filter).
    """
    from ..ops.fir import conv1d_mxu

    T = x.shape[-1] // sps
    n = np.arange(sps)
    tones = fsk_tones(m_ary, separation)
    bank = np.exp(-2j * np.pi * np.outer(n, tones))  # (sps, M), host const
    scores = jnp.abs(conv1d_mxu(x[..., : T * sps], jnp.asarray(bank, x.dtype),
                                stride=sps))
    return jnp.argmax(scores, axis=-1)
