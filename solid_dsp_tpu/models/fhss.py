"""Frequency-hopping spread spectrum (FHSS).

The time-domain complement to DSSS (models/dsss.py) and CSS
(models/css.py): the carrier jumps over ``n_channels`` sub-bands on a
pseudo-random schedule, one hop per ``dwell`` samples.  A partial-band
jammer (or a deep frequency-selective fade) then hits only the fraction
of hops that land in it — with an outer code across hops the link
survives interference that would erase a fixed-frequency carrier
outright (demonstrated in tests/test_fhss.py with a jammer 30 dB above
the signal).

Formulation: hopping is a closed-form phase rotation — the block
reshapes to (n_dwells, dwell), each dwell multiplies by
exp(2j pi f_h (t0 + arange(dwell))) with per-dwell frequency gathered
from the (tiny) schedule — two elementwise passes, no sequential state.
Hop synthesis restarts phase each dwell (like a real frequency
synthesizer); dehopping applies the exact conjugate, so hop+dehop is
bit-transparent by construction.

Schedules come from the framework's m-sequences (utils/sequences): the
LFSR state stream taken ``bits_per_hop`` at a time, the standard
construction for near-uniform channel occupancy.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.sequences import m_sequence

__all__ = ["hop_schedule", "fhss_hop", "fhss_dehop", "FHSS"]


def hop_schedule(n_channels: int, n_hops: int, seed: int = 1) -> np.ndarray:
    """Pseudo-random channel indices (n_hops,) in [0, n_channels).

    Consecutive log2(n_channels) chips of an m-sequence (host-side);
    n_channels must be a power of two.
    """
    if n_channels < 2 or n_channels & (n_channels - 1):
        raise ValueError("n_channels must be a power of two >= 2")
    k = int(np.log2(n_channels))
    nbits = max(k + 1, 10)
    seq = np.asarray(m_sequence(nbits, seed=seed), np.int64)
    need = n_hops * k
    reps = -(-need // len(seq))
    chips = np.tile(seq, reps)[:need].reshape(n_hops, k)
    return (chips << np.arange(k - 1, -1, -1)).sum(axis=1).astype(np.int32)


def _hop_phases(schedule: np.ndarray, n_channels: int, dwell: int,
                bandwidth: float) -> np.ndarray:
    """(n_hops, dwell) f64 phase table, host-side (tiny)."""
    freqs = (np.asarray(schedule, np.float64) / n_channels - 0.5) \
        * bandwidth
    t = np.arange(dwell, dtype=np.float64)
    return 2.0 * np.pi * freqs[:, None] * t[None, :]


@partial(jax.jit, static_argnames=("dwell", "conj"))
def _apply_hops(x, schedule_ph, dwell: int, conj: bool):
    # n_channels/bandwidth are already baked into schedule_ph host-side
    n_hops = x.shape[-1] // dwell
    xb = x[..., : n_hops * dwell].reshape(*x.shape[:-1], n_hops, dwell)
    ph = schedule_ph.astype(xb.real.dtype)
    rot = jnp.exp((-1j if conj else 1j) * ph)
    return (xb * rot.astype(xb.dtype)).reshape(*x.shape[:-1],
                                               n_hops * dwell)


class FHSS:
    """Hop/dehop a baseband stream over a pseudo-random channel plan.

    n_channels: power-of-two sub-bands across ``bandwidth``
    (cycles/sample, default the full band).  dwell: samples per hop.
    The baseband signal must fit inside one sub-band
    (bandwidth / n_channels).
    """

    def __init__(self, n_channels: int = 16, dwell: int = 256,
                 bandwidth: float = 0.9, seed: int = 1):
        if dwell < 1:
            raise ValueError("dwell must be >= 1")
        if not (0.0 < bandwidth <= 1.0):
            raise ValueError("bandwidth in (0, 1] cycles/sample")
        self.n_channels = int(n_channels)
        self.dwell = int(dwell)
        self.bandwidth = float(bandwidth)
        self.seed = int(seed)
        if n_channels < 2 or n_channels & (n_channels - 1):
            raise ValueError("n_channels must be a power of two >= 2")

    def schedule(self, n_hops: int) -> np.ndarray:
        return hop_schedule(self.n_channels, n_hops, self.seed)

    def _phases(self, n_samples: int) -> np.ndarray:
        n_hops = n_samples // self.dwell
        sched = self.schedule(n_hops)
        return _hop_phases(sched, self.n_channels, self.dwell,
                           self.bandwidth)

    def hop(self, x) -> jnp.ndarray:
        """Spread: mix each dwell up to its scheduled sub-band."""
        x = jnp.asarray(x)
        if x.shape[-1] % self.dwell:
            raise ValueError("length must be a multiple of the dwell")
        ph = jnp.asarray(self._phases(x.shape[-1]))
        return _apply_hops(x, ph, self.dwell, False)

    def dehop(self, x) -> jnp.ndarray:
        """Despread with the same schedule (exact inverse of hop)."""
        x = jnp.asarray(x)
        if x.shape[-1] % self.dwell:
            raise ValueError("length must be a multiple of the dwell")
        ph = jnp.asarray(self._phases(x.shape[-1]))
        return _apply_hops(x, ph, self.dwell, True)

    def __repr__(self):
        return (f"FHSS [channels={self.n_channels}] [dwell={self.dwell}]"
                f" [bw={self.bandwidth}]")
