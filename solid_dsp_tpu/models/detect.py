"""Energy burst detection: sliding power, hysteresis squelch, burst edges.

Classic SDR front-end machinery the reference never had (its only
detection-adjacent piece is the AGC squelch FSM): a moving-average energy
estimate, a two-threshold hysteresis gate, and fixed-capacity burst-edge
extraction — all block-functional and jit/shard-friendly.

accelerator-first formulations:

* sliding energy is a cumsum difference (2 adds per sample, any window),
* the hysteresis gate — normally a per-sample state machine — is solved in
  O(log T) depth: classify each sample as ON (above high), OFF (below
  low), or HOLD, then take the "last non-HOLD" with an associative scan
  (``combine(a, b) = b if b != HOLD else a`` is associative),
* edge lists use ``jnp.nonzero(..., size=k)`` so shapes stay static.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "sliding_energy_db", "hysteresis_gate", "burst_edges", "BurstDetector",
]

_HOLD = -1


@partial(jax.jit, static_argnames=("window",))
def sliding_energy_db(x, tail, window: int):
    """Moving-average power in dB over ``window`` samples.

    tail: the previous block's last ``window`` samples (zeros at start) so
    block boundaries are seamless.  Returns (e_db (T,), new_tail).
    """
    x = jnp.asarray(x)
    e2 = jnp.real(x * jnp.conj(x))
    t2 = jnp.real(tail * jnp.conj(tail))
    ext = jnp.concatenate([t2, e2], axis=-1)
    c = jnp.cumsum(ext, axis=-1)
    # mean over [n - window + 1, n] in extended coords
    upper = c[..., window:]
    lower = c[..., :-window]
    mean = (upper - lower) / window
    mean = mean[..., -x.shape[-1]:]
    new_tail = jnp.concatenate([tail, x], axis=-1)[..., -window:]
    return 10.0 * jnp.log10(mean + 1e-30), new_tail


@jax.jit
def hysteresis_gate(e_db, high_db, low_db, init_on):
    """Two-threshold gate WITHOUT a sequential scan.

    gate[n] is ON once e rises above high_db and stays ON until e falls
    below low_db.  Solved as "last non-HOLD classification" via an
    associative scan along the last axis; leading axes batch (per-channel
    gates for a channelizer output come free).  e_db: (..., T),
    init_on: (...,) bools.  Returns (gate bool (..., T), final (...,)).
    """
    raw = jnp.where(e_db > high_db, 1,
                    jnp.where(e_db < low_db, 0, _HOLD)).astype(jnp.int32)
    init = jnp.where(jnp.asarray(init_on), 1, 0).astype(jnp.int32)
    seq = jnp.concatenate([init[..., None], raw], axis=-1)

    def combine(a, b):
        return jnp.where(b == _HOLD, a, b)

    st = jax.lax.associative_scan(combine, seq, axis=-1)[..., 1:]
    return st == 1, st[..., -1] == 1


@partial(jax.jit, static_argnames=("max_bursts",))
def burst_edges(gate, prev_last, max_bursts: int):
    """Rising/falling edge indices with static shapes (1-D gate only —
    batched channels keep the boolean gate matrix instead).

    Returns (rises, falls): int32 arrays of length ``max_bursts`` padded
    with -1.  ``prev_last`` is the previous block's final gate value so a
    burst spanning a block boundary doesn't double-count its rise.
    """
    gate = jnp.asarray(gate)
    prev = jnp.concatenate([jnp.asarray(prev_last)[None], gate[:-1]])
    rising = gate & ~prev
    falling = ~gate & prev
    rises = jnp.nonzero(rising, size=max_bursts, fill_value=-1)[0]
    falls = jnp.nonzero(falling, size=max_bursts, fill_value=-1)[0]
    return rises.astype(jnp.int32), falls.astype(jnp.int32)


@partial(jax.jit, static_argnames=("window", "max_bursts"))
def _detector_block(x, tail, on, window: int, high_db, low_db,
                    max_bursts: int):
    """Whole detector block as ONE dispatch, not one per op."""
    e_db, new_tail = sliding_energy_db(x, tail, window)
    gate, on_new = hysteresis_gate(e_db, high_db, low_db, on)
    rises, falls = burst_edges(gate, on, max_bursts)
    return ({"gate": gate, "e_db": e_db, "rises": rises, "falls": falls},
            new_tail, on_new)


class BurstDetector:
    """Stateful streaming burst detector.

    execute_block(x) -> dict(gate, e_db, rises, falls); state (energy tail
    + gate latch) carries across blocks like every other ChainState-style
    component.
    """

    def __init__(self, window: int = 64, high_db: float = -20.0,
                 low_db: float | None = None, max_bursts: int = 64,
                 dtype=jnp.complex64):
        if low_db is None:
            low_db = high_db - 3.0
        if low_db > high_db:
            raise ValueError("low_db must not exceed high_db")
        self.window = int(window)
        self.high_db = float(high_db)
        self.low_db = float(low_db)
        self.max_bursts = int(max_bursts)
        self._tail = jnp.zeros(self.window, dtype)
        self._on = jnp.asarray(False)

    def execute_block(self, x):
        x = jnp.asarray(x, self._tail.dtype)
        out, self._tail, self._on = _detector_block(
            x, self._tail, self._on, self.window, self.high_db,
            self.low_db, self.max_bursts)
        return out

    def reset(self):
        self._tail = jnp.zeros_like(self._tail)
        self._on = jnp.asarray(False)

    def __repr__(self):
        return (f"BurstDetector [window={self.window}] "
                f"[high={self.high_db:.1f}dB] [low={self.low_db:.1f}dB]")
