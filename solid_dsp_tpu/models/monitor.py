"""SpectrumMonitor — wideband occupancy tracking over a channel grid.

The spectrum-sensing product layer: channelize each block (the same
polyphase bank the rx side uses), track per-channel power with an EMA,
estimate the noise floor robustly (median across channels), and run a
per-channel hysteresis occupancy decision.  Emits EVENTS — (channel,
start_block, end_block, peak_db) — plus a running duty-cycle summary,
i.e. what a monitoring service stores, not raw spectra.

Formulation: the per-block work is ONE channelizer pass + reductions
(an (T, M) power map collapsed to per-channel means) inside a single
jit; the event bookkeeping on the tiny (M,) occupancy vector is host
code.  Thresholds are RELATIVE to the tracked noise floor, so the
monitor needs no absolute calibration.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from .channelizer import channelizer_apply, channelizer_init, \
    channelizer_taps

__all__ = ["SpectrumMonitor"]


class SpectrumMonitor:
    """Streaming occupancy monitor over ``num_channels`` sub-bands.

    high_db / low_db: hysteresis thresholds relative to the tracked
    noise floor.  alpha: per-block EMA coefficient for channel powers —
    event release lags a burst's end by the EMA memory
    (~peak_db / (10 log10(1/(1-alpha))) blocks), so keep alpha high
    (default 0.9) unless heavy smoothing is wanted.
    Feed blocks with ``execute_block``; completed events accumulate in
    ``.events`` (in-progress channels appear in ``.active``).
    """

    def __init__(self, num_channels: int = 64, taps_per_branch: int = 8,
                 high_db: float = 10.0, low_db: float = 6.0,
                 alpha: float = 0.9, dtype=jnp.complex64):
        if not (low_db < high_db):
            raise ValueError("need low_db < high_db (hysteresis)")
        if not (0.0 < alpha <= 1.0):
            raise ValueError("alpha in (0, 1]")
        self.M = int(num_channels)
        self.high_db = float(high_db)
        self.low_db = float(low_db)
        self.alpha = float(alpha)
        self.dtype = dtype
        taps = np.asarray(channelizer_taps(self.M, taps_per_branch),
                          np.complex64)
        self._taps = taps
        self._state = channelizer_init(self.M, taps_per_branch, dtype)
        self._p_ema = None          # (M,) linear power EMA
        self._on = np.zeros(self.M, bool)
        self._start = np.zeros(self.M, np.int64)
        self._peak = np.full(self.M, -np.inf)
        self._block = 0
        self._on_blocks = np.zeros(self.M, np.int64)
        self.events: list[dict] = []

        @jax.jit
        def _powers(state, x):
            Y, st2 = channelizer_apply(self._taps, state, x, self.M)
            p = jnp.mean(jnp.real(Y * jnp.conj(Y)), axis=-2)   # (M,)
            return p, st2

        self._powers = _powers

    def execute_block(self, x) -> np.ndarray:
        """Process one block (length divisible by num_channels).

        Returns the per-channel power EMA in dB relative to the current
        noise floor (the quantity the thresholds act on).
        """
        x = jnp.asarray(x, self.dtype)
        if x.shape[-1] % self.M:
            raise ValueError(
                f"block length must be a multiple of {self.M}")
        p, self._state = self._powers(self._state, x)
        p = np.asarray(p, np.float64)
        if self._p_ema is None:
            self._p_ema = p
        else:
            self._p_ema = ((1.0 - self.alpha) * self._p_ema
                           + self.alpha * p)
        floor = float(np.median(self._p_ema)) + 1e-30
        rel_db = 10.0 * np.log10(self._p_ema / floor + 1e-30)

        rising = (~self._on) & (rel_db > self.high_db)
        falling = self._on & (rel_db < self.low_db)
        self._start[rising] = self._block
        self._peak[rising] = rel_db[rising]
        hold = self._on & ~falling
        self._peak[hold] = np.maximum(self._peak[hold], rel_db[hold])
        for ch in np.nonzero(falling)[0]:
            self.events.append({
                "channel": int(ch),
                "start_block": int(self._start[ch]),
                "end_block": int(self._block),
                "peak_rel_db": round(float(self._peak[ch]), 2),
            })
        self._on = (self._on | rising) & ~falling
        self._on_blocks += self._on
        self._block += 1
        return rel_db

    @property
    def active(self) -> list:
        """Channels currently above threshold (in-progress events)."""
        return [int(c) for c in np.nonzero(self._on)[0]]

    def summary(self) -> dict:
        """Running occupancy report: duty cycle per busy channel."""
        total = max(self._block, 1)
        duty = {int(c): round(float(self._on_blocks[c]) / total, 4)
                for c in np.nonzero(self._on_blocks)[0]}
        return {"blocks": self._block, "events": len(self.events),
                "active": self.active, "duty_cycle": duty}

    def __repr__(self):
        return (f"SpectrumMonitor [M={self.M}] "
                f"[thresh={self.high_db}/{self.low_db} dB] "
                f"[{len(self.events)} events]")
