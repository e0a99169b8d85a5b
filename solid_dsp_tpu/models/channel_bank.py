"""ChannelBank — wideband receiver: channelize, then filter every channel.

The production shape of driver config 5: one wideband stream enters, the
polyphase channelizer splits it into M critically-sampled channels, and a
shared IIR biquad cascade (e.g. a channel-selectivity lowpass) runs over
all M channels at once (ops/iir.iir_bank_apply: one sequential scan over
time, channels side by side), optionally followed by per-channel block
AGC.

Everything is one jittable block transform; the state pytree carries the
channelizer tail, the per-channel biquad state, and per-channel AGC gains.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..ops import agc as agc_ops
from ..ops.iir import iir_bank_apply, iir_bank_init
from ..streaming.state import ChainState
from .channelizer import PolyphaseChannelizer
from ..utils.transfer import zeros_device, zeros_like_device

__all__ = ["ChannelBank", "design_channel_sos"]


def design_channel_sos(cutoff: float = 0.25, order: int = 4) -> np.ndarray:
    """Butterworth lowpass as biquad cascade (S, 5) [b0 b1 b2 a1 a2].

    Standard bilinear transform of the order/2 conjugate pole pairs;
    ``cutoff`` is the normalized per-channel cutoff in (0, 0.5).  Unity DC
    gain per section.
    """
    if order % 2:
        raise ValueError("order must be even (biquad pairs)")
    K = np.tan(np.pi * cutoff)  # prewarped
    sections = []
    n = order
    for k in range(n // 2):
        theta = np.pi * (2 * k + 1) / (2 * n)
        Q = 1.0 / (2.0 * np.cos(theta))
        norm = 1.0 / (1.0 + K / Q + K * K)
        b0 = K * K * norm
        sections.append([b0, 2 * b0, b0,
                         2.0 * (K * K - 1.0) * norm,
                         (1.0 - K / Q + K * K) * norm])
    return np.asarray(sections, dtype=np.float32)


class ChannelBank:
    """Channelizer + shared per-channel IIR cascade + optional AGC."""

    def __init__(self, num_channels: int, taps_per_branch: int = 8,
                 sos: np.ndarray | None = None, agc_bandwidth: float = 0.0,
                 attenuation: float = 80.0,
                 squelch_high_db: float | None = None,
                 squelch_low_db: float | None = None,
                 squelch_window: int = 32):
        # sos: (S, 5) shared across channels, or (S, 5, M) per-channel
        # cascades (both handled by ops.iir.iir_bank_apply)
        self.M = int(num_channels)
        self.channelizer = PolyphaseChannelizer(
            self.M, taps_per_branch, attenuation, dtype=jnp.complex64)
        self.sos = np.asarray(sos if sos is not None else design_channel_sos(),
                              dtype=np.float32)
        self.agc_bandwidth = float(agc_bandwidth)
        self._iir_state = iir_bank_init(self.sos.shape[0], self.M)
        self._agc_state = agc_ops.agc_init(jnp.float32, batch_shape=(self.M,))
        # optional per-channel energy squelch (models.detect): channels
        # whose filtered energy never crossed high_db emit zeros
        if squelch_low_db is not None and squelch_high_db is None:
            raise ValueError("squelch_low_db given without squelch_high_db")
        if (squelch_high_db is not None and squelch_low_db is not None
                and squelch_low_db > squelch_high_db):
            raise ValueError("squelch_low_db must not exceed squelch_high_db")
        self.squelch_high_db = squelch_high_db
        self.squelch_low_db = (squelch_low_db if squelch_low_db is not None
                               else (squelch_high_db - 3.0
                                     if squelch_high_db is not None else None))
        self.squelch_window = int(squelch_window)
        self._det_tail = zeros_device((self.M, self.squelch_window),
                                   jnp.complex64)
        self._det_on = zeros_device(self.M, bool)
        self.last_gate = None  # (M, T) bool after each block when enabled

    @property
    def state(self) -> ChainState:
        return ChainState(iir=self._iir_state, agc=self._agc_state)

    def execute_block(self, x) -> jnp.ndarray:
        """x: (L,) wideband complex64, L % M == 0 -> (T, M) channel outputs."""
        Y = self.channelizer.execute_block(x)  # (T, M)
        Y, self._iir_state = iir_bank_apply(
            jnp.asarray(self.sos), self._iir_state,
            jnp.asarray(Y, jnp.complex64))
        if self.squelch_high_db is not None:
            from . import detect

            e_db, self._det_tail = detect.sliding_energy_db(
                Y.T, self._det_tail, self.squelch_window)
            gate, self._det_on = detect.hysteresis_gate(
                e_db, self.squelch_high_db, self.squelch_low_db,
                self._det_on)
            self.last_gate = gate  # (M, T)
            Y = jnp.where(gate.T, Y, 0.0)
        if self.agc_bandwidth > 0.0:
            out, self._agc_state = agc_ops.agc_apply_block_mode(
                self._agc_state, Y.T, self.agc_bandwidth
            )
            Y = out.T
        return Y

    def reset(self) -> None:
        self.channelizer.reset()
        self._iir_state = iir_bank_init(self.sos.shape[0], self.M)
        self._agc_state = agc_ops.agc_init(jnp.float32, batch_shape=(self.M,))
        self._det_tail = zeros_like_device(self._det_tail)
        self._det_on = zeros_device(self.M, bool)
        self.last_gate = None

    def __repr__(self) -> str:
        return (f"ChannelBank [M={self.M}] [sections={self.sos.shape[0]}] "
                f"[agc_bw={self.agc_bandwidth}]")
