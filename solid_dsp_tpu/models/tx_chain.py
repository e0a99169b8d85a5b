"""TxChain — the transmit counterpart of the flagship RxChain.

    message -> modulate (FM / M-PSK / M-QAM) -> interpolate (ideal
    zero-stuff + anti-image FIR) -> NCO mix up to the carrier

Symmetric to RxChain's NCO -> decimating FIR -> AGC -> demod; together
they close the full-duplex loop (tests drive Tx straight into Rx and
recover the message).  Every stage is an existing block transform; the
state (NCO phase word, interpolator tail, modulator state) is a ChainState
pytree like everything else.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..design import firdes
from ..ops import fir as fir_ops
from ..ops import nco as nco_ops
from ..streaming.state import ChainState
from . import fm as fm_mod
from . import linear_mod

__all__ = ["TxChainConfig", "make_tx_chain", "TxChain"]


@dataclass
class TxChainConfig:
    """Static transmit-chain configuration."""

    carrier_freq: float = 0.2          # rad/sample NCO upconversion
    interpolation: int = 4
    fir_taps: int = 64                 # anti-image lowpass at the TX rate
    fir_attenuation: float = 60.0      # dB
    modulation: str = "fm"             # "fm" | "psk" | "qam" | "none"
    order: int = 4                     # constellation order for psk/qam
    sps: int = 4                       # samples/symbol for linear schemes
    fm_kf: float = 0.1
    dtype: object = jnp.complex64

    def design_taps(self) -> np.ndarray:
        # anti-image lowpass: the zero-stuffed message occupies +-0.5/P at
        # the TX rate and the first image starts right there too, so the
        # cutoff sits AT 0.5/P (transition splits both sides)
        taps = firdes.firdes_kaiser(
            self.fir_taps, 0.5 / self.interpolation,
            self.fir_attenuation, 0.0)
        # zero-stuffing loses a factor interpolation of DC gain
        return taps / np.sum(taps) * self.interpolation


def make_tx_chain(cfg: TxChainConfig):
    """Build (init, apply): apply(state, msg) -> (iq, state).

    msg: real samples (fm), or bits (psk/qam), or complex baseband
    ("none" = passthrough modulator).  Output rate: ``interpolation``
    samples per message sample for fm/none; ``interpolation * sps /
    log2(order)`` samples per BIT for psk/qam.
    """
    if cfg.modulation not in ("fm", "psk", "qam", "none"):
        raise ValueError(f"unknown modulation {cfg.modulation!r}")
    rdtype = np.zeros(0, dtype=cfg.dtype).real.dtype
    taps = np.asarray(cfg.design_taps(), dtype=cfg.dtype)
    n = len(taps)
    dtheta = nco_ops.constrain(cfg.carrier_freq)
    lut = nco_ops.make_sine_lut(rdtype)
    P = int(cfg.interpolation)
    if cfg.modulation in ("psk", "qam"):
        points = np.asarray(
            linear_mod.constellation(cfg.modulation, cfg.order),
            dtype=np.complex128)
        k_bits = int(np.log2(cfg.order))
        rrc = firdes.firdes_rrcos(cfg.sps, 6, 0.35)

    def init() -> ChainState:
        # built on the host, then transferred
        from ..utils.transfer import put_tree

        return put_tree(ChainState(
            nco_theta=np.uint32(0),
            fir_tail=np.zeros(n - 1, np.dtype(cfg.dtype)),
            fm_phase=np.zeros((), np.dtype(rdtype)),
            rrc_tail=np.zeros(
                (len(rrc) - 1,) if cfg.modulation in ("psk", "qam") else (0,),
                np.dtype(cfg.dtype)),
        ))

    @jax.jit
    def apply(state: ChainState, msg):
        # 1. modulate to complex baseband
        if cfg.modulation == "fm":
            bb, fm_phase = fm_mod.fm_modulate(
                jnp.asarray(msg, rdtype), cfg.fm_kf, state.fm_phase)
            rrc_tail = state.rrc_tail
        elif cfg.modulation in ("psk", "qam"):
            syms = linear_mod.bits_to_symbols(msg, k_bits)
            iq_sym = linear_mod.modulate_symbols(
                syms, points).astype(cfg.dtype)
            up = jnp.zeros(iq_sym.shape[-1] * cfg.sps,
                           cfg.dtype).at[::cfg.sps].set(iq_sym)
            ext = jnp.concatenate([state.rrc_tail, up])
            bb = fir_ops.conv1d_mxu(ext, jnp.asarray(rrc, cfg.dtype))
            rrc_tail = ext[-(len(rrc) - 1):]
            fm_phase = state.fm_phase
        else:
            bb = jnp.asarray(msg, cfg.dtype)
            fm_phase = state.fm_phase
            rrc_tail = state.rrc_tail

        # 2. ideal zero-stuff interpolation + anti-image FIR
        up = jnp.zeros(bb.shape[-1] * P, cfg.dtype).at[::P].set(bb)
        ext = jnp.concatenate([state.fir_tail, up])
        tx = fir_ops.conv1d_mxu(ext, taps)
        fir_tail = ext[-(n - 1):]

        # 3. mix up to the carrier (closed-form phases)
        iq, theta_end = nco_ops.mix_up_block(
            tx, state.nco_theta, dtheta, lut, "exact")
        new_state = ChainState(
            nco_theta=theta_end, fir_tail=fir_tail,
            fm_phase=fm_phase, rrc_tail=rrc_tail)
        return iq, new_state

    return init, apply


class TxChain:
    """Stateful transmit chain wrapper."""

    def __init__(self, cfg: TxChainConfig | None = None, **overrides):
        self.cfg = cfg or TxChainConfig(**overrides)
        self._init, self._apply = make_tx_chain(self.cfg)
        self.state = self._init()

    def execute_block(self, msg):
        iq, self.state = self._apply(self.state, msg)
        return iq

    def reset(self):
        self.state = self._init()

    def __repr__(self):
        return (f"TxChain [fc={self.cfg.carrier_freq}] "
                f"[P={self.cfg.interpolation}] "
                f"[mod={self.cfg.modulation}]")
