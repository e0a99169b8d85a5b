"""``shard_map``-ed DSP chains over a ``('channel', 'time')`` mesh.

Sharding layout (SURVEY.md §2 parallelism table):

* ``channel`` — independent streams (DP analog); for the channelizer it is a
  genuine TP axis: the prototype-filter tap dimension is split across it
  (partial products combined with ``psum``) and the output-channel DFT is
  split across it (each shard extracts its subset of channels).
* ``time``    — overlap-save time blocks (SP/CP analog); neighbor devices
  exchange ``ntaps - 1``-sample halos with ``lax.ppermute`` instead of
  carrying a sequential tail, so a 1M-sample stream filters in
  ``L / n_time`` time per device plus one neighbor hop.

Sequential recurrences (AGC gain, FM discriminator memory) follow the survey's
prescription: AGC runs in block mode with a globally ``pmean``-ed energy (one
gain per block, identical on every shard — the block-mode semantics are
preserved exactly); the FM discriminator needs only a 1-sample halo.  The NCO
phase is closed-form (theta0 + k * dtheta in u32), so time sharding needs no
sequential dependency at all: each shard starts at
``theta0 + shard_offset * dtheta``.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..models import fm as fm_mod
from ..models import qpsk as qpsk_mod
from ..models.channelizer import channelizer_taps
from ..models.rx_chain import RxChainConfig
from ..ops import agc as agc_ops
from ..ops import ddc as ddc_ops
from ..ops import fir as fir_ops
from ..ops import nco as nco_ops

from ..streaming.state import ChainState
from .halo import from_last_shard, left_halo, time_offset

__all__ = ["sharded_fir", "make_sharded_rx_chain", "make_sharded_channelizer"]


# ---------------------------------------------------------------------------
# time-sharded FIR
# ---------------------------------------------------------------------------

def sharded_fir(taps, mesh: Mesh, scale=1.0):
    """Build a jitted sharded FIR ``apply(tail, x) -> (y, new_tail)``.

    ``x``: (C, L) — channels over the ``channel`` axis, time over ``time``.
    ``tail``: (C, ntaps-1) carried across calls (global stream history).
    Inside each block the halo comes from the left neighbor; only
    the leftmost time shard consumes the carried tail.
    """
    taps = np.asarray(taps)
    n = int(taps.shape[-1])

    def local_fn(tail, x):
        t_idx = jax.lax.axis_index("time")
        halo = left_halo(x[..., -(n - 1):], "time") if n > 1 else x[..., :0]
        eff_tail = jnp.where(t_idx == 0, tail, halo) if n > 1 else tail
        x_ext = jnp.concatenate([eff_tail, x], axis=-1)
        y = fir_ops.conv1d_mxu(x_ext, taps) * scale
        new_tail = (from_last_shard(x[..., -(n - 1):], "time")
                    if n > 1 else x[..., :0])
        return y, new_tail

    mapped = jax.shard_map(
        local_fn,
        mesh=mesh,
        in_specs=(P("channel"), P("channel", "time")),
        out_specs=(P("channel", "time"), P("channel")),
    )
    return jax.jit(mapped)


# ---------------------------------------------------------------------------
# sharded rx chain (driver config 4 at scale)
# ---------------------------------------------------------------------------

def make_sharded_rx_chain(cfg: RxChainConfig, mesh: Mesh):
    """Multi-chip RxChain: NCO -> decimating FIR -> AGC -> demod.

    Returns ``(init, apply)``:

    * ``init(num_channels) -> ChainState`` with per-channel leaves
      (``init(None)`` / ``init()`` for the single-stream planar mode),
    * ``apply(state, x) -> (out, state)`` jitted over the mesh; ``x`` has
      shape (C, L) sharded ``P('channel', 'time')`` and ``out`` has shape
      (C, L // decimation) with the same sharding.  With
      ``cfg.input_format == "planar"`` (single stream), ``x`` is (2, L)
      re/im planes sharded ``P(None, 'time')`` and ``out`` is (L // M,).

    ONE engine, two deployments: when the fused DDC applies (same rule as
    models/rx_chain.py — nco_mode "exact"), the per-shard front end IS the
    single-chip engine (ops/ddc.py pieces path); the only sharded
    additions are the raw-input left halo
    (replacing the carried tail on shards > 0), one ppermute of the
    1-sample discriminator seam, and the pmean of the AGC block energy.
    The LUT-NCO parity mode keeps the unfused mix->fir staging, exactly
    like the single-chip chain does.

    AGC always runs in block mode with the block energy ``pmean``-ed over
    the ``time`` axis — identical to single-chip *block-mode* AGC on the
    full block.
    """
    if cfg.demod not in ("fm", "qpsk", "am", "none"):
        raise ValueError(f"unknown demod {cfg.demod!r}")
    if cfg.fused_ddc == "on" and cfg.nco_mode != "exact":
        raise ValueError("fused_ddc requires nco_mode='exact'")
    fused = (cfg.fused_ddc == "on"
             or (cfg.fused_ddc == "auto" and cfg.nco_mode == "exact"))
    planar = cfg.input_format == "planar"
    if planar and not fused:
        raise ValueError("planar sharded input requires the fused DDC path")
    if planar and mesh.shape.get("channel", 1) != 1:
        raise ValueError("planar mode is single-stream: channel axis must "
                         "have size 1")
    # host-side closure constants (see models/rx_chain.py note)
    taps_design = cfg.design_taps()          # real f64 prototype (host)
    taps = np.asarray(taps_design, dtype=cfg.dtype)
    n = int(taps.shape[-1])
    n1 = n - 1
    M = int(cfg.decimation)
    dtheta = nco_ops.constrain(cfg.carrier_freq)
    rdtype = np.zeros(0, dtype=cfg.dtype).real.dtype
    lut = nco_ops.make_sine_lut(rdtype)
    n_time = mesh.shape["time"]

    def init(num_channels: int | None = None) -> ChainState:
        bs = () if (planar or num_channels is None) else (num_channels,)
        return ChainState(
            nco_theta=jnp.uint32(0),
            fir_tail=fir_ops.fir_init(n, dtype=cfg.dtype, batch_shape=bs),
            fir_phase=jnp.int32(0),
            agc=agc_ops.agc_init(rdtype, batch_shape=bs),
            fm_prev=fm_mod.fm_demod_init(cfg.dtype, batch_shape=bs),
        )

    # ---------------- fused per-stream front end ---------------------------
    def _front(tail2_c, theta0_l, x2_c):
        """One stream's DDC body pieces; prev seam deferred to the caller."""
        return ddc_ops.ddc_apply_planar_pieces(
            taps_design, dtheta, tail2_c, theta0_l, x2_c, M,
            precision=cfg.fir_precision)

    def _planes(xc):
        return jnp.stack([jnp.real(xc), jnp.imag(xc)]).astype(rdtype)

    def local_fused_planar(state: ChainState, x):
        """One wideband stream as (2, L) planes, time-sharded."""
        L_local = x.shape[-1]
        if L_local % M:
            raise ValueError(
                "per-shard block length must be a multiple of the decimation"
            )
        T_loc = L_local // M
        t_idx = jax.lax.axis_index("time")
        offset = time_offset("time", L_local)
        theta0_l = (state.nco_theta + offset * dtheta).astype(jnp.uint32)
        theta_end = (state.nco_theta
                     + jnp.uint32(n_time * L_local) * dtheta
                     ).astype(jnp.uint32)
        halo2 = left_halo(x[:, -n1:], "time").astype(rdtype)
        tail2 = jnp.where(t_idx == 0, _planes(state.fir_tail), halo2)
        gain = state.agc["gain"]
        pieces, _t2, _te, w0, dw = _front(tail2, theta0_l, x.astype(rdtype))

        if cfg.demod in ("fm", "am"):
            # collapsed decimated-rate epilogue; FM chains through a
            # 1-sample rotated+gained seam shipped to the right neighbour
            ee = jax.lax.pmean(ddc_ops.ddc_energy_pieces(pieces), "time")
            if cfg.demod == "fm":
                seam = jnp.stack(ddc_ops.ddc_pieces_last_rotated(
                    pieces, w0, dw, gain))
                prev_in = left_halo(seam, "time")           # (2,)
                pr = jnp.where(t_idx == 0,
                               jnp.real(state.fm_prev).astype(rdtype),
                               prev_in[0])
                pi = jnp.where(t_idx == 0,
                               jnp.imag(state.fm_prev).astype(rdtype),
                               prev_in[1])
                out, _, _ = ddc_ops.ddc_fm_epilogue_pieces(
                    pieces, w0, dw, pr, pi, cfg.fm_kf, gain)
                new_fm_prev = from_last_shard(
                    jax.lax.complex(seam[0], seam[1]).astype(cfg.dtype),
                    "time")
            else:  # am: memoryless epilogue, fm_prev carried through
                out = ddc_ops.ddc_am_epilogue_pieces(pieces, gain)
                new_fm_prev = state.fm_prev
            agc_state = agc_ops.block_gain_update(
                state.agc, (gain * gain) * ee, cfg.agc_bandwidth,
                T_loc * n_time)
        else:
            # qpsk / none: rotated output materialized, then the shared
            # sharded AGC + demod staging
            yre, yim = ddc_ops._pieces_flatten(pieces)
            rot = nco_ops.nco_complex_exponential(w0, dw, T_loc, mode="fast")
            cr = jnp.real(rot).astype(rdtype)
            sr = jnp.imag(rot).astype(rdtype)
            y = jax.lax.complex(yre * cr + yim * sr,
                                yim * cr - yre * sr).astype(cfg.dtype)
            st_agc = {k: v[None] for k, v in state.agc.items()}
            y, agc_state = _agc_block_sharded(st_agc, y[None],
                                              cfg.agc_bandwidth, "time")
            agc_state = {k: v[0] for k, v in agc_state.items()}
            if cfg.demod == "qpsk":
                y_full = jax.lax.all_gather(y, "time", axis=y.ndim - 1,
                                            tiled=True)
                out_full, _, _ = qpsk_mod.qpsk_carrier_block(y_full)
                lo = y.shape[-1]
                out = jax.lax.dynamic_slice_in_dim(
                    out_full, t_idx * lo, lo, axis=out_full.ndim - 1)
            else:
                out = y
            out = out[0]
            # qpsk/none don't consume fm_prev — carry it through unchanged
            # so checkpointed ChainState stays bit-identical to the
            # single-chip chain (which only updates fm_prev for fm/am)
            new_fm_prev = state.fm_prev

        # fused chains carry the RAW input tail (pre-mix), like the
        # single-chip fused chain
        tail_pl = from_last_shard(x[:, -n1:], "time").astype(rdtype)
        new_state = ChainState(
            nco_theta=theta_end,
            fir_tail=jax.lax.complex(tail_pl[0],
                                     tail_pl[1]).astype(cfg.dtype),
            fir_phase=state.fir_phase,
            agc=agc_state,
            fm_prev=new_fm_prev,
        )
        return out, new_state

    # ---------------- batched multi-channel fused front end ---------------
    # ONE jax.vmap over the channel axis traces the per-channel engine
    # once (a Python loop over channels would trace it C times).  The
    # vmapped fn returns arrays only (pieces are flattened inside the
    # vmap), and the epilogues run batched outside.  Bit-parity with the
    # loop form is pinned by tests/test_parallel.py.
    dw_s = np.uint32((M * int(np.uint32(dtheta))) & 0xFFFFFFFF)

    def local_fused_multi(state: ChainState, x):
        L_local = x.shape[-1]
        if L_local % M:
            raise ValueError(
                "per-shard block length must be a multiple of the decimation"
            )
        T_loc = L_local // M
        t_idx = jax.lax.axis_index("time")
        offset = time_offset("time", L_local)
        theta0_l = (state.nco_theta + offset * dtheta).astype(jnp.uint32)
        theta_end = (state.nco_theta
                     + jnp.uint32(n_time * L_local) * dtheta
                     ).astype(jnp.uint32)
        halo = left_halo(x[..., -n1:], "time")
        x2b = jnp.stack([jnp.real(x), jnp.imag(x)], axis=1).astype(rdtype)
        tail_b = jnp.stack([jnp.real(state.fir_tail),
                            jnp.imag(state.fir_tail)], axis=1).astype(rdtype)
        halo_b = jnp.stack([jnp.real(halo), jnp.imag(halo)],
                           axis=1).astype(rdtype)
        tails_b = jnp.where(t_idx == 0, tail_b, halo_b)
        gains_b = state.agc["gain"]

        if cfg.demod in ("fm", "am"):
            def chan_p(t2, x2, g):
                pieces, _t2, _te, w0, _dw = _front(t2, theta0_l, x2)
                yre, yim = ddc_ops._pieces_flatten(pieces)
                ee_c = ddc_ops.ddc_energy_pieces(pieces)
                if cfg.demod == "fm":
                    r, i = ddc_ops.ddc_pieces_last_rotated(pieces, w0,
                                                           dw_s, g)
                    seam = jnp.stack([r, i])
                else:
                    seam = jnp.zeros((2,), rdtype)
                return yre, yim, seam, ee_c, w0

            yre_b, yim_b, seams, ees, w0_b = jax.vmap(chan_p)(
                tails_b, x2b, gains_b)
            if cfg.demod == "fm":
                prev_in = left_halo(seams, "time")
                pr = jnp.where(t_idx == 0,
                               jnp.real(state.fm_prev).astype(rdtype),
                               prev_in[:, 0])
                pi = jnp.where(t_idx == 0,
                               jnp.imag(state.fm_prev).astype(rdtype),
                               prev_in[:, 1])
                out, _, _ = jax.vmap(
                    ddc_ops.ddc_fm_epilogue,
                    in_axes=(0, 0, 0, None, 0, 0, None, 0))(
                        yre_b, yim_b, w0_b, dw_s, pr, pi, cfg.fm_kf,
                        gains_b)
                new_fm_prev = from_last_shard(
                    jax.lax.complex(seams[:, 0],
                                    seams[:, 1]).astype(cfg.dtype), "time")
            else:
                out = jax.vmap(ddc_ops.ddc_am_epilogue)(yre_b, yim_b,
                                                        gains_b)
                new_fm_prev = state.fm_prev
            ee = jax.lax.pmean(ees, "time")
            gain = state.agc["gain"]
            agc_state = agc_ops.block_gain_update(
                state.agc, (gain * gain) * ee, cfg.agc_bandwidth,
                T_loc * n_time)
        else:
            # qpsk / none: rotated output materialized, then the shared
            # sharded AGC + demod staging (same rotation for all channels)
            def chan_r(t2, x2):
                pieces, _t2, _te, w0, _dw = _front(t2, theta0_l, x2)
                yre, yim = ddc_ops._pieces_flatten(pieces)
                return yre, yim, w0

            yre_b, yim_b, w0_b = jax.vmap(chan_r)(tails_b, x2b)
            rot = nco_ops.nco_complex_exponential(w0_b[0], dw_s, T_loc,
                                                  mode="fast")
            cr = jnp.real(rot).astype(rdtype)
            sr = jnp.imag(rot).astype(rdtype)
            y = jax.lax.complex(yre_b * cr + yim_b * sr,
                                yim_b * cr - yre_b * sr).astype(cfg.dtype)
            y, agc_state = _agc_block_sharded(state.agc, y,
                                              cfg.agc_bandwidth, "time")
            if cfg.demod == "qpsk":
                y_full = jax.lax.all_gather(y, "time", axis=y.ndim - 1,
                                            tiled=True)
                out_full, _, _ = qpsk_mod.qpsk_carrier_block(y_full)
                lo = y.shape[-1]
                out = jax.lax.dynamic_slice_in_dim(
                    out_full, t_idx * lo, lo, axis=out_full.ndim - 1)
            else:
                out = y
            new_fm_prev = state.fm_prev   # not consumed: carry unchanged

        new_state = ChainState(
            nco_theta=theta_end,
            fir_tail=from_last_shard(x[..., -n1:], "time"),
            fir_phase=state.fir_phase,
            agc=agc_state,
            fm_prev=new_fm_prev,
        )
        return out, new_state

    # ---------------- unfused (LUT-NCO parity) staging --------------------
    def local_unfused(state: ChainState, x):
        L_local = x.shape[-1]
        if L_local % M:
            raise ValueError(
                "per-shard block length must be a multiple of the decimation"
            )
        # 1. NCO downconvert — phase is closed-form, so each time shard
        #    starts at theta0 + offset * dtheta with zero communication.
        offset = time_offset("time", L_local)
        theta0_l = (state.nco_theta + offset * dtheta).astype(jnp.uint32)
        mixed, _ = nco_ops.mix_down_block(x, theta0_l, dtheta, lut,
                                          cfg.nco_mode)
        theta_end = (state.nco_theta
                     + jnp.uint32(n_time * L_local) * dtheta).astype(jnp.uint32)

        # 2. decimating FIR with neighbor halo instead of a carried tail.
        t_idx = jax.lax.axis_index("time")
        halo = left_halo(mixed[..., -(n - 1):], "time")
        eff_tail = jnp.where(t_idx == 0, state.fir_tail, halo)
        # L_local % M == 0 ⇒ every shard sees the same decimator phase.
        y, _, fir_phase = fir_ops.fir_decim_apply(
            taps, eff_tail, state.fir_phase, mixed,
            jnp.asarray(1.0, dtype=cfg.dtype), M,
            precision=cfg.fir_precision,
        )
        new_fir_tail = from_last_shard(mixed[..., -(n - 1):], "time")

        # 3. AGC — block mode with globally averaged energy.
        y, agc_state = _agc_block_sharded(state.agc, y, cfg.agc_bandwidth,
                                          "time")

        # 4. demod.  FM needs a 1-sample halo for the discriminator memory;
        #    AM envelope and passthrough are memoryless; QPSK carrier
        #    recovery estimates from the WHOLE block (4th-power spectral
        #    line), so the time shards all_gather the decimated stream, run
        #    the same estimator as the single-chip chain, and keep their own
        #    slice — semantics identical to qpsk_carrier_block on the full
        #    block, cost one (L/M)-sample all-gather.
        if cfg.demod == "fm":
            prev_halo = left_halo(y[..., -1], "time")
            fm_prev_l = jnp.where(t_idx == 0, state.fm_prev, prev_halo)
            out, _ = fm_mod.fm_demodulate(fm_prev_l, y, cfg.fm_kf)
            new_fm_prev = from_last_shard(y[..., -1], "time")
        elif cfg.demod == "qpsk":
            y_full = jax.lax.all_gather(y, "time", axis=y.ndim - 1,
                                        tiled=True)
            out_full, _, _ = qpsk_mod.qpsk_carrier_block(y_full)
            lo = y.shape[-1]
            out = jax.lax.dynamic_slice_in_dim(
                out_full, t_idx * lo, lo, axis=out_full.ndim - 1)
            new_fm_prev = state.fm_prev   # not consumed: carry unchanged
        elif cfg.demod == "am":
            out = jnp.abs(y)
            new_fm_prev = state.fm_prev
        else:
            out = y
            new_fm_prev = state.fm_prev

        new_state = ChainState(
            nco_theta=theta_end,
            fir_tail=new_fir_tail,
            fir_phase=fir_phase,
            agc=agc_state,
            fm_prev=new_fm_prev,
        )
        return out, new_state

    local_fn = ((local_fused_planar if planar else local_fused_multi)
                if fused else local_unfused)
    chanspec = P() if planar else P("channel")
    state_spec = ChainState(
        nco_theta=P(),
        fir_tail=chanspec,
        fir_phase=P(),
        agc={"gain": chanspec, "energy": chanspec,
             "lock": chanspec, "mode": chanspec,
             "timer": chanspec},
        fm_prev=chanspec,
    )
    in_spec = P(None, "time") if planar else P("channel", "time")
    out_spec = P("time") if planar else P("channel", "time")
    mapped = jax.shard_map(
        local_fn,
        mesh=mesh,
        in_specs=(state_spec, in_spec),
        out_specs=(out_spec, state_spec),
    )
    return init, jax.jit(mapped)


def _agc_block_sharded(state, x, alpha, axis_name):
    """Block-mode AGC whose energy estimate is pmean-ed over ``axis_name``.

    Equal-size time shards ⇒ pmean of local means == full-block mean, so this
    reproduces single-chip ``agc_apply_block_mode`` exactly (both funnel
    through ``agc.block_gain_update``).
    """
    gain = state["gain"]
    out = x * gain[..., None].astype(x.dtype)
    ee_local = jnp.mean(jnp.real(out * jnp.conj(out)), axis=-1)
    ee = jax.lax.pmean(ee_local, axis_name)
    T = x.shape[-1] * jax.lax.axis_size(axis_name)
    return out, agc_ops.block_gain_update(state, ee, alpha, T)


# ---------------------------------------------------------------------------
# sharded channelizer (driver config 5)
# ---------------------------------------------------------------------------

def make_sharded_channelizer(num_channels: int, taps_per_branch: int = 8,
                             mesh: Mesh | None = None,
                             attenuation: float = 80.0,
                             dtype=jnp.complex64):
    """256-channel-class polyphase channelizer over a 2D mesh.

    2D decomposition:

    * ``time``    — the input stream is split into overlap-save blocks;
      each shard receives a ``K*M - 1`` raw-sample halo from its left
      neighbor (``ppermute``).
    * ``channel`` — genuine tensor parallelism: the K tap rows of the
      prototype polyphase matrix are split across the axis and the partial
      branch products combined with one ``psum``; then each shard extracts
      its own M / n_channel_shards output channels with a partial-IDFT
      matmul at full float32 precision, so no shard ever materializes
      all M channels.

    Returns ``(init, apply)`` where ``apply(tail, x) -> (Y, new_tail)``:
    ``x``: (L,) sharded over time (replicated over ``channel``);
    ``Y``: (T, M) sharded ``P('time', 'channel')``.
    """
    M = int(num_channels)
    K = int(taps_per_branch)
    if mesh is None:
        raise ValueError("make_sharded_channelizer requires a mesh")
    n_cs = mesh.shape["channel"]
    if K % n_cs:
        raise ValueError(f"taps_per_branch ({K}) must divide by the channel "
                         f"axis size ({n_cs})")
    if M % n_cs:
        raise ValueError(f"num_channels ({M}) must divide by the channel "
                         f"axis size ({n_cs})")
    taps = np.asarray(channelizer_taps(M, K, attenuation), dtype=dtype)
    K_loc = K // n_cs
    M_loc = M // n_cs
    # Gather-free commutator form (models/channelizer.py docstring): with
    # P[u, q] = x_ext[u*M + q] and G = reverse(taps[:K*M]).reshape(K, M),
    # z2[t, q] = sum_k' G[k', q] P[t + k', q] where z2[q] = z[r = M-1-q].
    # The tap-parallel split hands each channel shard K_loc of the K
    # shifted multiply-adds (partial sums psum'd), with no (T, K, M)
    # advanced-index gather.
    G = np.asarray(taps)[: K * M][::-1].reshape(K, M)
    # partial inverse-DFT extractor in z2's q indexing:
    #   Y[t, m] = sum_r z[t, r] e^{+2 pi i r m / M} = sum_q z2[t, q] W2[q, m],
    #   W2[q, m] = e^{+2 pi i (M-1-q) m / M}
    q = np.arange(M)[:, None]
    m = np.arange(M)[None, :]
    W2_full = np.exp(2j * np.pi * (M - 1 - q) * m / M)
    halo_len = K * M - 1

    def init():
        from ..utils.transfer import zeros_device

        return zeros_device(halo_len, dtype)

    def local_fn(tail, x):
        c_idx = jax.lax.axis_index("channel")
        t_idx = jax.lax.axis_index("time")
        L_loc = x.shape[-1]
        if L_loc % M:
            raise ValueError("per-shard length must be a multiple of M")
        T_loc = L_loc // M
        halo = left_halo(x[..., -halo_len:], "time")
        eff_tail = jnp.where(t_idx == 0, tail, halo)
        x_ext = jnp.concatenate([eff_tail, x], axis=-1)

        # tap-parallel front end: this shard sums its K_loc of the K
        # shifted multiply-adds (P framing identical to channelizer_apply:
        # x_ext = [K*M-1 tail | block], P[u, q] = x_ext[u*M + q]).
        P = x_ext[..., : (T_loc + K - 1) * M].reshape(T_loc + K - 1, M)
        G_loc = jax.lax.dynamic_slice_in_dim(
            jnp.asarray(G).astype(x.dtype), c_idx * K_loc, K_loc, axis=0)
        z_part = G_loc[0] * jax.lax.dynamic_slice_in_dim(P, c_idx * K_loc,
                                                         T_loc, axis=0)
        for j in range(1, K_loc):
            z_part = z_part + G_loc[j] * jax.lax.dynamic_slice_in_dim(
                P, c_idx * K_loc + j, T_loc, axis=0)
        z2 = jax.lax.psum(z_part, "channel")  # (T_loc, M), q-indexed

        # channel-parallel output DFT: extract this shard's channel slice.
        W_loc = jax.lax.dynamic_slice_in_dim(
            jnp.asarray(W2_full, dtype=z2.dtype), c_idx * M_loc, M_loc,
            axis=1)
        # HIGHEST: a float32 matmul may otherwise run in TF32 on the GPU
        Y = jnp.matmul(z2, W_loc, precision=jax.lax.Precision.HIGHEST)
        new_tail = from_last_shard(x[..., -halo_len:], "time")
        return Y, new_tail

    mapped = jax.shard_map(
        local_fn,
        mesh=mesh,
        in_specs=(P(), P("time")),
        out_specs=(P("time", "channel"), P()),
    )
    return init, jax.jit(mapped)
