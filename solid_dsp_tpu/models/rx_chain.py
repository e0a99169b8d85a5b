"""RxChain — the flagship composed receive chain.

NCO downconvert -> decimating FIR -> AGC -> demod (FM / QPSK / AM), the
driver's config-4 chain and the idiom of the reference's demo binary
(src/main.rs:25-46: NCO tone -> PLL IIR filter).

Everything is one pure jittable block transform
``rx_chain_apply(params, state, x) -> (out, state)`` whose state pytree
(NCO phase word, FIR tail + decimator phase, AGC carry, demod carry) is the
checkpoint format and the multi-chip halo payload.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..design import firdes
from ..ops import agc as agc_ops
from ..ops import ddc as ddc_ops
from ..ops import fir as fir_ops
from ..ops import nco as nco_ops
from ..streaming.state import ChainState
from ..utils.transfer import put_tree
from . import fm as fm_mod
from . import qpsk as qpsk_mod


@dataclass
class RxChainConfig:
    """Static chain configuration (compiled into the jitted program)."""

    carrier_freq: float = 0.2          # rad/sample NCO downconversion
    decimation: int = 4
    fir_taps: int = 64
    fir_cutoff: float = 0.1            # normalized (0, 0.5)
    fir_attenuation: float = 60.0      # dB
    agc_bandwidth: float = 0.01
    agc_mode: str = "block"   # "exact" (scan) | "parallel" (exact, fast) | "block"
    demod: str = "fm"                  # "fm" | "qpsk" | "am" | "none"
    fm_kf: float = 0.1
    nco_mode: str = "exact"            # "lut" (ref parity) | "exact"
    dtype: object = jnp.complex64
    # SURVEY §5 sanitizer analog: when True, per-stage finite checks run
    # inside the jitted chain and the wrapper raises FloatingPointError
    # naming the first stage that produced a NaN/Inf.  Off by default (one
    # extra scalar fetch per block when on).
    debug_checks: bool = False
    # Ingest format: "cf32" takes complex blocks; "ci16" takes raw (T, 2)
    # int16 IQ (the native SDR capture format) and converts ON DEVICE —
    # half the ingest bytes per sample, conversion fused into the NCO
    # mix by XLA; "planar" takes (2, L) float re/im planes (complex64 is
    # interleaved in device memory, so .real/.imag are strided loads;
    # planar planes feed the DDC matmuls directly).
    input_format: str = "cf32"
    # Fused digital down-conversion (ops/ddc.py): folds the NCO mix into
    # complex bandpass FIR taps + one post-rotation at the DECIMATED rate,
    # so nothing but the filter matmul touches the full-rate stream.
    # "auto" enables it when nco_mode == "exact" (the fused math is the
    # exact-mix identity; LUT-quantized mixing cannot fold).  Parity with
    # the unfused chain is gated >= 100 dB in tests/test_ddc.py and
    # tests/test_rx_chain_fused.py.
    fused_ddc: str = "auto"           # "auto" | "on" | "off"
    # Front-end impairment correction (models.impairments): estimate DC
    # offset and IQ-imbalance per block (EMA-tracked in the ChainState)
    # and cancel them before the NCO mix.  Bandwidth is the per-block EMA
    # coefficient; 0 disables the stage.
    impairment_bw: float = 0.0
    # Dot precision of the FIR/DDC matmuls (ops.fir._resolve_precision).
    # FM output against the unfused complex128 chain, 3 blocks of 2^24
    # samples, on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py):
    # "highest" (default) — full float32 products, 116.5 dB;
    # "x3" — three TF32 tensor-core passes (TF32_TF32_F32_X3), 123.4 dB;
    # "default" — one TF32 pass, 65.1 dB (above the 60 dB gate; for
    # link budgets that tolerate it).  On the CPU all three are float32.
    fir_precision: str = "highest"
    # Decimated-rate epilogue: "auto" collapses rotate -> AGC-scale ->
    # demod into one elementwise pass over the unrotated DDC body output
    # when the demod is rotation/gain-invariant (FM phase differences, AM
    # envelope) and agc_mode is "block" (ops/ddc.py::ddc_fm_epilogue
    # rationale); "rotate" always materializes the rotated, gained signal
    # (reference-shaped staging — useful for stage-by-stage debugging).
    epilogue: str = "auto"            # "auto" | "rotate"

    def design_taps(self) -> np.ndarray:
        taps = firdes.firdes_kaiser(
            self.fir_taps, self.fir_cutoff, self.fir_attenuation, 0.0
        )
        return taps / np.sum(taps)  # unity DC gain


def rx_chain_init(cfg: RxChainConfig) -> ChainState:
    # built host-side in numpy, then moved to the device in one put_tree
    rdtype = np.zeros(0, dtype=cfg.dtype).real.dtype
    parts = dict(
        nco_theta=np.uint32(0),
        fir_tail=np.zeros((max(cfg.fir_taps - 1, 0),), dtype=cfg.dtype),
        fir_phase=np.int32(0),
        agc=agc_ops.agc_init(rdtype, xp=np),
        fm_prev=np.ones((), dtype=cfg.dtype),
    )
    if cfg.impairment_bw > 0.0:
        parts["impair"] = {
            "dc": np.zeros((), cfg.dtype),
            "k": np.zeros((), cfg.dtype),
            "primed": np.zeros((), np.bool_),
        }
    return put_tree(ChainState(**parts))


def make_rx_chain(cfg: RxChainConfig):
    """Build (init_state, apply) where apply is jit-compiled.

    apply(state, x_block) -> (demod_out, new_state); block length must be a
    multiple of the decimation factor.
    """
    if cfg.agc_mode not in ("exact", "parallel", "block"):
        raise ValueError(f"unknown agc_mode {cfg.agc_mode!r}")
    if cfg.input_format not in ("cf32", "ci16", "planar"):
        raise ValueError(f"unknown input_format {cfg.input_format!r}")
    if cfg.fir_precision not in ("highest", "x3", "default"):
        raise ValueError(f"unknown fir_precision {cfg.fir_precision!r}")
    if cfg.fused_ddc not in ("auto", "on", "off"):
        raise ValueError(f"unknown fused_ddc {cfg.fused_ddc!r}")
    if cfg.epilogue not in ("auto", "rotate"):
        raise ValueError(f"unknown epilogue {cfg.epilogue!r}")
    fused = (cfg.fused_ddc == "on"
             or (cfg.fused_ddc == "auto" and cfg.nco_mode == "exact"))
    if cfg.fused_ddc == "on" and cfg.nco_mode != "exact":
        raise ValueError("fused_ddc requires nco_mode='exact' "
                         "(LUT-quantized mixing cannot fold into taps)")
    # closure constants stay host-side numpy: jit embeds them as
    # compile-time constants
    rdtype = np.zeros(0, dtype=cfg.dtype).real.dtype
    taps_design = cfg.design_taps()          # real f64 prototype (host)
    taps = np.asarray(taps_design, dtype=cfg.dtype)
    dtheta = nco_ops.constrain(cfg.carrier_freq)
    lut = nco_ops.make_sine_lut(rdtype)

    @jax.jit
    def apply(state: ChainState, x: jnp.ndarray):
        planar_in = cfg.input_format == "planar"
        if cfg.input_format == "ci16":
            # raw interleaved int16 IQ -> float elementwise (fuses into
            # the mix); same scaling as the native runtime's iq_to_cf32
            xs = x.astype(rdtype) * np.asarray(1.0 / 32767.0, rdtype)
            if fused and cfg.impairment_bw == 0.0:
                x2 = xs.T  # (2, L) planes
                planar_in = True
            else:
                x = jax.lax.complex(xs[..., 0], xs[..., 1]).astype(cfg.dtype)
        elif planar_in:
            if fused and cfg.impairment_bw == 0.0:
                x2 = x.astype(rdtype)
            else:
                x = jax.lax.complex(x[0], x[1]).astype(cfg.dtype)
                planar_in = False
        # 0. front-end impairment correction (optional; shared blend rule)
        if cfg.impairment_bw > 0.0:
            from . import impairments as imp_mod

            st_i = state.impair
            x, dc, k = imp_mod.ema_correct(
                x, st_i["dc"], st_i["k"],
                jnp.asarray(cfg.impairment_bw, cfg.dtype), st_i["primed"])
            impair_state = {"dc": dc, "k": k, "primed": jnp.asarray(True)}
        # Collapsed decimated-rate epilogue (ops/ddc.py epilogue helpers):
        # the post-rotation (|e^{-jw}| = 1) and the block AGC gain (real,
        # > 0) are invisible to the FM discriminator's phase differences
        # and scale the AM envelope linearly, so for those demods the
        # whole rotate -> AGC-scale -> demod pipeline folds into one
        # elementwise pass over the UNROTATED body output — no per-sample
        # oscillator, no interleaved-complex materialization.  State
        # (AGC carry, fm_prev) stays bit-compatible with the rotated path.
        collapse = (fused and cfg.agc_mode == "block"
                    and cfg.demod in ("fm", "am")
                    and cfg.epilogue == "auto")
        if collapse:
            x2c = x2 if planar_in else jnp.stack([jnp.real(x), jnp.imag(x)])
            tail2 = jnp.stack([jnp.real(state.fir_tail),
                               jnp.imag(state.fir_tail)])
            pieces, tail2n, theta_end, w0, dw = ddc_ops.ddc_apply_planar_pieces(
                taps_design, dtheta, tail2, state.nco_theta, x2c,
                cfg.decimation, precision=cfg.fir_precision)
            fir_tail = jax.lax.complex(tail2n[0], tail2n[1]).astype(cfg.dtype)
            fir_phase = state.fir_phase
            gain = state.agc["gain"]
            T_dec = sum(ddc_ops._piece_len(p) for p in pieces)
            ee = (gain * gain) * ddc_ops.ddc_energy_pieces(pieces)
            agc_state = agc_ops.block_gain_update(
                state.agc, ee, cfg.agc_bandwidth, T_dec)
            if cfg.demod == "fm":
                out, pr, pi = ddc_ops.ddc_fm_epilogue_pieces(
                    pieces, w0, dw,
                    jnp.real(state.fm_prev), jnp.imag(state.fm_prev),
                    cfg.fm_kf, gain)
                fm_prev = jax.lax.complex(pr, pi).astype(cfg.dtype)
            else:  # "am"
                out = ddc_ops.ddc_am_epilogue_pieces(pieces, gain)
                fm_prev = state.fm_prev
            new_parts = dict(
                nco_theta=theta_end,
                fir_tail=fir_tail,
                fir_phase=fir_phase,
                agc=agc_state,
                fm_prev=fm_prev,
            )
            if cfg.impairment_bw > 0.0:
                new_parts["impair"] = impair_state
            new_state = ChainState(**new_parts)
            if cfg.debug_checks:
                z_ok = jnp.asarray(True)
                for p in pieces:
                    arrs = (p[1], p[2]) if p[0] == "flat" else (p[1],)
                    for a in arrs:
                        z_ok = z_ok & jnp.all(jnp.isfinite(a))
                inp_ok = (jnp.all(jnp.isfinite(x2c)) if planar_in
                          else jnp.all(jnp.isfinite(x)))
                flags = {
                    "input": inp_ok,
                    "nco": inp_ok,  # mix folded into the DDC matmul
                    "fir": z_ok,    # |z| finite <=> |y| finite (|rot| = 1)
                    "agc": z_ok & jnp.isfinite(agc_state["gain"]),
                    "demod": jnp.all(jnp.isfinite(out)),
                }
                return out, new_state, flags
            return out, new_state

        if fused:
            # 1+2 fused: bandpass-Toeplitz matmul + decimated-rate rotation
            # (ops/ddc.py); semantics = exact mix -> fir_decim_apply,
            # gated >= 100 dB in tests.  The carried tail is the PRE-mix
            # raw stream (stored complex for checkpoint compatibility).
            if planar_in:
                tail2 = jnp.stack([jnp.real(state.fir_tail),
                                   jnp.imag(state.fir_tail)])
                out_re, out_im, tail2n, theta_end = ddc_ops.ddc_apply_planar(
                    taps_design, dtheta, tail2, state.nco_theta, x2,
                    cfg.decimation, precision=cfg.fir_precision)
                y = jax.lax.complex(out_re, out_im).astype(cfg.dtype)
                fir_tail = jax.lax.complex(
                    tail2n[0], tail2n[1]).astype(cfg.dtype)
            else:
                y, fir_tail, theta_end = ddc_ops.ddc_apply(
                    taps_design, dtheta, state.fir_tail, state.nco_theta,
                    x, cfg.decimation, precision=cfg.fir_precision)
                mixed = x  # for debug_checks; mix itself is folded away
            fir_phase = state.fir_phase  # stays 0: L % M == 0 invariant
        else:
            # 1. downconvert (closed-form phases, no sequential dependency)
            mixed, theta_end = nco_ops.mix_down_block(
                x, state.nco_theta, dtheta, lut, cfg.nco_mode
            )
            # 2. decimating FIR (polyphase matmul)
            y, fir_tail, fir_phase = fir_ops.fir_decim_apply(
                taps, state.fir_tail, state.fir_phase, mixed,
                jnp.asarray(1.0, dtype=cfg.dtype), cfg.decimation,
                precision=cfg.fir_precision,
            )
        y_fir = y
        # 3. AGC
        if cfg.agc_mode == "exact":
            y, agc_state = agc_ops.agc_apply(
                state.agc, y, cfg.agc_bandwidth, 1.0, -1e30, 100
            )
        elif cfg.agc_mode == "parallel":
            # exact reference semantics, block-parallel Newton solve
            y, agc_state = agc_ops.agc_apply_parallel(
                state.agc, y, cfg.agc_bandwidth, 1.0, -1e30, 100
            )
        else:  # "block" — the 3 modes are validated at make_rx_chain entry
            y, agc_state = agc_ops.agc_apply_block_mode(
                state.agc, y, cfg.agc_bandwidth
            )
        # 4. demod
        fm_prev = state.fm_prev
        if cfg.demod == "fm":
            out, fm_prev = fm_mod.fm_demodulate(fm_prev, y, cfg.fm_kf)
        elif cfg.demod == "qpsk":
            out, _, _ = qpsk_mod.qpsk_carrier_block(y)
        elif cfg.demod == "am":
            out = jnp.abs(y)
        else:
            out = y
        new_parts = dict(
            nco_theta=theta_end,
            fir_tail=fir_tail,
            fir_phase=fir_phase,
            agc=agc_state,
            fm_prev=fm_prev,
        )
        if cfg.impairment_bw > 0.0:
            new_parts["impair"] = impair_state
        new_state = ChainState(**new_parts)
        if cfg.debug_checks:
            if fused and planar_in:
                inp_ok = jnp.all(jnp.isfinite(x2))
                mix_ok = inp_ok  # mix is folded into the DDC matmul
            else:
                inp_ok = jnp.all(jnp.isfinite(x))
                mix_ok = jnp.all(jnp.isfinite(mixed))
            flags = {
                "input": inp_ok,
                "nco": mix_ok,
                "fir": jnp.all(jnp.isfinite(y_fir)),
                "agc": jnp.all(jnp.isfinite(y)),
                "demod": jnp.all(jnp.isfinite(out)),
            }
            return out, new_state, flags
        return out, new_state

    if not cfg.debug_checks:
        return partial(rx_chain_init, cfg), apply

    def checked_apply(state: ChainState, x):
        out, new_state, flags = apply(state, x)
        for stage in ("input", "nco", "fir", "agc", "demod"):
            if not bool(flags[stage]):  # scalar fetch; debug mode only
                raise FloatingPointError(
                    f"non-finite values detected at chain stage {stage!r}"
                )
        return out, new_state

    return partial(rx_chain_init, cfg), checked_apply


def make_rx_chain_stream(cfg: RxChainConfig, block_size: int):
    """Long-stream driver: ONE dispatch processes many chain blocks.

    Returns (init, apply_stream) where ``apply_stream(state, x)`` reshapes
    ``x`` (length = n_blocks * block_size, static per compilation) into
    blocks and loops the chain over them on device — the per-call dispatch
    and scheduling overhead is paid once per stream instead of once per
    block.  Works with any agc_mode
    except debug_checks (per-stage flags don't thread through scan).
    """
    if cfg.debug_checks:
        raise ValueError("debug_checks is incompatible with the stream scan")
    init, apply = make_rx_chain(cfg)

    @jax.jit
    def apply_stream(state: ChainState, x: jnp.ndarray):
        # ci16 input is (T, 2) int16 — the stream length is axis 0 there
        n = x.shape[0] if cfg.input_format == "ci16" else x.shape[-1]
        if n % block_size:
            raise ValueError("stream length must be a multiple of block_size")
        if cfg.input_format == "ci16":
            xb = x.reshape(n // block_size, block_size, 2)
        elif cfg.input_format == "planar":
            xb = x.reshape(2, n // block_size, block_size).swapaxes(0, 1)
        else:
            xb = x.reshape(n // block_size, block_size)
        n_blocks = int(xb.shape[0])
        # fori_loop writing into one preallocated output buffer (scan
        # would stack the per-block outputs through its carry machinery)
        y0_shape = jax.eval_shape(apply, state,
                                  jax.ShapeDtypeStruct(xb.shape[1:],
                                                       xb.dtype))[0]
        out0 = jnp.zeros((n_blocks, *y0_shape.shape), y0_shape.dtype)

        def body(i, carry):
            st, out = carry
            blk = jax.lax.dynamic_index_in_dim(xb, i, 0, keepdims=False)
            y, st2 = apply(st, blk)
            out = jax.lax.dynamic_update_index_in_dim(out, y, i, 0)
            return (st2, out)

        state, outs = jax.lax.fori_loop(0, n_blocks, body, (state, out0))
        return outs.reshape(-1), state

    return partial(rx_chain_init, cfg), apply_stream


class RxChain:
    """Stateful streaming wrapper around the jitted chain."""

    def __init__(self, cfg: RxChainConfig | None = None, **overrides):
        self.cfg = cfg or RxChainConfig(**overrides)
        init, self._apply = make_rx_chain(self.cfg)
        self.state = init()

    def execute_block(self, x):
        from ..utils.transfer import astype_device, ingest

        in_dtype = (jnp.int16 if self.cfg.input_format == "ci16"
                    else np.zeros(0, self.cfg.dtype).real.dtype
                    if self.cfg.input_format == "planar" else self.cfg.dtype)
        if not isinstance(x, jax.Array):
            x = np.asarray(x)
            if x.dtype != np.dtype(in_dtype):
                # dtype conversion stays host-side, before the transfer
                x = x.astype(np.dtype(in_dtype))
        elif x.dtype != jnp.dtype(in_dtype):
            # device arrays are cast on device: a complex128 block into a
            # complex64 chain must not silently trace the f64 path (which
            # changes the output dtype)
            x = astype_device(x, in_dtype)
        out, self.state = self._apply(self.state, ingest(x))
        return out

    def reset(self):
        self.state = rx_chain_init(self.cfg)

    def __repr__(self):
        return (
            f"RxChain [fc={self.cfg.carrier_freq}] [M={self.cfg.decimation}] "
            f"[taps={self.cfg.fir_taps}] [demod={self.cfg.demod}] "
            f"state={self.state!r}"
        )
