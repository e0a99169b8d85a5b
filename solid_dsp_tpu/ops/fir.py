"""Block FIR filtering: plain, decimating, interpolating, polyphase bank.

Parity: reference ``src/filter/fir/`` — FIRFilter (mod.rs:58-303),
DecimatingFIRFilter (decim.rs:5-228), InterpolatingFIRFilter (interp.rs:6-100),
PolyPhaseFilterBank (pfb.rs:3-91).

Reference semantics (decoded from dot_product REVERSE storage + newest-first
Window): with taps ``c[0..N)`` the output is the *sliding correlation*

    y[n] = sum_i c[i] * x[n - (N - 1 - i)]

i.e. convolution with the reversed tap vector.  In block form with an
explicit carried tail (the last N-1 inputs) this is

    y[t] = sum_i c[i] * x_ext[t + i],   x_ext = [tail | x_block]

which maps onto an accelerator two ways:

* ``matmul``: a sliding correlation as one matrix contraction (XLA
  convolution, or banded-Toeplitz GEMMs — see :func:`fir_toeplitz`);
* ``fft``: overlap-save via batched FFTs (the cheaper path for long
  filters).

The sample-at-a-time ``Window::push`` + 2 copies + scalar MAC of the
reference (fir/mod.rs:208-212, the #1 speed-of-light gap noted in SURVEY §3.2)
disappears entirely.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..analysis.freq_response import fir_frequency_response
from ..analysis.group_delay import fir_group_delay
from ..streaming.framing import extend_with_tail, frame_windows, split_tail
from .. import routing
from ..utils.transfer import astype_device, ingest, zeros_device

__all__ = [
    "fir_init",
    "fir_apply",
    "fir_decim_apply",
    "fir_interp_apply",
    "pfb_branch_matrix",
    "FIRFilter",
    "DecimatingFIRFilter",
    "InterpolatingFIRFilter",
    "PolyPhaseFilterBank",
    "RationalResampler",
]


# --------------------------------------------------------------------------
# functional core
# --------------------------------------------------------------------------

def fir_init(ntaps: int, dtype=jnp.complex64, batch_shape: tuple = ()) -> jnp.ndarray:
    """Zero tail of length ntaps-1 (the reference's zeroed Window)."""
    from ..utils.transfer import zeros_device

    return zeros_device((*batch_shape, max(ntaps - 1, 0)), dtype)


def conv1d_mxu(x: jnp.ndarray, taps: jnp.ndarray, stride: int = 1,
               precision=None) -> jnp.ndarray:
    """Strided sliding correlation as one matrix contraction.

    ``taps`` of shape (n,) or (n, O); returns
    ``y[..., t(, o)] = sum_i taps[i(, o)] * x[..., t*stride + i]``.

    This replaces the im2col-gather formulation: XLA's conv never
    materializes the (T, n) window matrix, so HBM traffic stays O(L)
    instead of O(L * n).  Complex data/taps decompose into a 2-channel real
    conv (out_re = xr*kr - xi*ki, out_im = xr*ki + xi*kr), which XLA maps to
    one contraction.

    ``precision``: None/"highest" keeps full f32 accuracy; "default" lets
    the backend pick its fast mode (TF32 tensor cores on an NVIDIA GPU);
    see :func:`_resolve_precision` for "x3".

    On the GPU this routes to the banded-Toeplitz ``dot_general``
    formulation (:func:`fir_toeplitz`, identical contract), which XLA
    hands to its GEMM path; XLA:CPU keeps the direct conv lowering
    (routing.fir_uses_toeplitz).
    """
    vec = taps.ndim == 1
    if routing.fir_uses_toeplitz():
        n_ = taps.shape[-1] if vec else taps.shape[0]
        if (x.shape[-1] - n_) // stride + 1 >= 1:
            return fir_toeplitz(x, taps, stride=stride, precision=precision)
    return fir_conv(x, taps, stride=stride, precision=precision)


def fir_conv(x: jnp.ndarray, taps: jnp.ndarray, stride: int = 1,
             precision=None) -> jnp.ndarray:
    """:func:`conv1d_mxu`'s contract as one ``conv_general_dilated``
    (the CPU route; cuDNN on the GPU when called directly)."""
    vec = taps.ndim == 1
    taps2 = taps[:, None] if vec else taps
    n, O = taps2.shape
    batch_shape = x.shape[:-1]
    L = x.shape[-1]
    xb = x.reshape((-1, L))
    T = (L - n) // stride + 1
    prec = _resolve_precision(precision)
    if jnp.issubdtype(x.dtype, jnp.complexfloating) or jnp.issubdtype(
        taps2.dtype, jnp.complexfloating
    ):
        cd = jnp.result_type(x.dtype, taps2.dtype, jnp.complex64)
        xb = xb.astype(cd)
        k = taps2.astype(cd)
        xr = jnp.stack([xb.real, xb.imag], axis=-1)  # (B, L, 2)
        kr, ki = k.real, k.imag
        # W[w, i, o]: out channels [re_0..re_{O-1}, im_0..im_{O-1}]
        W = jnp.concatenate(
            [jnp.stack([kr, -ki], axis=1), jnp.stack([ki, kr], axis=1)],
            axis=-1,
        )  # (n, 2, 2O)
        y2 = jax.lax.conv_general_dilated(
            xr, W.astype(xr.dtype), window_strides=(stride,), padding="VALID",
            dimension_numbers=("NWC", "WIO", "NWC"), precision=prec,
        )
        y = jax.lax.complex(y2[..., :O], y2[..., O:]).astype(cd)
    else:
        y = jax.lax.conv_general_dilated(
            xb[:, :, None], taps2.astype(x.dtype)[:, None, :],
            window_strides=(stride,), padding="VALID",
            dimension_numbers=("NWC", "WIO", "NWC"), precision=prec,
        )
    y = y.reshape(*batch_shape, T, O)
    return y[..., 0] if vec else y


def _resolve_precision(precision):
    """Map the framework's precision strings to XLA dot precision.

    "highest" (default): full float32 products and sums.
    "x3": the TF32_TF32_F32_X3 dot algorithm on the GPU (each float32
    operand split into high and low TF32 parts, three tensor-core
    passes, ~f32-grade result); full float32 on the CPU
    (routing.x3_precision).
    "default": the backend's fast mode — TF32 tensor cores on an NVIDIA
    GPU, plain float32 on the CPU.

    Measured on the config-4 FM chain against the unfused complex128
    chain on an NVIDIA H100 80GB HBM3 (chip_smoke.py): highest 116.5 dB,
    x3 123.4 dB, default 65.1 dB.
    """
    if precision in (None, "highest"):
        return jax.lax.Precision.HIGHEST
    if precision == "default":
        return jax.lax.Precision.DEFAULT
    if precision == "x3":
        return routing.x3_precision()
    return precision


def _auto_block(n: int, stride: int, O: int, T: int) -> int:
    """Outputs-per-frame P for the banded-Toeplitz matmul.

    Balances GEMM output width (want N = P*O >= ~128 columns) against
    FLOP redundancy (the dense band does (P*stride + n - 1) MACs per
    output vs the useful n — redundancy grows linearly in P*stride).
    For 64 taps at stride 4 the redundancy cap (P=64) binds before the
    width target.  For multi-output banks (PFB: O large) the width target
    is met by O itself, so P shrinks toward its floor — keeping the bank
    matrix small instead of an O(P*O) blowup.
    """
    floor_p = max(-(-max(n - 1, 1) // stride), 1)   # heads need n-1 <= hop
    tile = max(128 // max(O, 1), 8)                 # N-dim target
    redundancy_cap = max((4 * n) // stride, 8)      # <=~5x extra MACs
    return max(floor_p, min(tile, redundancy_cap, max(T, 1)))


def _banks_np(taps2: np.ndarray, P: int, stride: int):
    """Host-side banded-Toeplitz banks: body (hop, P*O) and heads
    (n-1, P*O) rows of H[j, p*O+o] = taps2[j - p*stride, o]."""
    n, O = taps2.shape
    hop = P * stride
    H = np.zeros((hop + n - 1, P * O), taps2.dtype)
    for p in range(P):
        H[p * stride : p * stride + n, p * O : (p + 1) * O] = taps2
    return H[:hop], H[hop:]


def _bank_rem_np(taps2: np.ndarray, Tr: int, stride: int):
    """Bank for the remainder frame: (width_r, Tr*O) over the last
    (Tr-1)*stride + n input samples."""
    n, O = taps2.shape
    wr = (Tr - 1) * stride + n
    H = np.zeros((wr, Tr * O), taps2.dtype)
    for p in range(Tr):
        H[p * stride : p * stride + n, p * O : (p + 1) * O] = taps2
    return H


def _banks_traced(taps2: jnp.ndarray, P: int, stride: int, width: int):
    """Traced-taps fallback: the bank is built on device from P shifted
    zero-pads (bloats the jaxpr — pass concrete numpy taps where possible,
    e.g. as jit closure constants, to get compile-time-constant banks)."""
    n, O = taps2.shape
    cols = [jnp.pad(taps2, ((p * stride, width - n - p * stride), (0, 0)))
            for p in range(P)]
    return jnp.stack(cols, axis=1).reshape(width, P * O)


def _toep_real(xb: jnp.ndarray, taps2, P: int, stride: int, T: int,
               prec) -> jnp.ndarray:
    """Real banded-Toeplitz core: xb (B, L) real, taps2 (n, O) real.

    Returns y (B, T, O) with y[b, t, o] = sum_i taps2[i, o] * xb[b, t*stride+i].

    Zero-copy framing: bodies are a contiguous reshape of xb (XLA fuses the
    slice+reshape into the dot operand — no (T, width) window matrix is ever
    materialized), heads are one small shifted reshape, and the final
    partial frame is a separate small matmul instead of padding the whole
    block.  FLOPs carry a ((P*stride + n)/n)x redundancy (the dense band),
    bounded by _auto_block; HBM traffic stays O(L).
    """
    n, O = taps2.shape
    B, L = xb.shape
    n1 = n - 1
    hop = P * stride
    concrete = not isinstance(taps2, jax.core.Tracer)
    tn = np.asarray(taps2) if concrete else taps2
    Ff = max((L - n1) // hop, 0) if hop > 0 else 0
    Ff = min(Ff, T // P)                      # never emit more than T
    pieces = []
    if Ff > 0:
        if concrete:
            Hb, Hh = _banks_np(tn, P, stride)
            Hb, Hh = jnp.asarray(Hb), jnp.asarray(Hh)
        else:
            H = _banks_traced(tn, P, stride, hop + n1)
            Hb, Hh = H[:hop], H[hop:]
        bodies = xb[:, : Ff * hop].reshape(B, Ff, hop)
        ym = jax.lax.dot_general(
            bodies, Hb.astype(xb.dtype), (((2,), (0,)), ((), ())),
            precision=prec)
        if n1 > 0:
            if Ff > 1:
                heads = xb[:, hop : Ff * hop].reshape(
                    B, Ff - 1, hop)[..., :n1]
                last = xb[:, Ff * hop : Ff * hop + n1].reshape(B, 1, n1)
                heads = jnp.concatenate([heads, last], axis=1)
            else:
                heads = xb[:, hop : hop + n1].reshape(B, 1, n1)
            ym = ym + jax.lax.dot_general(
                heads, Hh.astype(xb.dtype), (((2,), (0,)), ((), ())),
                precision=prec)
        pieces.append(ym.reshape(B, Ff * P, O))
    Tr = T - Ff * P
    if Tr > 0:
        start = Ff * hop
        wr = (Tr - 1) * stride + n
        if concrete:
            Hr = jnp.asarray(_bank_rem_np(tn, Tr, stride))
        else:
            cols = [jnp.pad(tn, ((p * stride, wr - n - p * stride), (0, 0)))
                    for p in range(Tr)]
            Hr = jnp.stack(cols, axis=1).reshape(wr, Tr * O)
        xr = xb[:, start : start + wr]
        yr = jax.lax.dot_general(
            xr, Hr.astype(xb.dtype), (((1,), (0,)), ((), ())),
            precision=prec)
        pieces.append(yr.reshape(B, Tr, O))
    if len(pieces) == 1:
        return pieces[0]
    return jnp.concatenate(pieces, axis=1)


def fir_toeplitz(x: jnp.ndarray, taps: jnp.ndarray, stride: int = 1,
                 precision=None, block: int | None = None) -> jnp.ndarray:
    """Strided sliding correlation as banded-Toeplitz matmuls.

    Same contract as :func:`conv1d_mxu` (y[..., t(, o)] =
    sum_i taps[i(, o)] * x[..., t*stride + i]), but the compute is plain
    ``dot_general`` over overlap-save frames instead of an XLA
    convolution, so it runs on the backend's GEMM path.

    Complex data/taps decompose into real plane matmuls (complex taps ride
    along as extra bank columns, so the GEMMs only ever see real
    matrices).

    ``block`` = outputs per frame (auto: see :func:`_auto_block`);
    ``precision``: "highest" (default) | "x3" | "default" | XLA values.
    """
    vec = taps.ndim == 1
    taps2 = taps[:, None] if vec else taps
    n, O = taps2.shape
    batch_shape = x.shape[:-1]
    L = x.shape[-1]
    T = (L - n) // stride + 1
    if T <= 0:
        raise ValueError("signal shorter than the filter")
    P = max(min(block, T), -(-max(n - 1, 1) // stride), 1) if block \
        else _auto_block(n, stride, O, T)
    prec = _resolve_precision(precision)
    xb = x.reshape((-1, L))
    B = xb.shape[0]
    cx = jnp.issubdtype(x.dtype, jnp.complexfloating)
    ck = jnp.issubdtype(taps2.dtype, jnp.complexfloating)
    if ck:
        # complex taps: TWO separate real banks (re-taps, im-taps), each
        # run through _toep_real on its own.  A single bank with
        # per-output [re | im] column PAIRS would make extracting the
        # re/im results a minor-axis stride-2 slice.  Two clean banks
        # re-read the input planes once more but keep every output slice
        # contiguous.
        concrete = not isinstance(taps2, jax.core.Tracer)
        if concrete:
            tn = np.asarray(taps2)
            t_re, t_im = tn.real.copy(), tn.imag.copy()
        else:
            t_re, t_im = jnp.real(taps2), jnp.imag(taps2)
    else:
        tr = taps2
    if cx:
        cd = jnp.result_type(x.dtype, taps2.dtype, jnp.complex64)
        xc = xb.astype(cd)
        planes = jnp.concatenate([xc.real, xc.imag], axis=0)  # (2B, L)
        if ck:
            yr = _toep_real(planes, t_re, P, stride, T, prec
                            ).reshape(2, B, T, O)
            yi = _toep_real(planes, t_im, P, stride, T, prec
                            ).reshape(2, B, T, O)
            # (xr + i xi) * (hr + i hi): re = xr*hr - xi*hi, ...
            out = jax.lax.complex(yr[0] - yi[1], yi[0] + yr[1])
        else:
            y = _toep_real(planes, tr, P, stride, T, prec)
            y = y.reshape(2, B, T, O)
            out = jax.lax.complex(y[0], y[1])
        out = out.astype(cd)
    else:
        if ck:
            cd = jnp.result_type(x.dtype, taps2.dtype, jnp.complex64)
            rd = jnp.zeros(0, cd).real.dtype
            xr = xb.astype(rd)
            out = jax.lax.complex(
                _toep_real(xr, t_re, P, stride, T, prec),
                _toep_real(xr, t_im, P, stride, T, prec)).astype(cd)
        else:
            out = _toep_real(xb, tr, P, stride, T, prec)
    out = out.reshape(*batch_shape, T, O)
    return out[..., 0] if vec else out


def _fir_block_matmul(taps: jnp.ndarray, x_ext: jnp.ndarray) -> jnp.ndarray:
    if routing.fir_uses_toeplitz():
        return fir_toeplitz(x_ext, taps)
    return conv1d_mxu(x_ext, taps)


def _fir_tile_nfft(ntaps: int, ext_len: int) -> int:
    """Fixed-tile FFT size for segmented overlap-save: the smallest pow2
    covering 4x the kernel (75% useful output per tile), at least 512 for
    FFT efficiency, never larger than the whole extended block."""
    whole = 1 << int(np.ceil(np.log2(max(ext_len, 2))))
    tile = max(512, 1 << int(np.ceil(np.log2(max(4 * ntaps, 2)))))
    return min(whole, tile)


def _fir_block_fft(taps: jnp.ndarray, x_ext: jnp.ndarray) -> jnp.ndarray:
    """Segmented overlap-save convolution (batched tile FFTs).

    One whole-block FFT with nfft = next-pow2 of the extended block would
    waste up to 2x in zero-padding and hold a full-size complex
    intermediate.  Here the block is split into fixed pow2 tiles of
    ``nfft`` with ``ntaps-1`` overlap; frames are built from pure
    reshape/concat (no gathers) and the pow2 tile FFTs run as one
    batched FFT.
    """
    n = taps.shape[-1]
    ext = x_ext.shape[-1]
    L = ext - (n - 1)
    nfft = _fir_tile_nfft(int(n), int(ext))
    S = nfft - (n - 1)          # valid outputs per tile
    F = -(-L // S)              # number of tiles
    batch = x_ext.shape[:-1]

    pad = F * S + (n - 1) - ext
    xp = jnp.pad(x_ext, [(0, 0)] * len(batch) + [(0, pad)])
    # frame f covers xp[f*S : f*S + nfft] = body_f (S) + head of body_{f+1}
    bodies = xp[..., : F * S].reshape(*batch, F, S)
    if n > 1:
        if F > 1:
            heads = xp[..., S : S + (F - 1) * S].reshape(
                *batch, F - 1, S)[..., : n - 1]
            last = xp[..., F * S : F * S + (n - 1)].reshape(
                *batch, 1, n - 1)
            heads = jnp.concatenate([heads, last], axis=-2)
        else:
            heads = xp[..., S : S + (n - 1)].reshape(*batch, 1, n - 1)
        frames = jnp.concatenate([bodies, heads], axis=-1)  # (..., F, nfft)
    else:
        frames = bodies
    kernel = jnp.flip(taps, axis=-1)
    cdtype = jnp.result_type(x_ext.dtype, kernel.dtype, jnp.complex64)
    X = jnp.fft.fft(frames.astype(cdtype), n=nfft, axis=-1)
    H = jnp.fft.fft(kernel.astype(cdtype), n=nfft, axis=-1)
    y_full = jnp.fft.ifft(X * H, axis=-1)
    y = y_full[..., n - 1 :].reshape(*batch, F * S)[..., :L]
    if not jnp.issubdtype(x_ext.dtype, jnp.complexfloating) and not jnp.issubdtype(
        taps.dtype, jnp.complexfloating
    ):
        y = y.real.astype(x_ext.dtype)
    return y


def _pick_method(method: str, ntaps: int, block: int) -> str:
    """Resolve "auto" to matmul / fft by the classic O(ntaps)-vs-
    O(log block) crossover."""
    if method != "auto":
        return method
    return "fft" if ntaps > 2 * int(np.log2(max(block, 2))) + 8 else "matmul"


@partial(jax.jit, static_argnames=("method",))
def _fir_apply_jit(taps, tail, x, scale, method):
    x_ext = extend_with_tail(tail, x)
    if method == "fft":
        y = _fir_block_fft(taps, x_ext)
    else:
        y = _fir_block_matmul(taps, x_ext)
    new_tail = split_tail(x_ext, taps.shape[-1] - 1)
    return y * scale, new_tail


_METHOD_CACHE: dict = {}


def _measured_method(taps, tail, x, scale) -> str:
    """FFTW-MEASURE-style autotune: time both methods once per
    (ntaps, block, dtype, backend) and cache the winner."""
    import time

    key = (int(taps.shape[-1]), int(x.shape[-1]), str(x.dtype),
           jax.default_backend())
    m = _METHOD_CACHE.get(key)
    if m is None:
        results = {}
        for cand in ("matmul", "fft"):
            y, _ = _fir_apply_jit(taps, tail, x, scale, cand)
            jax.block_until_ready(y)
            t0 = time.perf_counter()
            for _ in range(3):
                y, _ = _fir_apply_jit(taps, tail, x, scale, cand)
            jax.block_until_ready(y)
            results[cand] = time.perf_counter() - t0
        m = min(results, key=results.get)
        _METHOD_CACHE[key] = m
    return m


def fir_apply(taps, tail, x, scale=1.0, method: str = "auto"):
    """One FIR block: returns (y, new_tail).

    y[t] = scale * sum_i taps[i] * x_ext[t+i] — reference
    FIRFilter::execute semantics (fir/mod.rs:208-212) vectorized per block.
    method: "auto" | "matmul" | "fft" | "measure" (time both, cache).
    """
    taps = jnp.asarray(taps)
    x = jnp.asarray(x)
    scale = jnp.asarray(scale)
    m = _pick_method(method, int(taps.shape[-1]), int(x.shape[-1]))
    if m == "measure":
        if isinstance(x, jax.core.Tracer):  # cannot time under trace
            m = "matmul"
        else:
            m = _measured_method(taps, tail, x, scale)
    return _fir_apply_jit(taps, tail, x, scale, m)


@partial(jax.jit, static_argnames=("decimation", "precision"))
def fir_decim_apply(taps, tail, phase, x, scale, decimation: int,
                    precision: str | None = None):
    """Decimating FIR block; block length must be a multiple of ``decimation``.

    Matches the reference counter semantics (fir/decim.rs:221-228): the
    counter increments on each push, and an output is emitted when
    (phase + n + 1) % M == 0 for the n-th sample of the block.
    Returns (y, new_tail, new_phase) with len(y) = len(x) // M.
    ``precision``: see conv1d_mxu (None = full accuracy).
    """
    L = x.shape[-1]
    M = decimation
    if L % M != 0:
        raise ValueError("block length must be a multiple of the decimation")
    x_ext = extend_with_tail(tail, x)
    n = taps.shape[-1]
    # first output position within the block
    first = (M - 1 - phase) % M
    T = L // M
    # slice off the phase offset, then one strided conv — the window
    # matrix is never materialized (HBM traffic O(L), not O(L * n)).
    x_sub = jax.lax.dynamic_slice_in_dim(
        x_ext, first, (T - 1) * M + n, axis=x_ext.ndim - 1
    )
    if routing.fir_uses_toeplitz():
        y = fir_toeplitz(x_sub, taps, stride=M, precision=precision) * scale
    else:
        y = conv1d_mxu(x_sub, taps, stride=M, precision=precision) * scale
    new_tail = split_tail(x_ext, n - 1)
    new_phase = (phase + L) % M
    return y, new_tail, new_phase


def pfb_branch_matrix(coefficients, branches: int) -> jnp.ndarray:
    """(sub_len, branches) matrix B with B[m, f] = c[f + m*branches].

    This is the reference's PFB decomposition (fir/pfb.rs:24-49) expressed so
    a window-matmul computes every branch at once.
    """
    c = np.asarray(coefficients)
    sub_len = len(c) // branches
    return jnp.asarray(c[: sub_len * branches].reshape(sub_len, branches))


@jax.jit
def pfb_apply_all(branch_matrix, tail, x):
    """Run all branches for each input sample.

    Returns (out, new_tail) with out shape (..., T, branches):
    out[t, f] = sum_m B[m, f] * x_ext[t + m] — identical per-branch values to
    the reference's PolyPhaseFilterBank::execute (pfb.rs:85-91).
    """
    sub_len = branch_matrix.shape[0]
    x_ext = extend_with_tail(tail, x)
    if routing.fir_uses_toeplitz():
        out = fir_toeplitz(x_ext, branch_matrix)  # (..., T, branches)
    else:
        out = conv1d_mxu(x_ext, branch_matrix)  # (..., T, branches)
    return out, split_tail(x_ext, sub_len - 1)


def fir_interp_apply(branch_matrix, tail, x, scale=1.0):
    """Interpolating FIR block (zero-stuffing polyphase).

    Parity: ref fir/interp.rs:93-100 — each input sample emits the P branch
    outputs in branch order.  Returns (y, new_tail) with len(y) = P * len(x).
    Note: like the reference PFB (whose stored scale is never applied,
    pfb.rs:85-91), the default scale is 1.
    """
    out, new_tail = pfb_apply_all(branch_matrix, tail, x)
    y = out.reshape(*out.shape[:-2], out.shape[-2] * out.shape[-1])
    return y * scale, new_tail


# --------------------------------------------------------------------------
# stateful wrappers (reference-like API)
# --------------------------------------------------------------------------

class FIRFilter:
    """Streaming FIR filter with the reference's API shape.

    Parity: ref src/filter/fir/mod.rs.  ``coefficients()`` returns the
    REVERSED tap order, matching the reference quirk that it reports the
    DotProduct's reversed storage; frequency_response/group_delay therefore
    also match the reference's values.
    """

    def __init__(self, coefficients, scale=1.0, dtype=None, method: str = "auto"):
        c = np.asarray(coefficients)
        if c.size == 0:
            raise ValueError("coefficients length zero")
        self._taps = jnp.asarray(c, dtype=dtype)
        self.scale = scale
        self.method = method
        self._tail = fir_init(len(c), dtype=self._taps.dtype)

    # reference-parity introspection
    def __len__(self) -> int:
        return int(self._taps.shape[-1])

    def is_empty(self) -> bool:
        return len(self) == 0

    def coefficients(self) -> np.ndarray:
        return np.asarray(self._taps)[::-1]

    def set_scale(self, scale) -> None:
        self.scale = scale

    def get_scale(self):
        return self.scale

    # Firdes trait parity (ref firdes/filter_traits.rs:4-39): analysis
    # metrics bolted onto the filter object, applied to coefficients() —
    # i.e. the REVERSED storage order, exactly like the reference.
    def autocorrelation(self, lag: int) -> float:
        from ..design import firdes

        return firdes.filter_autocorrelation(self.coefficients(), lag)

    def crosscorrelation(self, rhs: "FIRFilter", lag: int) -> float:
        from ..design import firdes

        return firdes.filter_crosscorrelation(
            self.coefficients(), rhs.coefficients(), lag)

    def isi(self, samples_per_symbol: int, delay: int) -> tuple:
        from ..design import firdes

        return firdes.filter_isi(self.coefficients(), samples_per_symbol,
                                 delay)

    def energy(self, cutoff_frequency: float, fft_size: int) -> float:
        from ..design import firdes

        try:
            return firdes.filter_energy(self.coefficients(),
                                        cutoff_frequency, fft_size)
        except ValueError:
            # parity: the reference swallows the error and returns 0.0
            # (filter_traits.rs:29-37)
            return 0.0

    def reset(self) -> None:
        self._tail = fir_init(len(self), dtype=self._taps.dtype)

    @property
    def state(self):
        return self._tail

    @state.setter
    def state(self, tail):
        self._tail = tail

    def execute(self, sample):
        return self.execute_block(jnp.asarray([sample]))

    def execute_block(self, samples):
        samples = ingest(samples)
        if not jnp.issubdtype(self._tail.dtype, samples.dtype):
            self._tail = astype_device(
                self._tail,
                jnp.result_type(self._tail.dtype, samples.dtype))
        y, self._tail = fir_apply(
            self._taps, self._tail, samples, self.scale, self.method
        )
        return y

    def frequency_response(self, frequency: float) -> complex:
        return fir_frequency_response(self.coefficients(), frequency, self.scale)

    def group_delay(self, frequency: float) -> float:
        return fir_group_delay(self.coefficients(), frequency)

    def __repr__(self) -> str:
        return (
            f"FIR<{self._taps.dtype}> [Scale={self.scale:.5f}] "
            f"[Coefficients=DotProduct [Size={len(self)}]]"
        )


class DecimatingFIRFilter(FIRFilter):
    """FIR that emits 1 of every ``decimation`` outputs.

    Parity: ref src/filter/fir/decim.rs (counter at :116, emit at :221-228).
    """

    def __init__(self, coefficients, scale=1.0, decimation: int = 1, dtype=None):
        if decimation < 1:
            raise ValueError("decimation less than one")
        super().__init__(coefficients, scale, dtype)
        self.decimation = int(decimation)
        self._phase = jnp.asarray(0, dtype=jnp.int32)

    def get_decimation(self) -> int:
        return self.decimation

    def execute(self, sample):
        """Per-sample API (ref decim.rs:221-228): push one sample, emit the
        filtered value on every ``decimation``-th push, else an empty block.

        Like the reference, the dot product only runs on the emitting push;
        the other M-1 pushes just advance the carried tail.
        """
        x = jnp.asarray([sample])
        if not jnp.issubdtype(self._tail.dtype, x.dtype):
            self._tail = self._tail.astype(
                jnp.result_type(self._tail.dtype, x.dtype)
            )
        phase = int(self._phase)
        emit = (phase + 1) % self.decimation == 0
        if emit:
            y, self._tail = fir_apply(self._taps, self._tail, x, self.scale,
                                      method="matmul")
        else:
            self._tail = jnp.concatenate([self._tail, x], axis=-1)[..., 1:]
            y = x[:0]
        self._phase = jnp.asarray((phase + 1) % self.decimation,
                                  dtype=jnp.int32)
        return y

    def execute_block(self, samples):
        samples = jnp.asarray(samples)
        if not jnp.issubdtype(self._tail.dtype, samples.dtype):
            self._tail = self._tail.astype(
                jnp.result_type(self._tail.dtype, samples.dtype)
            )
        L = int(samples.shape[-1])
        M = self.decimation
        if L % M:
            raise ValueError(
                "block length must be a multiple of the decimation; "
                "use streaming.ring.CircularBuffer to stage ragged blocks"
            )
        y, self._tail, self._phase = fir_decim_apply(
            self._taps, self._tail, self._phase, samples,
            jnp.asarray(self.scale), M,
        )
        return y


class PolyPhaseFilterBank:
    """Polyphase filter bank over a shared input window.

    Parity: ref src/filter/fir/pfb.rs:3-91.  ``execute(i)`` gives one branch;
    ``execute_all`` gives every branch per input sample as one matmul.
    """

    def __init__(self, coefficients, filters: int, scale=1.0, dtype=None):
        if filters == 0:
            raise ValueError("not enough filters")
        c = np.asarray(coefficients)
        if c.size == 0:
            raise ValueError("coefficients length zero")
        self.branches = int(filters)
        self._B = pfb_branch_matrix(c, filters)
        if dtype is not None:
            self._B = self._B.astype(dtype)
        self.scale = scale  # stored but (like the reference) not applied
        self.sub_len = int(self._B.shape[0])
        self._tail = zeros_device(self.sub_len - 1, self._B.dtype)
        self._win = None

    def __len__(self) -> int:
        return self.branches

    def is_empty(self) -> bool:
        return self.branches == 0

    def set_scale(self, scale) -> None:
        self.scale = scale

    def get_scale(self):
        return self.scale

    def coefficients(self) -> list[np.ndarray]:
        """Per-branch coefficients in the reference's stored (reversed) order."""
        B = np.asarray(self._B)
        return [B[::-1, f] for f in range(self.branches)]

    def reset(self) -> None:
        self._tail = zeros_device(self.sub_len - 1, self._B.dtype)
        self._win = None

    def push(self, sample) -> None:
        """Per-sample push into the shared window (ref pfb.rs:81-83)."""
        s = jnp.asarray([sample])
        if not jnp.issubdtype(self._tail.dtype, s.dtype):
            self._tail = self._tail.astype(
                jnp.result_type(self._tail.dtype, s.dtype)
            )
        win = jnp.concatenate([self._tail, s])
        self._tail = win[1:] if self.sub_len > 1 else self._tail
        self._win = win

    def execute(self, index: int):
        """One branch's output for the current window (ref pfb.rs:85-91)."""
        if not 0 <= index < self.branches:
            raise ValueError("filter index out of range")
        if self._win is None:  # nothing pushed yet: zeroed window (ref init)
            self._win = zeros_device(self.sub_len, self._B.dtype)
        return jnp.sum(self._B[:, index].astype(self._win.dtype) * self._win)

    def execute_all(self):
        """Every branch's output for the current window — one matvec."""
        if self._win is None:
            self._win = zeros_device(self.sub_len, self._B.dtype)
        return jnp.matmul(self._win, self._B.astype(self._win.dtype),
                          precision="highest")

    def push_block(self, samples):
        samples = jnp.asarray(samples)
        x_pre = jnp.concatenate(
            [self._tail.astype(jnp.result_type(self._tail.dtype,
                                               samples.dtype)), samples],
            axis=-1,
        )
        out, self._tail = pfb_apply_all(
            self._B, x_pre[..., : self.sub_len - 1] if self.sub_len > 1
            else x_pre[..., :0],
            samples,
        )
        # keep the per-sample window view consistent with the block push
        self._win = x_pre[..., -self.sub_len:]
        return out  # (T, branches)


class InterpolatingFIRFilter:
    """Zero-stuffing interpolator on the polyphase bank.

    Parity: ref src/filter/fir/interp.rs:27-100 (taps padded to
    ceil(N/P)*P, one input -> P branch outputs).

    NOTE (reference quirk, reproduced): the branch sub-filters apply their
    coefficients time-REVERSED (the reference stores each PFB branch with
    Direction::REVERSE, pfb.rs:34-42), so the output is NOT the ideal
    zero-stuffed convolution when the padded prototype is asymmetric — the
    pulse acquires a branch-dependent fractional shift.  For an ideal
    interpolator build the zero-stuffed stream explicitly and filter with
    ``conv1d_mxu`` (see models/timing.py tests).
    """

    def __init__(self, coefficients, interpolation: int, dtype=None):
        c = np.asarray(coefficients)
        if c.size == 0:
            raise ValueError("coefficients length zero")
        if interpolation < 1:
            raise ValueError("interpolation less than one")
        self.interpolation = int(interpolation)
        sub_len = -(-len(c) // self.interpolation)  # ceil
        eff = np.zeros(sub_len * self.interpolation, dtype=c.dtype)
        eff[: len(c)] = c
        self._eff = eff
        self._B = pfb_branch_matrix(eff, self.interpolation)
        if dtype is not None:
            self._B = self._B.astype(dtype)
        self.scale = 1.0
        self._tail = zeros_device(self._B.shape[0] - 1, self._B.dtype)

    def __len__(self) -> int:
        return self.interpolation

    def coefficients(self) -> np.ndarray:
        """Flattened per-branch (reversed) coefficients, reference order."""
        B = np.asarray(self._B)
        return np.concatenate([B[::-1, f] for f in range(self.interpolation)])

    def set_scale(self, scale) -> None:
        self.scale = scale

    def get_scale(self):
        return self.scale

    @property
    def state(self):
        return self._tail

    def execute(self, sample):
        return self.execute_block(jnp.asarray([sample]))

    def execute_block(self, samples):
        samples = jnp.asarray(samples)
        if not jnp.issubdtype(self._tail.dtype, samples.dtype):
            self._tail = self._tail.astype(
                jnp.result_type(self._tail.dtype, samples.dtype)
            )
        y, self._tail = fir_interp_apply(self._B, self._tail, samples)
        return y

    def frequency_response(self, frequency: float) -> complex:
        return fir_frequency_response(self.coefficients(), frequency, self.scale)

    def group_delay(self, frequency: float) -> float:
        return fir_group_delay(self.coefficients(), frequency)


class RationalResampler:
    """P/Q rational resampler: polyphase interpolation by P, decimation by Q.

    The reference has no rational resampler (only separate interp/decim
    filters); this composes them without a selection gather.  Running
    the full (T, P) branch matmul then a stride-Q ``jnp.take`` would
    compute P/Q of the branch outputs only to drop them.  Here the commutator
    is folded into the bank at design time: outputs repeat with period
    P0 = P/gcd(P,Q) in branch index while the input base advances by
    Q0 = Q/gcd(P,Q), so with

        u_r = first + r*Q,  f_r = u_r mod P,  d_r = u_r div P
        H[d_r + m, r] = B[m, f_r]                    (r < P0, m < sub_len)

    the whole resampler is ONE stride-Q0 multi-output banded-Toeplitz
    matmul ``y[j, r] = sum_i H[i, r] x_ext[j*Q0 + i]`` (fir_toeplitz) —
    gather-free, no dropped work, identical values to the
    interp-then-select composition (pinned by tests/test_snr_configs.py
    against the zero-stuff+convolve model).  Ref anchors:
    src/filter/fir/interp.rs:27-54 + decim.rs:27-42 (the two halves of
    the ratio this fuses).
    """

    def __init__(self, coefficients, interp: int, decim: int, dtype=None):
        if interp < 1 or decim < 1:
            raise ValueError("interp and decim must be >= 1")
        self.P = int(interp)
        self.Q = int(decim)
        self._interp = InterpolatingFIRFilter(coefficients, self.P, dtype=dtype)
        self._phase = 0  # position within the zero-stuffed stream mod Q
        # host-side branch matrix (the padded prototype, quirky branch
        # order preserved): B[m, f] = eff[f + m*P]
        eff = np.asarray(self._interp._eff)
        if dtype is not None and np.issubdtype(np.dtype(dtype), np.floating):
            eff = eff.astype(np.dtype(dtype))
        self._B_np = eff.reshape(-1, self.P)
        self._fns: dict = {}

    def _make_fn(self, first: int):
        """Jitted one-dispatch block fn for a given commutator phase."""
        from math import gcd

        P, Q = self.P, self.Q
        g = gcd(P, Q)
        P0, Q0 = P // g, Q // g
        B = self._B_np
        sub = B.shape[0]
        us = first + np.arange(P0) * Q
        fs = us % P
        ds = us // P
        width = int(ds.max()) + sub
        H = np.zeros((width, P0), B.dtype)
        for r in range(P0):
            H[ds[r]: ds[r] + sub, r] = B[:, fs[r]]

        def fn(tail, x):
            L = int(x.shape[-1])
            x_ext = jnp.concatenate([tail, x], axis=-1)
            new_tail = (x_ext[..., x_ext.shape[-1] - (sub - 1):] if sub > 1
                        else x[..., :0])
            n_up = L * P
            n_out = (n_up - 1 - first) // Q + 1 if n_up > first else 0
            if n_out <= 0:
                return x[..., :0], new_tail
            F_tot = -(-n_out // P0)
            need = (F_tot - 1) * Q0 + width
            ext_len = int(x_ext.shape[-1])
            if need > ext_len:
                z = jnp.zeros((*x_ext.shape[:-1], need - ext_len), x_ext.dtype)
                x_in = jnp.concatenate([x_ext, z], axis=-1)
            else:
                x_in = x_ext[..., :need]
            out = fir_toeplitz(x_in, jnp.asarray(H), stride=Q0)  # (.., F, P0)
            y = out.reshape(*out.shape[:-2], F_tot * P0)[..., :n_out]
            return y, new_tail

        return jax.jit(fn)

    def execute_block(self, samples):
        x = jnp.asarray(samples)
        it = self._interp
        if not jnp.issubdtype(it._tail.dtype, x.dtype):
            it._tail = it._tail.astype(
                jnp.result_type(it._tail.dtype, x.dtype))
        first = (self.Q - self._phase) % self.Q
        fn = self._fns.get(first)
        if fn is None:
            fn = self._fns[first] = self._make_fn(first)
        y, it._tail = fn(it._tail, x)
        self._phase = (self._phase + int(x.shape[-1]) * self.P) % self.Q
        return y
