"""Fused digital down-converter: NCO mix + decimating FIR as one matmul pass.

The reference chain idiom (src/main.rs:25-46 builds NCO -> filter; the
driver's config-4 chain is NCO mix -> 64-tap decimating FIR -> AGC -> FM)
runs the oscillator at the FULL input rate: every sample pays a sin/cos
(or LUT lookup) plus a complex multiply before the filter discards
(M-1)/M of the results.

The whole front end folds into the filter (the classic one-stage DDC
identity).  With u32 phase words theta(k) = theta0 + k*dtheta
(nco/mod.rs:93-96) and decimation M:

    y[t] = sum_i h[i] * x[s + tM + i] * e^{-j theta(s + tM + i)}
         = e^{-j theta(s + tM)} * sum_i (h[i] e^{-j i*drad}) * x[s + tM + i]

(s = the decimator's first-output offset, drad = dtheta * 2pi / 2^32).
So the mix at the input rate becomes

  * a complex BANDPASS tap set  h_bp[i] = h[i] * e^{-j i*drad}   (design
    time, exact in f64 — u32 phase increments are exact integers), and
  * ONE post-rotation at the DECIMATED rate, whose phase words
    w_t = theta(s + tM) use the same wrapping u32 arithmetic as the NCO,
    so phase continuity across blocks is bit-exact with the unfused chain.

The filter itself runs as banded-Toeplitz real matmuls on raw input
PLANES (re/im as two rows), framed zero-copy exactly like
ops.fir._toep_real: bodies are a contiguous reshape fused into the dot,
the first Th outputs (which straddle the carried tail) and the last
partial frame are two small side matmuls.  Nothing at the input rate is
ever materialized beyond the input itself.

Accuracy: identical math to nco_mode="exact" + fir_decim_apply modulo
float reordering; the parity test gates >= 100 dB against the unfused
chain (tests/test_ddc.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .fir import _bank_rem_np, _banks_np, _resolve_precision
from .nco import _U32, _TWO_PI, nco_complex_exponential

__all__ = ["ddc_taps", "ddc_apply_planar", "ddc_apply",
           "ddc_apply_planar_raw", "ddc_apply_planar_pieces",
           "ddc_fm_epilogue", "ddc_am_epilogue",
           "ddc_fm_epilogue_pieces", "ddc_am_epilogue_pieces",
           "ddc_energy_pieces", "ddc_pieces_last_rotated"]


def ddc_taps(taps: np.ndarray, dtheta: np.uint32) -> np.ndarray:
    """Bandpass tap set h[i] * e^{-j i * dtheta_rad} (complex128 host)."""
    taps = np.asarray(taps)
    drad = np.float64(dtheta) * (_TWO_PI / float(_U32))
    i = np.arange(len(taps), dtype=np.float64)
    return np.asarray(taps, np.complex128) * np.exp(-1j * drad * i)


def _fold_banks(Hr: np.ndarray, Hi: np.ndarray, bank_dt) -> np.ndarray:
    """Fold the complex-tap plane algebra into one rhs (2, W, 2K).

    Column layout is [re-block | im-block] (NOT per-output interleaving,
    which would make the complex combine a stride-2 slice over millions
    of outputs).  With lhs planes (2, ..., W) contracted over (plane, W):

        out[..., :K] = xr@Hr - xi@Hi = Re(y),
        out[..., K:] = xr@Hi + xi@Hr = Im(y),

    so the complex combine is two contiguous block slices — free.
    """
    W, K = Hr.shape
    H = np.zeros((2, W, 2 * K), bank_dt)
    H[0, :, :K] = Hr
    H[0, :, K:] = Hi
    H[1, :, :K] = -Hi
    H[1, :, K:] = Hr
    return H


def _plane_dot(lhs: jnp.ndarray, bank: np.ndarray, rdtype, prec):
    """lhs (2, ..., W) x folded bank (2, W, 2K) -> (..., 2K), contracting
    the plane dim and W together."""
    H = jnp.asarray(bank).astype(rdtype)
    nd = lhs.ndim
    return jax.lax.dot_general(
        lhs, H, (((0, nd - 1), (0, 1)), ((), ())), precision=prec)


def ddc_apply_planar_pieces(taps, dtheta, tail2, theta0, x2, decimation: int,
                            precision="highest", block: int | None = None):
    """UNROTATED fused-DDC body, returned in its NATIVE piece layouts.

    The body computes the decimated outputs in up to three pieces (tail-
    straddling head, Toeplitz frames, straggler) whose natural layouts
    differ; flattening them into one (T,) array costs a full concatenate
    copy at the decimated rate.  This entry point skips that: it returns

        (pieces, new_tail2, theta_end, w0, dw)

    where each piece is ("flat", re_1d, im_1d) or ("cols", y2d, P) —
    y2d of shape (F, 2P) holding [re-block | im-block] columns, output
    index t running row-major over (F, P).  Piece order IS output order.
    The true DDC output is y[t] = z[t] * e^{-j rad(w_t)} with z the raw
    piece values and w_t = w0 + t*dw in wrapping u32 phase words.

    Epilogues that are rotation-invariant (FM discriminator, AM envelope)
    consume the pieces directly — see ddc_fm_epilogue_pieces /
    ddc_am_epilogue_pieces; flat-output callers use ddc_apply_planar_raw.
    """
    taps = np.asarray(taps)
    n = len(taps)
    n1 = n - 1
    M = int(decimation)
    L = int(x2.shape[-1])
    if L % M:
        raise ValueError("block length must be a multiple of the decimation")
    T = L // M
    first = M - 1                       # decimator phase 0 (ref decim.rs:221)
    h_bp = ddc_taps(taps, np.uint32(dtheta))
    rdtype = x2.dtype
    bank_dt = np.float64 if rdtype == jnp.float64 else np.float32
    hr2 = h_bp.real.astype(bank_dt)[:, None]      # (n, 1)
    hi2 = h_bp.imag.astype(bank_dt)[:, None]
    prec = _resolve_precision(precision)

    def rem_bank(Tr):
        return _fold_banks(_bank_rem_np(hr2, Tr, M),
                           _bank_rem_np(hi2, Tr, M), bank_dt)

    # ---- piece 1: head outputs that straddle the carried tail ----------
    Th = min(max(-(-(n1 - first) // M), 0), T)
    pieces = []
    if Th > 0:
        head_w = (Th - 1) * M + n
        from_x = head_w - (n1 - first)
        zhead = jnp.concatenate([tail2[:, first:], x2[:, :from_x]], axis=1)
        yh = _plane_dot(zhead, rem_bank(Th), rdtype, prec)   # (2*Th,)
        pieces.append(("flat", yh[:Th], yh[Th:]))
    # ---- piece 2: banded-Toeplitz body frames, aligned to x -----------
    start = first + Th * M - n1         # in [0, M)
    Tb = T - Th
    if block:
        P = max(min(int(block), max(Tb, 1)), max(-(-n1 // M), 1))
    else:
        P = max(min(max(128 // 2, 8), max((4 * n) // M, 8), max(Tb, 1)),
                max(-(-n1 // M), 1))
    hop = P * M
    Fb = 0
    if Tb > 0:
        Fb = min(max((L - start - n1) // hop, 0), Tb // P)
    if Fb > 0:
        Hb_r, Hh_r = _banks_np(hr2, P, M)
        Hb_i, Hh_i = _banks_np(hi2, P, M)
        bodies = x2[:, start : start + Fb * hop].reshape(2, Fb, hop)
        yb = _plane_dot(bodies, _fold_banks(Hb_r, Hb_i, bank_dt),
                        rdtype, prec)                        # (Fb, 2P)
        if n1 > 0:
            s1 = start + hop
            if Fb > 1:
                heads = x2[:, s1 : s1 + (Fb - 1) * hop].reshape(
                    2, Fb - 1, hop)[..., :n1]
                sl = start + Fb * hop
                last = x2[:, sl : sl + n1].reshape(2, 1, n1)
                heads = jnp.concatenate([heads, last], axis=1)
            else:
                heads = x2[:, s1 : s1 + n1].reshape(2, 1, n1)
            yb = yb + _plane_dot(heads, _fold_banks(Hh_r, Hh_i, bank_dt),
                                 rdtype, prec)
        pieces.append(("cols", yb.astype(rdtype), P))
    # ---- piece 3: straggler outputs past the last full frame -----------
    Trem = Tb - Fb * P
    if Trem > 0:
        srem = start + Fb * hop
        wr = (Trem - 1) * M + n
        zrem = x2[:, srem : srem + wr]
        yr = _plane_dot(zrem, rem_bank(Trem), rdtype, prec)  # (2*Trem,)
        pieces.append(("flat", yr[:Trem], yr[Trem:]))

    # rotation phase words: w_t = theta0 + (first - n1 + t*M) * dtheta,
    # all u32 wrapping
    d = int(np.uint32(dtheta))
    w0 = (jnp.uint32(theta0)
          + jnp.uint32((first * d) & 0xFFFFFFFF)
          - jnp.uint32((n1 * d) & 0xFFFFFFFF))
    dw = np.uint32((M * d) & 0xFFFFFFFF)

    if n1 == 0:
        new_tail2 = tail2[:, :0]
    elif L >= n1:
        new_tail2 = x2[:, L - n1 :]
    else:  # short block: the new tail keeps part of the old one
        new_tail2 = jnp.concatenate([tail2[:, L:], x2], axis=1)
    theta_end = jnp.uint32(theta0) + jnp.uint32((L * d) & 0xFFFFFFFF)
    return pieces, new_tail2, theta_end, w0, dw


def _pieces_flatten(pieces):
    """Concatenate tagged pieces into flat (yre, yim) 1-D planes."""
    res, ims = [], []
    for p in pieces:
        if p[0] == "flat":
            res.append(p[1])
            ims.append(p[2])
        else:
            y2d, P = p[1], p[2]
            res.append(y2d[:, :P].reshape(-1))
            ims.append(y2d[:, P:].reshape(-1))
    yre = res[0] if len(res) == 1 else jnp.concatenate(res)
    yim = ims[0] if len(ims) == 1 else jnp.concatenate(ims)
    return yre, yim


def ddc_apply_planar_raw(taps, dtheta, tail2, theta0, x2, decimation: int,
                         precision="highest", block: int | None = None):
    """UNROTATED fused-DDC body on input planes, flattened.

    Same contract as :func:`ddc_apply_planar` but skips the decimated-rate
    post-rotation: returns (yre, yim, new_tail2, theta_end, w0, dw) where
    the true DDC output is y[t] = (yre[t] + j yim[t]) * e^{-j rad(w_t)},
    w_t = w0 + t*dw in wrapping u32 phase words.  Callers that only need
    rotation-invariant functionals of y should prefer the piece-layout
    entry point (:func:`ddc_apply_planar_pieces`) — it skips this
    function's decimated-rate concatenate.
    """
    pieces, new_tail2, theta_end, w0, dw = ddc_apply_planar_pieces(
        taps, dtheta, tail2, theta0, x2, decimation,
        precision=precision, block=block)
    yre, yim = _pieces_flatten(pieces)
    return yre, yim, new_tail2, theta_end, w0, dw


def ddc_apply_planar(taps, dtheta, tail2, theta0, x2, decimation: int,
                     precision="highest", block: int | None = None,
                     rot_mode: str = "fast"):
    """One fused DDC block on input planes.

    Args:
      taps: CONCRETE real/complex prototype taps (numpy; design-time).
      dtheta: concrete u32 NCO frequency word.
      tail2: carried raw-input tail planes (2, ntaps-1), real dtype.
      theta0: traced u32 phase word of the first sample of this block.
      x2: input planes (2, L) — re/im rows, L % decimation == 0.  ONE
        array, not two: plane slices of a (2, L) array stay fusable views
        (stacking two separate (L,) planes costs a full-block copy).
      decimation: M.
      precision / block: see ops.fir.fir_toeplitz.
      rot_mode: "fast" (factorized oscillator, ~1 ulp) | "exact" | "lut".

    Returns (out_re, out_im, new_tail2, theta_end) where out has length
    L // M and equals mix_down_block + fir_decim_apply of the unfused
    chain (decimator phase 0) to float rounding.
    """
    yre, yim, new_tail2, theta_end, w0, dw = ddc_apply_planar_raw(
        taps, dtheta, tail2, theta0, x2, decimation,
        precision=precision, block=block)
    rdtype = x2.dtype
    T = yre.shape[-1]
    rot = nco_complex_exponential(w0, dw, T, mode=rot_mode)
    c = jnp.real(rot).astype(rdtype)
    s = jnp.imag(rot).astype(rdtype)
    out_re = yre * c + yim * s
    out_im = yim * c - yre * s
    return out_re, out_im, new_tail2, theta_end


def _rot_scalar(w, rdtype):
    """e^{-j rad(w)} for ONE u32 phase word -> (cos, -sin) scalars.

    The phase-word -> radians conversion runs at the OUTPUT precision:
    f32 chains keep the cheap f32 path; f64 (golden/parity) chains must
    not round the seam phase through f32 — shard-boundary discriminator
    samples would pick up ~1e-7 error vs the single-chip chain.
    """
    ph_dt = jnp.float64 if rdtype == jnp.float64 else jnp.float32
    rad = w.astype(ph_dt) * np.dtype(ph_dt).type(_TWO_PI / float(_U32))
    return jnp.cos(rad).astype(rdtype), (-jnp.sin(rad)).astype(rdtype)


def ddc_pieces_last_rotated(pieces, w0, dw, gain):
    """Gained, rotated LAST output of the block from its raw pieces.

    This is the chain's ``fm_prev`` carry — and, under time sharding, the
    seam a shard ships to its RIGHT neighbor (whose first discriminator
    output consumes it).  Identical math to the tail of
    :func:`ddc_fm_epilogue_pieces`.
    """
    rdtype = pieces[0][1].dtype
    T = sum(_piece_len(p) for p in pieces)
    wl = jnp.uint32(w0) + jnp.uint32((int(np.uint32(dw)) * (T - 1))
                                     & 0xFFFFFFFF)
    cl, sl = _rot_scalar(wl, rdtype)
    last_re, last_im = _piece_last(pieces[-1])
    g = jnp.asarray(gain).astype(rdtype)
    return (g * (last_re * cl - last_im * sl),
            g * (last_im * cl + last_re * sl))


def ddc_fm_epilogue(yre, yim, w0, dw, prev_re, prev_im, kf, gain):
    """FM discriminator straight off the UNROTATED DDC body output.

    The post-rotation y[t] = z[t] e^{-j rad(w_t)} and the (real, positive)
    AGC gain g cancel inside the phase-difference discriminator:

        d[t] = (g y[t]) conj(g y[t-1])
             = g^2 z[t] conj(z[t-1]) e^{-j drad},   drad = rad(dw),

    so arg d[t] needs only the raw cross products plus ONE constant
    rotation — no per-sample oscillator, no complex materialization, no
    gain application.  The t=0 term uses the carried previous output
    sample (already rotated and gained by the previous block).

    Args:
      yre, yim: unrotated body output planes (T,) from
        :func:`ddc_apply_planar_raw`.
      w0, dw: its rotation phase words.
      prev_re, prev_im: carried last CHAIN output sample (rotated, gained).
      kf: modulation index; out = arg(d) / (2 pi kf).
      gain: this block's (real, positive) AGC gain — used only to keep the
        carried state bit-compatible with the rotated path.

    Returns (out, new_prev_re, new_prev_im) where out matches
    rotate+AGC+fm_demodulate to float rounding and the new prev pair is
    the gained, rotated last sample (the rotated path's fm_prev state).
    """
    rdtype = yre.dtype
    T = yre.shape[-1]
    # interior cross products on [1:] vs [:-1] views — one fused pass
    ure = yre[1:] * yre[:-1] + yim[1:] * yim[:-1]
    uim = yim[1:] * yre[:-1] - yre[1:] * yim[:-1]
    drad = float(np.float64(np.uint32(dw)) * (_TWO_PI / float(_U32)))
    cd = np.asarray(np.cos(drad)).astype(rdtype)
    sd = np.asarray(-np.sin(drad)).astype(rdtype)   # e^{-j drad}
    dre = ure * cd - uim * sd
    dim = uim * cd + ure * sd
    # t = 0: y[0] conj(prev); y[0] = z[0] e^{-j rad(w0)}
    c0, s0 = _rot_scalar(jnp.uint32(w0), rdtype)
    y0re = yre[0] * c0 - yim[0] * s0
    y0im = yim[0] * c0 + yre[0] * s0
    d0re = y0re * prev_re + y0im * prev_im
    d0im = y0im * prev_re - y0re * prev_im
    out = jnp.concatenate([
        jnp.arctan2(d0im, d0re)[None],
        jnp.arctan2(dim, dre),
    ]) / np.asarray(2.0 * np.pi * kf).astype(rdtype)
    # carried state: gained, rotated last sample (= rotated path's fm_prev)
    wl = jnp.uint32(w0) + jnp.uint32((int(np.uint32(dw)) * (T - 1))
                                     & 0xFFFFFFFF)
    cl, sl = _rot_scalar(wl, rdtype)
    g = gain.astype(rdtype)
    new_prev_re = g * (yre[-1] * cl - yim[-1] * sl)
    new_prev_im = g * (yim[-1] * cl + yre[-1] * sl)
    return out, new_prev_re, new_prev_im


def ddc_am_epilogue(yre, yim, gain):
    """AM envelope off the unrotated body output: |g z e^{-j w}| = g |z|."""
    return gain.astype(yre.dtype) * jnp.sqrt(yre * yre + yim * yim)


def _piece_len(p):
    if p[0] == "flat":
        return int(p[1].shape[-1])
    return int(p[1].shape[0]) * int(p[2])


def _piece_last(p):
    """Last raw output sample of a piece -> (re, im) scalars."""
    if p[0] == "flat":
        return p[1][-1], p[2][-1]
    y2d, P = p[1], p[2]
    return y2d[-1, P - 1], y2d[-1, 2 * P - 1]


def ddc_energy_pieces(pieces):
    """mean |z|^2 over all piece outputs (= mean |y|^2: |rot| = 1)."""
    total = 0.0
    count = 0
    for p in pieces:
        if p[0] == "flat":
            total = total + jnp.sum(p[1] * p[1]) + jnp.sum(p[2] * p[2])
        else:
            y2d = p[1]
            total = total + jnp.sum(y2d * y2d)   # [re | im] cols: both
        count += _piece_len(p)
    return total / count


def ddc_fm_epilogue_pieces(pieces, w0, dw, prev_re, prev_im, kf, gain):
    """FM discriminator straight off the body's NATIVE piece layouts.

    Same math as :func:`ddc_fm_epilogue` (rotation and real positive gain
    cancel in the phase differences; one constant e^{-j rad(dw)} rotation
    remains) but consumes the tagged pieces of
    :func:`ddc_apply_planar_pieces`, so the big Toeplitz-frame piece is
    demodulated in its (F, 2P) layout — no decimated-rate flatten/concat
    of the complex signal ever materializes, only the (T,) f32 audio.

    Pieces chain through RAW seam scalars (the cross product
    z[t] conj(z[t-1]) e^{-j drad} is layout- and piece-independent for
    every t >= 1); only the block's first output uses the carried
    previous CHAIN output (rotated, gained) and the w0 rotation.

    Returns (out, new_prev_re, new_prev_im) matching the rotated path's
    (fm_demodulate after AGC) output and fm_prev state to float rounding.
    """
    rdtype = pieces[0][1].dtype
    T = sum(_piece_len(p) for p in pieces)
    drad = float(np.float64(np.uint32(dw)) * (_TWO_PI / float(_U32)))
    cd = np.asarray(np.cos(drad)).astype(rdtype)
    sd = np.asarray(-np.sin(drad)).astype(rdtype)   # e^{-j drad}
    scale = np.asarray(1.0 / (2.0 * np.pi * kf)).astype(rdtype)

    def disc(are, aim, bre, bim):
        """atan2 of (a conj(b)) e^{-j drad}, scaled."""
        ure = are * bre + aim * bim
        uim = aim * bre - are * bim
        return jnp.arctan2(uim * cd + ure * sd,
                           ure * cd - uim * sd) * scale

    audios = []
    seam = None                       # raw z of the previous output
    for p in pieces:
        if p[0] == "flat":
            re, im = p[1], p[2]
            if seam is None:
                # first output of the block: vs fm_prev (rotated, gained)
                c0, s0 = _rot_scalar(jnp.uint32(w0), rdtype)
                y0re = re[0] * c0 - im[0] * s0
                y0im = im[0] * c0 + re[0] * s0
                d0 = jnp.arctan2(y0im * prev_re - y0re * prev_im,
                                 y0re * prev_re + y0im * prev_im) * scale
                audios.append(d0[None])
                if re.shape[-1] > 1:
                    audios.append(disc(re[1:], im[1:], re[:-1], im[:-1]))
            else:
                pre = jnp.concatenate([seam[0][None], re[:-1]])
                pim = jnp.concatenate([seam[1][None], im[:-1]])
                audios.append(disc(re, im, pre, pim))
        else:
            # cols piece: ONE fused elementwise pass.  Rolls + masked
            # selects fuse with the cross products and atan2 into a
            # single XLA kernel, where concat-built neighbour arrays
            # would materialize decimated-rate copies.
            y2d, P = p[1], p[2]
            zre, zim = y2d[:, :P], y2d[:, P:]
            F = zre.shape[0]
            if seam is None:
                # leading piece: inject the carried prev (rotated, gained)
                # PRE-rotated by e^{+j rad(w0 - dw)} so the uniform
                # formula atan2((z conj(q)) e^{-j drad}) yields the exact
                # first output atan2((z0 e^{-j w0}) conj(prev))
                v = jnp.uint32(w0) - jnp.uint32(dw)
                cv, msv = _rot_scalar(v, rdtype)   # (cos, -sin) of e^{-j}
                sv = -msv                          # e^{+j rad(v)}
                s_re = prev_re * cv - prev_im * sv
                s_im = prev_re * sv + prev_im * cv
            else:
                s_re, s_im = seam
            # previous output in row-major order: lane roll right, col 0
            # from the sublane-rolled last column, corner = the seam
            Are = jnp.roll(zre, 1, axis=1)
            Aim = jnp.roll(zim, 1, axis=1)
            Bre = jnp.roll(zre[:, P - 1], 1, axis=0)
            Bim = jnp.roll(zim[:, P - 1], 1, axis=0)
            col0 = jnp.arange(P) == 0
            row0 = (jnp.arange(F) == 0)[:, None]
            corner = col0 & row0
            pre = jnp.where(corner, s_re,
                            jnp.where(col0, Bre[:, None], Are))
            pim = jnp.where(corner, s_im,
                            jnp.where(col0, Bim[:, None], Aim))
            audios.append(disc(zre, zim, pre, pim).reshape(-1))
        seam = _piece_last(p)
    out = audios[0] if len(audios) == 1 else jnp.concatenate(audios)
    # carried state: gained, rotated last sample (rotated path's fm_prev)
    new_prev_re, new_prev_im = ddc_pieces_last_rotated(pieces, w0, dw, gain)
    return out, new_prev_re, new_prev_im


def ddc_am_epilogue_pieces(pieces, gain):
    """AM envelope off the native piece layouts: g |z| per piece."""
    g = jnp.asarray(gain).astype(pieces[0][1].dtype)
    outs = []
    for p in pieces:
        if p[0] == "flat":
            outs.append(g * jnp.sqrt(p[1] * p[1] + p[2] * p[2]))
        else:
            y2d, P = p[1], p[2]
            env = jnp.sqrt(y2d[:, :P] * y2d[:, :P]
                           + y2d[:, P:] * y2d[:, P:])
            outs.append((g * env).reshape(-1))
    return outs[0] if len(outs) == 1 else jnp.concatenate(outs)


def ddc_apply(taps, dtheta, tail, theta0, x, decimation: int,
              precision="highest", block: int | None = None,
              rot_mode: str = "fast"):
    """Complex-in/complex-out wrapper around :func:`ddc_apply_planar`.

    ``tail`` is the carried complex raw-input tail (ntaps-1,) — the same
    format as fir_decim_apply's tail but PRE-mix; returns
    (y, new_tail, theta_end) with y complex of length L // M.
    """
    tail2 = jnp.stack([jnp.real(tail), jnp.imag(tail)])
    x2 = jnp.stack([jnp.real(x), jnp.imag(x)])
    out_re, out_im, new_tail2, theta_end = ddc_apply_planar(
        taps, dtheta, tail2, theta0, x2,
        decimation, precision, block, rot_mode)
    y = jax.lax.complex(out_re, out_im).astype(x.dtype)
    new_tail = jax.lax.complex(new_tail2[0], new_tail2[1]).astype(x.dtype)
    return y, new_tail, theta_end
