"""Arbitrary-ratio resampling: polyphase sinc bank + multistage chains.

Two layers:

* ``PfbArbitraryResampler`` — the precision workhorse (liquid-dsp's
  ``resamp`` equivalent): a windowed-sinc kernel sampled on an
  ``npf``-phase polyphase grid; each output sample blends the two
  adjacent phase filters linearly.  Formulation: output positions
  expand on device from per-chunk f64 host anchors (same scheme as
  ops/farrow.py), the P-point windows come from ONE monotonic gather
  (the same small-fan-out shape Farrow uses on the chip), and the phase
  blend is a two-row take from the tiny resident (npf+1, P) tap table
  followed by an einsum — peak memory O(n_out * P), never the
  (n_out, npf) one-hot.  The prototype doubles as the anti-alias
  filter when decimating (cutoff 0.5/ratio), so no separate AA stage
  is needed.

* ``ArbitraryResampler`` — one-call rate conversion by ANY real factor
  r = f_out / f_in (the "msresamp"): for r < 1 a halfband decimator
  cascade takes the cheap 2^k part (each stage runs at half the rate
  with a wider transition), leaving a residual q in [1, 2) for the PFB
  stage — so the per-output stencil P stays small no matter how large
  the total ratio; for r > 1 the PFB interpolates directly (images
  rejected by the same prototype).  r == 1 is a passthrough.

Everything streams block-by-block with carried tails, like every filter
in ops/fir.py.  For FIXED small rational ratios prefer
ops.fir.RationalResampler (exact polyphase, no interpolation error);
for slowly DRIFTING ratios driven per-block (timing loops) use
ops.farrow.FarrowResampler.  The reference has no multirate
architecture at all (its decimators run the full filter at the input
rate, src/filter/fir/decim.rs:221-228).

The host-anchored classes remain the flexible/CPU-exact path;
fixed-block deployments should use the fully jittable grid engines
(:func:`make_pfb_resampler` / :func:`make_arb_resampler`, or
``ArbitraryResampler(block_len=...)``) — exact fixed-point positions on
device, one dispatch per block (ops/gridresample.py).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .halfband import HalfbandDecimator, _halfband_stage_semilen, \
    firdes_halfband, halfband_decimate
from ..design.firdes import estimate_required_filter_length, kaiser_beta
from ..design.windows import kaiser as kaiser_window

__all__ = ["halfband_interpolate", "HalfbandInterpolator",
           "PfbArbitraryResampler", "ArbitraryResampler",
           "make_pfb_resampler", "make_arb_resampler"]


def halfband_interpolate(taps, tail, x):
    """Interpolate-by-2 with a halfband filter, polyphase (no zero-stuff).

    With the halfband structure (nonzero at even indices + the ~0.5
    center c, c odd), the upsampled-convolved output splits exactly:

        y[2k]   = 2 * sum_j h[2j] x[k - j]      (even-tap conv)
        y[2k+1] = 2 * h[c] x[k - (c-1)/2]       (scaled delay)

    (factor 2 restores unit passband gain after 1:2 expansion; after
    firdes_halfband's DC renormalization h[c] is 0.5 only to ~1e-4, so
    the odd branch keeps the exact 2*h[c] scale).
    Returns (y (2L,), new_tail); tail length (n-1)//2 input samples.
    """
    from .fir import conv1d_mxu

    n = taps.shape[-1]
    c = (n - 1) // 2
    he = 2.0 * taps[..., 0::2]          # nonzero branch, gain-corrected
    m = he.shape[-1]                    # = (n+1)/2 even-index taps
    x_ext = jnp.concatenate([tail, x], axis=-1)
    L = x.shape[-1]
    ye = conv1d_mxu(x_ext, he)[..., :L]          # aligns y[2k] with x[k-...]
    # odd outputs: delayed input, same total latency as the even branch.
    # even branch center sits at even-tap index (m-1)/2... the two
    # branches must interleave so the composite is the zero-stuffed conv:
    # y_full[t] = 2*sum_j h[j] u[t-j], u[2k]=x[k].  With ext offset
    # (n-1)//2 input samples of tail, y[2k] = ye[k] covers j even, and
    # y[2k+1] needs u[2k+1-c] = x[(2k+1-c)/2] = x_ext[k + (tail_len -
    # (c-1)//2)] — with tail_len = (n-1)//2 = c (c = center), the odd
    # branch is x_ext[k + (c - (c-1)//2)] shifted into the same frame.
    off = tail.shape[-1] - (c - 1) // 2
    yo = (2.0 * taps[..., c]) * x_ext[..., off: off + L]
    y = jnp.stack([ye, yo], axis=-1).reshape(*x.shape[:-1], 2 * L)
    new_tail = x_ext[..., x_ext.shape[-1] - tail.shape[-1]:]
    return y, new_tail


class HalfbandInterpolator:
    """Stateful 1:2 interpolator (streaming, carried tail)."""

    def __init__(self, semi_length: int = 8,
                 stop_band_attenuation: float = 60.0, dtype=jnp.complex64):
        self.taps_np = firdes_halfband(semi_length, stop_band_attenuation)
        self._taps = jnp.asarray(self.taps_np, jnp.float32)
        n = len(self.taps_np)
        from ..utils.transfer import zeros_device

        self._tail = zeros_device((n - 1) // 2, dtype)

    def execute_block(self, x):
        x = jnp.asarray(x)
        if not jnp.issubdtype(self._tail.dtype, x.dtype):
            self._tail = self._tail.astype(
                jnp.result_type(self._tail.dtype, x.dtype))
        y, self._tail = halfband_interpolate(self._taps, self._tail, x)
        return y

    def reset(self):
        from ..utils.transfer import zeros_device

        self._tail = zeros_device(self._tail.shape, self._tail.dtype)


def _pfb_tables(P: int, npf: int, cutoff: float, as_db: float) -> np.ndarray:
    """(npf + 1, P) polyphase tap table for the windowed-sinc kernel.

    Row q holds the P-tap filter for fractional position q/npf:
    tap[q, i] = K(q/npf + P/2 - 1 - i), K(t) = 2 fc sinc(2 fc t) w(t),
    with w a Kaiser window over the +-P/2 support.  Rows are
    DC-normalized so every phase has exactly unit gain (kills the
    periodic gain ripple a truncated kernel would otherwise imprint at
    the phase rate).

    Phase-wrap continuity: when mu crosses 1 the stencil base advances
    by one sample and the blend lands on row npf instead of row 0 — the
    two evaluations differ exactly by the kernel's edge samples
    K(+-P/2).  The Kaiser window does not vanish at its edges
    (~1/I0(beta)), which would leave a ~1e-4 seam every time an output
    position lands on an integer (and makes results depend on which
    side f64 floor() falls — observed as block-split irreproducibility).
    So the edge tap is zeroed (a ~1e-4 kernel edit, far below the
    stopband) and row npf is BUILT as the exact one-sample shift of
    row 0, making the wrap bit-continuous by construction.
    """
    w_full = kaiser_window(npf * P + 1, kaiser_beta(as_db))
    qs = np.arange(npf, dtype=np.float64)
    ii = np.arange(P, dtype=np.float64)
    t = qs[:, None] / npf + P / 2.0 - 1.0 - ii[None, :]
    K = 2.0 * cutoff * np.sinc(2.0 * cutoff * t)
    # window value at kernel offset t (support |t| <= P/2)
    widx = np.clip(np.rint((t + P / 2.0) * npf).astype(np.int64),
                   0, npf * P)
    T = K * w_full[widx]
    T[0, P - 1] = 0.0                        # K(-P/2): kill the seam
    T = T / np.sum(T, axis=1, keepdims=True)
    row_npf = np.concatenate([[0.0], T[0, : P - 1]])
    return np.concatenate([T, row_npf[None, :]], axis=0)


@partial(jax.jit, static_argnames=("n_valid", "P", "npf"))
def _pfb_block(tail, x, table, base0, frac0, ratio_dev,
               n_valid: int, P: int, npf: int):
    """One PFB-resampler block as a single fused dispatch.

    Same split position arithmetic as ops/farrow.py::_farrow_block
    (host f64 per-chunk anchors, device expansion) — see the precision
    note there.  The per-output filter is C @ table with C the
    (n_valid, npf+1) two-hot linear-blend matrix: one small matmul
    instead of a per-output row gather.
    """
    ext = jnp.concatenate([tail, x])
    new_tail = ext[-(tail.shape[-1]):]
    rdt = frac0.dtype
    n_chunks = base0.shape[0]
    chunk_len = -(-n_valid // n_chunks)
    j = jnp.arange(chunk_len, dtype=rdt)
    t_loc = frac0[:, None] + ratio_dev * j[None, :]
    step = jnp.floor(t_loc)
    base_pre = (base0[:, None] + step.astype(jnp.int32)).reshape(-1)[:n_valid]
    mu = (t_loc - step).reshape(-1)[:n_valid]
    base = jnp.clip(base_pre, 0, ext.shape[-1] - P)
    mu = mu + (base_pre - base).astype(rdt)     # fold clamp into the phase
    idx = base[:, None] + jnp.arange(P, dtype=jnp.int32)[None, :]
    windows = ext[idx]                          # (n_valid, P) monotonic
    # linear blend between the two adjacent phase rows: a two-row take
    # from the tiny resident (npf+1, P) table — peak memory stays at
    # O(n_valid * P), the same as the window matrix (an explicit
    # (n_valid, npf+1) one-hot matmul would cost (npf+1)/P times more)
    ph = jnp.clip(mu, 0.0, 1.0) * npf
    q = jnp.clip(jnp.floor(ph), 0, npf - 1)
    alpha = (ph - q).astype(rdt)[:, None]
    qi = q.astype(jnp.int32)
    t0 = jnp.take(table, qi, axis=0)            # (n_valid, P)
    t1 = jnp.take(table, qi + 1, axis=0)
    taps = (t0 + alpha * (t1 - t0)).astype(ext.dtype)
    return jnp.einsum("tk,tk->t", windows, taps), new_tail


class PfbArbitraryResampler:
    """Streaming polyphase-sinc arbitrary resampler.

    ratio = input samples per output sample (like FarrowResampler).
    ``cutoff``: prototype lowpass cutoff in cycles/INPUT-sample —
    defaults to min(0.5, 0.5/ratio) * 0.92 so decimation is anti-aliased
    and interpolation images are rejected by the same kernel.  ``P``:
    stencil taps per output (None = sized from the attenuation and the
    transition band).  ``npf``: phase resolution (64 with linear blend
    puts phase-quantization error well below an 80 dB floor).
    """

    def __init__(self, ratio: float, cutoff: float | None = None,
                 stop_band_attenuation: float = 60.0, P: int | None = None,
                 npf: int = 64, dtype=jnp.complex64,
                 batch_shape: tuple = ()):
        if ratio <= 0.0:
            raise ValueError("ratio must be positive")
        self.ratio = float(ratio)
        as_db = float(stop_band_attenuation)
        if cutoff is None:
            cutoff = min(0.5, 0.5 / self.ratio) * 0.92
        if not (0.0 < cutoff <= 0.5):
            raise ValueError("cutoff in (0, 0.5] cycles/input-sample")
        self.cutoff = float(cutoff)
        if P is None:
            # transition band: from the passband edge (~0.8 cutoff) to
            # the first alias/image edge (2*cutoff wide in total)
            df = max(min(0.4 * self.cutoff * 2.0, 0.45), 0.02)
            P = int(estimate_required_filter_length(df, as_db))
        self.P = max(int(P), 4)
        self.npf = int(npf)
        self._table_np = _pfb_tables(self.P, self.npf, self.cutoff, as_db)
        self._table = jnp.asarray(self._table_np)
        # batch_shape: resample a whole bank of channels in lockstep —
        # positions are shared, the kernel vmaps over leading axes
        self.batch_shape = tuple(batch_shape)
        from ..utils.transfer import zeros_device

        self._tail = zeros_device((*self.batch_shape, self.P - 1), dtype)
        self._t_next = 0.0                      # position bookkeeping, f64

    def execute_block(self, x):
        x = jnp.asarray(x, self._tail.dtype)
        P = self.P
        L = int(x.shape[-1]) + P - 1
        # output at ext position t uses ext[floor(t) .. floor(t)+P-1]:
        # valid while floor(t) + P - 1 <= L - 1, i.e. t < L - P + 1
        lim = L - P + 1
        n_out = int(np.ceil((lim - self._t_next) / self.ratio - 1e-12))
        n_out = max(n_out, 0)
        if n_out == 0:
            self._tail = jnp.concatenate([self._tail, x],
                                         axis=-1)[..., -(P - 1):]
            self._t_next -= x.shape[-1]
            return x[..., :0]
        chunk = max(64, int(1024 / max(self.ratio, 1.0)))
        n_pad = int(np.ceil(lim / self.ratio)) + 2
        n_chunks = -(-n_pad // chunk)
        rdt = np.zeros(0, self._tail.dtype).real.dtype
        t_c = self._t_next + self.ratio * chunk * np.arange(n_chunks)
        base0 = np.floor(t_c).astype(np.int32)
        frac0 = (t_c - np.floor(t_c)).astype(rdt)
        kern = partial(_pfb_block, n_valid=n_chunks * chunk, P=P,
                       npf=self.npf)
        for _ in self.batch_shape:              # channels share positions
            kern = jax.vmap(kern, in_axes=(0, 0, None, None, None, None),
                            out_axes=(0, 0))
        y_pad, self._tail = kern(
            self._tail, x, self._table.astype(rdt),
            jnp.asarray(base0), jnp.asarray(frac0),
            jnp.asarray(self.ratio, rdt))
        y = y_pad[..., :n_out]
        self._t_next = float(self._t_next + self.ratio * n_out
                             - x.shape[-1])
        return y

    def flush(self):
        """Drain the carried tail: zero-feed one stencil's worth of
        input and return the residual output (end-of-stream)."""
        pad = self.P + int(np.ceil(self.ratio)) + 1
        from ..utils.transfer import zeros_device

        return self.execute_block(zeros_device((*self.batch_shape, pad),
                                            self._tail.dtype))

    def reset(self):
        from ..utils.transfer import zeros_device

        self._tail = zeros_device(self._tail.shape, self._tail.dtype)
        self._t_next = 0.0

    def __repr__(self):
        return (f"PfbArbitraryResampler [ratio={self.ratio:.6f}] "
                f"[P={self.P}] [npf={self.npf}]")


def make_pfb_resampler(ratio: float, block_len: int, cutoff: float | None
                       = None, stop_band_attenuation: float = 60.0,
                       P: int | None = None, npf: int = 64,
                       dtype=jnp.complex64):
    """Fully jittable streaming PFB resampler (the device fast path).

    Returns ``(init, apply, plan)`` with ``apply(state, x) ->
    (y_pad, n_valid, state)`` — the framework's static-shape masked
    contract: x has fixed length ``block_len``, y_pad the static length
    ``plan.n_pad``, and the first n_valid (= q0 or q0+1) entries are
    valid.  The ratio is quantized once to ``plan.ratio`` (< 0.5 ppm
    off) and positions are exact int32 fixed-point on device
    (ops/gridresample.py) — ONE dispatch per block, zero host
    bookkeeping, bit-reproducible across block partitionings.  Window
    extraction is im2col + row-``take`` (~20 Gelem/s measured) instead
    of the host-anchored advanced-index gather (~0.1 Gelem/s) of
    ``PfbArbitraryResampler.execute_block``; tap blending is the same
    two-row linear interpolation from the same ``_pfb_tables`` table,
    so outputs match the legacy path bit-for-float at dyadic ratios.
    """
    from .gridresample import (grid_advance, grid_n_valid, grid_positions,
                               plan_ratio)
    from ..utils.transfer import zeros_device

    proto = PfbArbitraryResampler(ratio, cutoff=cutoff,
                                  stop_band_attenuation=stop_band_attenuation,
                                  P=P, npf=npf, dtype=dtype)
    Pt = proto.P
    npf = proto.npf
    table_np = proto._table_np
    L = int(block_len)
    plan = plan_ratio(ratio, L)
    n_pad = plan.n_pad

    def init():
        return (zeros_device(Pt - 1, dtype), jnp.zeros((), jnp.int32))

    @jax.jit
    def apply(state, x):
        tail, t0 = state
        ext = jnp.concatenate([tail, x.astype(tail.dtype)], axis=-1)
        rdt = jnp.real(ext).dtype
        base, mu = grid_positions(plan, t0, n_pad)
        base = jnp.clip(base, 0, L - 1)
        C = jnp.stack([ext[..., i: i + L] for i in range(Pt)], axis=-1)
        win = jnp.take(C, base, axis=0)                     # (n_pad, Pt)
        table = jnp.asarray(table_np).astype(rdt)
        ph = jnp.clip(mu, 0.0, 1.0) * npf
        q = jnp.clip(jnp.floor(ph), 0, npf - 1)
        alpha = (ph - q).astype(rdt)[:, None]
        qi = q.astype(jnp.int32)
        t0r = jnp.take(table, qi, axis=0)
        t1r = jnp.take(table, qi + 1, axis=0)
        taps = (t0r + alpha * (t1r - t0r)).astype(ext.dtype)
        y = jnp.sum(win * taps, axis=-1)
        n_valid = grid_n_valid(plan, t0)
        y = jnp.where(jnp.arange(n_pad) < n_valid, y, 0)
        new_state = (ext[..., L:], grid_advance(plan, t0))
        return y, n_valid, new_state

    return init, apply, plan


def make_arb_resampler(rate: float, block_len: int, fpass: float = 0.4,
                       stop_band_attenuation: float = 60.0,
                       dtype=jnp.complex64):
    """Fully jittable msresamp: halfband cascade + PFB grid stage.

    The functional counterpart of :class:`ArbitraryResampler` for fixed
    block lengths: returns ``(init, apply, n_pad)`` with
    ``apply(state, x) -> (y_pad (n_pad,), n_valid, state)`` — ONE
    compiled dispatch covering the whole multistage chain (the class's
    ``execute_block`` stages blocks host-side).  Decimation runs the
    same 2^k halfband
    cascade (each stage one strided Toeplitz conv) and the residual
    q in [1, 2) through :func:`make_pfb_resampler`; interpolation is
    one PFB stage at ratio 1/rate.  block_len must divide by 2^k.
    """
    if rate <= 0.0:
        raise ValueError("rate must be positive")
    if not (0.0 < fpass < 0.5):
        raise ValueError("fpass in (0, 0.5)")
    as_db = float(stop_band_attenuation)
    L = int(block_len)
    hb_taps: list[np.ndarray] = []
    pfb = None
    if rate < 1.0:
        k = int(np.floor(np.log2(1.0 / rate)))
        q = 1.0 / (rate * 2.0 ** k)
        if L % (1 << k):
            raise ValueError(f"block_len must divide by 2^{k}")
        for s in range(k):
            eff_after = float(k - 1 - s) + (np.log2(q) if q > 1.0 else 0.0)
            m = _halfband_stage_semilen(fpass, eff_after, as_db)
            hb_taps.append(firdes_halfband(m, as_db).astype(np.float32))
        L_pfb = L >> k
        if q > 1.0 + 1e-9:
            df = max(min((1.0 - 2.0 * fpass) / q, 0.45), 0.02)
            P = int(estimate_required_filter_length(df, as_db))
            pfb = make_pfb_resampler(q, L_pfb, cutoff=0.5 / q,
                                     stop_band_attenuation=as_db, P=P,
                                     dtype=dtype)
    elif rate > 1.0:
        df = max(min(1.0 - 2.0 * fpass, 0.45), 0.02)
        P = int(estimate_required_filter_length(df, as_db))
        pfb = make_pfb_resampler(1.0 / rate,
                                 L, cutoff=0.5 * (1.0 - (0.5 - fpass)),
                                 stop_band_attenuation=as_db, P=P,
                                 dtype=dtype)
    from ..utils.transfer import zeros_device

    def init():
        st = {"hb": tuple(zeros_device(len(t) - 1, dtype)
                          for t in hb_taps)}
        if pfb is not None:
            st["pfb"] = pfb[0]()
        return st

    if pfb is not None:
        n_pad = pfb[2].n_pad
    else:
        n_pad = L >> len(hb_taps) if hb_taps else L

    @jax.jit
    def apply(state, x):
        y = jnp.asarray(x, dtype)
        new_hb = []
        for taps, tail in zip(hb_taps, state["hb"]):
            y, t2 = halfband_decimate(jnp.asarray(taps), tail, y)
            new_hb.append(t2)
        new_state = {"hb": tuple(new_hb)}
        if pfb is not None:
            y, n_valid, st2 = pfb[1](state["pfb"], y)
            new_state["pfb"] = st2
        else:
            n_valid = jnp.int32(y.shape[-1])
        return y, n_valid, new_state

    return init, apply, n_pad


class ArbitraryResampler:
    """Stream-resample by any real factor ``rate`` = f_out / f_in.

    ``fpass``: edge of the band to protect, as a fraction of the SLOWER
    of the two rates (< 0.5) — i.e. of the output rate when decimating,
    of the input rate when interpolating.  ``stop_band_attenuation``:
    alias/image suppression in dB across the whole chain.  Decimation
    runs a halfband cascade for the 2^k factor so the PFB stencil stays
    small for arbitrarily large ratios; interpolation is one PFB stage.
    """

    def __init__(self, rate: float, fpass: float = 0.4,
                 stop_band_attenuation: float = 60.0, dtype=jnp.complex64,
                 block_len: int | None = None):
        if rate <= 0.0:
            raise ValueError("rate must be positive")
        if not (0.0 < fpass < 0.5):
            raise ValueError("fpass in (0, 0.5)")
        self.rate = float(rate)
        # block_len: opt into the jittable fixed-block device fast path
        # (make_arb_resampler): every execute_block must then pass
        # exactly block_len samples; the whole multistage chain becomes
        # ONE compiled dispatch + one scalar n_valid fetch (vs the
        # host-staged legacy path).
        # Ratio semantics in this mode: each fractional stage runs at
        # its quantized ratio (< 0.5 ppm off, exactly, drift-free).
        self._grid = None
        if block_len is not None and abs(rate - 1.0) > 1e-12:
            try:
                init_g, apply_g, n_pad = make_arb_resampler(
                    rate, int(block_len), fpass=fpass,
                    stop_band_attenuation=stop_band_attenuation, dtype=dtype)
            except ValueError:
                # rate outside the fixed-point grid envelope (e.g.
                # interpolation > 16x, block_len > 2^24): keep the
                # host-anchored legacy path silently — same outputs,
                # host-staged
                pass
            else:
                self._grid = (int(block_len), apply_g, n_pad)
                self._grid_init = init_g
                self._grid_state = init_g()
        self.stages: list = []
        as_db = float(stop_band_attenuation)

        self._align = 1          # input granularity of the halfband cascade
        self._rem = None         # carried input remainder (device array)
        if rate < 1.0:
            # 2^k halfbands, then one PFB stage for the residual q in [1,2)
            k = int(np.floor(np.log2(1.0 / rate)))
            q = 1.0 / (rate * 2.0 ** k)
            self._align = 1 << k
            for s in range(k):
                eff_after = float(k - 1 - s) + (np.log2(q) if q > 1.0
                                                else 0.0)
                m = _halfband_stage_semilen(fpass, eff_after, as_db)
                self.stages.append(HalfbandDecimator(m, as_db, dtype=dtype))
            if q > 1.0 + 1e-9:
                # prototype = anti-alias filter: passband fpass/q,
                # stopband (1-fpass)/q at the intermediate rate
                df = max(min((1.0 - 2.0 * fpass) / q, 0.45), 0.02)
                P = int(estimate_required_filter_length(df, as_db))
                self.stages.append(PfbArbitraryResampler(
                    q, cutoff=0.5 / q, stop_band_attenuation=as_db,
                    P=P, dtype=dtype))
        elif rate > 1.0:
            # one PFB interpolation stage: images sit 1/rate apart, the
            # prototype (cutoff 0.5 input-rate) rejects them; transition
            # from fpass to the first image edge (1 - fpass)
            df = max(min(1.0 - 2.0 * fpass, 0.45), 0.02)
            P = int(estimate_required_filter_length(df, as_db))
            self.stages.append(PfbArbitraryResampler(
                1.0 / rate, cutoff=0.5 * (1.0 - (0.5 - fpass)),
                stop_band_attenuation=as_db, P=P, dtype=dtype))

    def execute_block(self, x):
        y = jnp.asarray(x)
        if self._grid is not None:
            Lb, apply_g, n_pad = self._grid
            if int(y.shape[-1]) != Lb:
                raise ValueError(
                    f"block_len mode: every block must have exactly {Lb} "
                    "samples")
            yp, nv, self._grid_state = apply_g(self._grid_state, y)
            return yp[: int(nv)]
        if self._align > 1:
            # halfband stages need blocks divisible by 2^k: stash the
            # ragged tail and prepend it to the next block (streaming
            # output is identical to any other block partitioning)
            if self._rem is not None and self._rem.shape[-1]:
                y = jnp.concatenate([self._rem.astype(y.dtype), y], axis=-1)
            keep = (y.shape[-1] // self._align) * self._align
            self._rem = y[..., keep:]
            y = y[..., :keep]
            if keep == 0:
                return y
        for st in self.stages:
            y = st.execute_block(y)
        return y

    def flush(self):
        """Drain every stage's carried state at end of stream.

        Zero-feeds enough input to push the group delay of the whole
        cascade (each stage's tail, scaled to the ORIGINAL input rate)
        plus the alignment remainder through, and returns the residual
        output — a one-shot file conversion is then execute_block(x)
        followed by flush() (see the CLI resample subcommand).
        """
        from ..utils.transfer import zeros_device

        if not self.stages:                    # identity: nothing buffered
            return zeros_device(0, jnp.complex64)
        total = self._align
        scale = 1
        for st in self.stages:
            if isinstance(st, HalfbandDecimator):
                total += (len(st.taps_np) - 1) * scale
                scale *= 2
            elif isinstance(st, PfbArbitraryResampler):
                total += (st.P + int(np.ceil(st.ratio)) + 1) * scale
        total = -(-total // self._align) * self._align + self._align
        dt = self.stages[0]._tail.dtype
        return self.execute_block(zeros_device(total, dt))

    def reset(self):
        self._rem = None
        for st in self.stages:
            st.reset()
        if self._grid is not None:
            self._grid_state = self._grid_init()

    def __repr__(self):
        names = "+".join(type(s).__name__ for s in self.stages) or "identity"
        return f"ArbitraryResampler [rate={self.rate:.6f}] [{names}]"
