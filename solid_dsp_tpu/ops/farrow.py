"""Farrow arbitrary-ratio resampler (cubic Lagrange).

Completes the rate-conversion family (integer decimators/interpolators,
rational P/Q polyphase, CIC): resampling by ANY real ratio — fine
sample-clock tracking (timing loops feed a slowly varying ratio) and
irrational conversions.  For FIXED rational ratios prefer
``ops.fir.RationalResampler`` (polyphase matmul with proper anti-alias
filtering, no interpolation error); Farrow's cubic is the tool when the
ratio is irrational or drifts.

Formulation: each output sample needs 4 input points around its
fractional position; the 4-point windows come from one monotonic gather
(small fan-out, unlike im2col) and the cubic Lagrange basis evaluates as
a (T_out, 4) einsum — no sequential dependency, the whole block is
parallel.  Output positions expand on device from per-chunk f64 host
anchors (see _farrow_block) and shapes are padded per block length, so
every phase runs the same compiled program with a tiny host transfer.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["lagrange_coeffs", "FarrowResampler", "make_farrow_resampler"]

from functools import partial


_CHUNK = 1024  # device-side position expansion span (see _farrow_block)


@partial(jax.jit, static_argnames=("n_valid",))
def _farrow_block(tail, x, base0, frac0, ratio_dev, n_valid: int):
    """One resampler block as a single fused dispatch.

    Position arithmetic is SPLIT to keep both precision and transfer
    size small: the host computes only per-_CHUNK start positions in f64
    (~n_out/1024 values, a few tens of KB), and the device expands
    t = frac0[c] + j*ratio for j < _CHUNK.  Accumulating t0 + k*ratio
    on-device for k in the millions would destroy mu in f32, while
    shipping full per-output base/mu arrays costs ~8 bytes per OUTPUT
    sample of host-to-device traffic.  Within a
    chunk the f32 error is <= _CHUNK*ratio*eps ~ 1e-4, i.e. interpolation
    stays > 70 dB accurate (exact in f64 on CPU).
    """
    ext = jnp.concatenate([tail, x])
    new_tail = ext[-(tail.shape[-1]):]
    rdt = frac0.dtype
    n_chunks = base0.shape[0]
    chunk_len = -(-n_valid // n_chunks)
    j = jnp.arange(chunk_len, dtype=rdt)
    t_loc = frac0[:, None] + ratio_dev * j[None, :]     # (C, chunk)
    step = jnp.floor(t_loc)
    base_pre = (base0[:, None] + step.astype(jnp.int32)).reshape(-1)[:n_valid]
    mu = (t_loc - step).reshape(-1)[:n_valid]
    base = jnp.clip(base_pre, 0, ext.shape[-1] - 4)
    # fold any clamp displacement into mu so a boundary f32 rounding event
    # shifts the INTERPOLATION POINT, not the output sample (the Lagrange
    # basis extrapolates smoothly for mu slightly outside [0, 1))
    mu = mu + (base_pre - base).astype(rdt)
    idx = base[:, None] + jnp.arange(4, dtype=jnp.int32)[None, :]
    windows = ext[idx]  # (n_valid, 4) monotonic gather
    c = lagrange_coeffs(mu).astype(ext.dtype)
    return jnp.einsum("tk,tk->t", windows, c), new_tail


@jax.jit
def lagrange_coeffs(mu):
    """Cubic Lagrange basis at fractional offset mu in [0, 1), for the
    4-point stencil x[-1], x[0], x[1], x[2]:  (T, 4)."""
    m = jnp.asarray(mu)
    c_m1 = -m * (m - 1.0) * (m - 2.0) / 6.0
    c_0 = (m + 1.0) * (m - 1.0) * (m - 2.0) / 2.0
    c_1 = -(m + 1.0) * m * (m - 2.0) / 2.0
    c_2 = (m + 1.0) * m * (m - 1.0) / 6.0
    return jnp.stack([c_m1, c_0, c_1, c_2], axis=-1)


def make_farrow_resampler(ratio: float, block_len: int,
                          dtype=jnp.complex64):
    """Fully jittable streaming Farrow resampler (the device fast path).

    Returns ``(init, apply, plan)`` with ``apply(state, x) ->
    (y_pad, n_valid, state)``: ``x`` is a fixed-length block of
    ``block_len`` samples, ``y_pad`` has the static length
    ``plan.n_pad`` with the first ``n_valid`` entries valid (mask or
    slice downstream; n_valid is q0 or q0+1 every block).  The ratio is
    quantized once to ``plan.ratio`` = round(ratio * 2^20) / 2^20
    (< 0.5 ppm off) and positions follow it EXACTLY forever — int32
    fixed-point on device, zero drift, bit-reproducible across any
    block partitioning (ops/gridresample.py).

    The window extraction is an im2col + row-``take`` (in place of the
    advanced-index window gather the host-anchored ``FarrowResampler``
    path uses) and every step is on-device, so the whole block is ONE
    dispatch with no host position bookkeeping.
    """
    from .gridresample import (grid_advance, grid_n_valid, grid_positions,
                               plan_ratio)
    from ..utils.transfer import zeros_device

    P = FarrowResampler.STENCIL
    L = int(block_len)
    plan = plan_ratio(ratio, L)
    n_pad = plan.n_pad

    def init():
        return (zeros_device(P - 1, dtype),
                jnp.zeros((), jnp.int32))

    @jax.jit
    def apply(state, x):
        tail, t0 = state
        ext = jnp.concatenate([tail, x.astype(tail.dtype)], axis=-1)
        base, mu = grid_positions(plan, t0, n_pad)
        base = jnp.clip(base, 0, L - 1)
        C = jnp.stack([ext[..., i: i + L] for i in range(P)], axis=-1)
        win = jnp.take(C, base, axis=0)                    # (n_pad, P)
        coef = lagrange_coeffs(mu).astype(ext.dtype)
        y = jnp.sum(win * coef, axis=-1)
        n_valid = grid_n_valid(plan, t0)
        y = jnp.where(jnp.arange(n_pad) < n_valid, y, 0)
        new_state = (ext[..., L:], grid_advance(plan, t0))
        return y, n_valid, new_state

    return init, apply, plan


class FarrowResampler:
    """Streaming arbitrary-ratio resampler.

    ratio = input samples per output sample (e.g. 48000/44100 to go from
    48 kHz down to 44.1 kHz).  Cubic interpolation: > 60 dB image
    rejection for signals below ~0.1 of the input rate.
    """

    STENCIL = 4  # x[-1], x[0], x[1], x[2]

    def __init__(self, ratio: float, dtype=jnp.complex64):
        if ratio <= 0.0:
            raise ValueError("ratio must be positive")
        self.ratio = float(ratio)
        from ..utils.transfer import zeros_device

        self._tail = zeros_device(self.STENCIL - 1, dtype)
        # position of the next output, in input-sample units, measured
        # from index 1 of the CURRENT extended block (so a stencil point
        # at -1 is always available)
        self._t_next = 0.0

    def execute_block(self, x):
        x = jnp.asarray(x, self._tail.dtype)
        L = int(x.shape[-1]) + self.STENCIL - 1
        # valid output positions t (ext stencil coords: sample value at
        # position t+1+mu uses ext[floor(t) .. floor(t)+3]): need
        # floor(t)+3 <= L-1, i.e. strictly t < L-3.  n_out and the phase
        # update are pure host arithmetic (no device fetch); the block
        # itself is ONE jitted dispatch, not one dispatch per op.
        n_out = int(np.ceil((L - 3 - self._t_next) / self.ratio - 1e-12))
        n_out = max(n_out, 0)
        if n_out == 0:
            ext_tail = jnp.concatenate([self._tail, x])[-(self.STENCIL - 1):]
            self._tail = ext_tail
            self._t_next -= x.shape[-1]
            return x[:0]
        # n_valid pads to a fixed per-L length: a shape that wobbles by
        # +-1 between blocks forces a fresh XLA compile every block.  The
        # chunk shrinks with the ratio so the on-device f32 span
        # chunk*ratio (and hence the mu error) stays ~1024*eps regardless
        # of how large the ratio is.
        chunk = max(64, int(_CHUNK / max(self.ratio, 1.0)))
        n_pad = int(np.ceil((L - 3) / self.ratio)) + 2
        n_chunks = -(-n_pad // chunk)
        rdt = np.zeros(0, self._tail.dtype).real.dtype
        # per-chunk start positions, exact in f64 on the host (tiny arrays)
        t_c = self._t_next + self.ratio * chunk * np.arange(n_chunks)
        base0 = np.floor(t_c).astype(np.int32)
        frac0 = (t_c - np.floor(t_c)).astype(rdt)
        y_pad, self._tail = _farrow_block(
            self._tail, x, jnp.asarray(base0), jnp.asarray(frac0),
            jnp.asarray(self.ratio, rdt), n_chunks * chunk)
        y = y_pad[:n_out]
        t_end = self._t_next + self.ratio * n_out
        self._t_next = float(t_end - (L - 3))
        return y

    def reset(self):
        from ..utils.transfer import zeros_device

        self._tail = zeros_device(self._tail.shape, self._tail.dtype)
        self._t_next = 0.0

    def __repr__(self):
        return f"FarrowResampler [ratio={self.ratio:.6f}]"
