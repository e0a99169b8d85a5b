"""FEC: convolutional encoding + Viterbi decoding.

Forward error correction rounds out the digital-link stack (modem family +
carrier/timing recovery + impairment correction are already in).  The
classic rate-1/n convolutional code (default: the K=7 (171, 133)_8 "Voyager"
code used by 802.11/DVB/CCSDS) with:

* a fully vectorized encoder (sliding windows -> parity via XOR-fold, one
  shot for the whole block),
* a Viterbi decoder whose add-compare-select runs VECTORIZED over all
  2^(K-1) states inside a ``lax.scan`` over time — the time recurrence is
  irreducible (each step's metrics depend on the previous), but every
  step is pure elementwise/select work over the state axis, which is the
  standard trellis-parallel formulation;
* hard-decision (Hamming) or soft-decision (LLR) branch metrics.

Blocks are tail-terminated (K-1 zero bits) so decoding starts and ends in
state 0.
"""

from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["conv_encode", "viterbi_decode", "ConvCode",
           "interleave", "deinterleave", "puncture", "depuncture",
           "PUNCTURE_2_3", "PUNCTURE_3_4", "PUNCTURE_5_6", "PUNCTURE_7_8"]

DEFAULT_POLYS = (0o171, 0o133)
DEFAULT_K = 7


def _bitrev(p: int, K: int) -> int:
    # Internally the shift register keeps the NEWEST bit at the LSB;
    # the standard convention (802.11/DVB/CCSDS) lists generator taps
    # newest-at-MSB, so polys are reversed once here to make emitted
    # streams bit-compatible with standard (171,133) equipment.
    out = 0
    for i in range(K):
        out |= ((p >> i) & 1) << (K - 1 - i)
    return out


def _parity(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint32)
    for sh in (16, 8, 4, 2, 1):
        x ^= x >> sh
    return (x & 1).astype(np.int32)


@lru_cache(maxsize=16)
def _tables(polys: tuple, K: int):
    """(out_bits (S, 2, n), next_state (S, 2)) for prev-state s, input b."""
    S = 1 << (K - 1)
    n = len(polys)
    s = np.arange(S)[:, None]            # previous K-1 bits
    b = np.arange(2)[None, :]
    reg = (s << 1) | b                   # K-bit register, newest bit = LSB
    out = np.stack(
        [_parity(reg & _bitrev(p, K)) for p in polys], axis=-1)  # (S, 2, n)
    nxt = reg & (S - 1)
    return out.astype(np.int32), nxt.astype(np.int32)


def conv_encode(bits, polys: tuple = DEFAULT_POLYS,
                constraint: int = DEFAULT_K) -> jnp.ndarray:
    """Rate-1/n convolutional encoder with tail termination.

    bits: (T,) 0/1.  Returns ((T + K - 1) * n,) coded bits, interleaved
    per-input-bit ([t0_poly0, t0_poly1, t1_poly0, ...]).
    """
    K = constraint
    bits = jnp.asarray(bits, jnp.int32)
    padded = jnp.concatenate([
        jnp.zeros(K - 1, jnp.int32), bits, jnp.zeros(K - 1, jnp.int32)])
    T = padded.shape[-1] - (K - 1)
    # register at step t: bits t .. t+K-1 with NEWEST at the LSB; windows
    # built by stacking K shifted views (no gathers)
    cols = [padded[K - 1 - j: K - 1 - j + T] << j for j in range(K)]
    reg = sum(cols)  # (T,) K-bit registers
    outs = []
    for p in polys:
        v = jnp.bitwise_and(reg, _bitrev(p, K))
        for sh in (16, 8, 4, 2, 1):
            v = v ^ (v >> sh)
        outs.append(v & 1)
    return jnp.stack(outs, axis=-1).reshape(-1)


@partial(jax.jit, static_argnames=("polys", "constraint", "soft"))
def viterbi_decode(rx, polys: tuple = DEFAULT_POLYS,
                   constraint: int = DEFAULT_K, soft: bool = False):
    """Viterbi decode of a tail-terminated rate-1/n stream.

    rx: hard bits (T*n,) 0/1, or soft LLRs (positive = bit 0 likelier)
    when ``soft=True``.  Returns the (T - K + 1,) decoded information bits.
    """
    K = constraint
    S = 1 << (K - 1)
    n = len(polys)
    out_tab, nxt_tab = _tables(tuple(polys), K)
    rx = jnp.asarray(rx)
    if rx.shape[-1] % n:
        raise ValueError(
            f"coded length {rx.shape[-1]} is not a multiple of n={n}")
    T = rx.shape[-1] // n
    r = rx.reshape(T, n)

    # branch metric per (prev_state, input bit) given the received n-tuple
    out_j = jnp.asarray(out_tab)          # (S, 2, n)
    if soft:
        # LLR convention: positive favors bit 0; metric = sum of LLRs of
        # positions where the hypothesized bit is 1 (to be minimized)
        def step_metric(rt):
            return jnp.sum(out_j * rt[None, None, :], axis=-1)
    else:
        def step_metric(rt):
            return jnp.sum(jnp.abs(out_j - rt[None, None, :].astype(
                jnp.int32)), axis=-1)

    # predecessors of next-state ns: s in {ns>>1, (ns>>1) | S/2}, b = ns&1
    ns = np.arange(S)
    pred = np.stack([ns >> 1, (ns >> 1) | (S >> 1)], axis=-1)  # (S, 2)
    pred_j = jnp.asarray(pred)
    b_of_ns = jnp.asarray(ns & 1)

    BIG = jnp.asarray(1e9, jnp.float32)
    pm0 = jnp.full((S,), BIG).at[0].set(0.0)  # start in state 0

    def acs(pm, rt):
        bm = step_metric(rt).astype(jnp.float32)       # (S, 2, n)->(S,2)
        # candidate metric reaching ns via predecessor choice c
        cand = pm[pred_j] + bm[pred_j, b_of_ns[:, None]]  # (S, 2)
        choice = jnp.argmin(cand, axis=-1).astype(jnp.int8)
        pm_next = jnp.min(cand, axis=-1)
        # renormalize so metrics never outgrow f32 precision on long blocks
        return pm_next - jnp.min(pm_next), choice

    pm_final, choices = jax.lax.scan(acs, pm0, r)

    # traceback from state 0 (tail-terminated)
    def back(s, ch_t):
        c = ch_t[s]
        bit = b_of_ns[s].astype(jnp.int32)
        prev = pred_j[s, c].astype(jnp.int32)
        return prev, bit

    _, bits_rev = jax.lax.scan(back, jnp.asarray(0, jnp.int32),
                               choices, reverse=True)
    bits = bits_rev  # scan(reverse=True) emits in forward order
    return bits[: T - (K - 1)]


class ConvCode:
    """Convenience wrapper: encode() / decode() with fixed parameters."""

    def __init__(self, polys: tuple = DEFAULT_POLYS,
                 constraint: int = DEFAULT_K):
        self.polys = tuple(polys)
        self.K = int(constraint)
        self.rate = 1.0 / len(self.polys)

    def encode(self, bits):
        return conv_encode(bits, self.polys, self.K)

    def decode(self, rx, soft: bool = False):
        return viterbi_decode(rx, self.polys, self.K, soft=soft)

    def __repr__(self):
        return (f"ConvCode [K={self.K}] "
                f"[polys={tuple(oct(p) for p in self.polys)}]")


def interleave(bits, rows: int, cols: int) -> jnp.ndarray:
    """Rectangular block interleaver: write row-wise, read column-wise.

    Spreads a burst of up to ``rows`` consecutive channel errors at least
    ``cols`` apart, turning bursts into the scattered errors the Viterbi
    decoder corrects.  len(bits) must equal rows*cols.
    """
    b = jnp.asarray(bits)
    if b.shape[-1] != rows * cols:
        raise ValueError("length must equal rows*cols")
    return b.reshape(rows, cols).T.reshape(-1)


def deinterleave(bits, rows: int, cols: int) -> jnp.ndarray:
    b = jnp.asarray(bits)
    if b.shape[-1] != rows * cols:
        raise ValueError("length must equal rows*cols")
    return b.reshape(cols, rows).T.reshape(-1)


# -------------------------------------------------------- puncturing

# DVB-S / IEEE-standard puncturing patterns for the rate-1/2 mother code:
# row 0 = X (first polynomial) keep-mask over the period, row 1 = Y.
PUNCTURE_2_3 = ((1, 0), (1, 1))
PUNCTURE_3_4 = ((1, 0, 1), (1, 1, 0))
PUNCTURE_5_6 = ((1, 0, 1, 0, 1), (1, 1, 0, 1, 0))
PUNCTURE_7_8 = ((1, 0, 0, 0, 1, 0, 1), (1, 1, 1, 1, 0, 1, 0))


def _puncture_cols(pattern) -> tuple:
    """Static kept-column indices into a (period * n)-wide row."""
    rows = [tuple(r) for r in pattern]
    n = len(rows)
    period = len(rows[0])
    if any(len(r) != period for r in rows):
        raise ValueError("puncture pattern rows must share one period")
    if not any(v for r in rows for v in r):
        raise ValueError("puncture pattern keeps nothing")
    # stream order is interleaved per input bit: [t0_x, t0_y, t1_x, ...]
    keep = [t * n + i for t in range(period) for i in range(n)
            if rows[i][t]]
    return n, period, tuple(keep)


def puncture(coded, pattern) -> jnp.ndarray:
    """Drop coded bits per the keep-pattern (rate 1/n -> higher).

    coded: (T * n,) from conv_encode, with T divisible by the pattern
    period.  Pure static column selection — jit/shard friendly.
    """
    n, period, keep = _puncture_cols(pattern)
    coded = jnp.asarray(coded)
    T = coded.shape[-1] // n
    if coded.shape[-1] % n or T % period:
        raise ValueError(
            f"coded length {coded.shape[-1]} must be a multiple of "
            f"n*period = {n * period}")
    rows = coded.reshape(T // period, period * n)
    return rows[:, list(keep)].reshape(-1)


def depuncture(rx, pattern, hard: bool = False) -> jnp.ndarray:
    """Re-insert erasures: punctured slots become LLR 0.

    rx: the punctured stream — soft LLRs (positive favors bit 0), or
    hard bits with ``hard=True`` (mapped to +-1 LLRs).  Returns the
    full-rate (T * n,) soft stream for ``viterbi_decode(..., soft=True)``
    — an erasure contributes nothing to either branch hypothesis, which
    is exactly the ML treatment of a dropped bit.
    """
    n, period, keep = _puncture_cols(pattern)
    rx = jnp.asarray(rx)
    if hard:
        rx = 1.0 - 2.0 * rx.astype(jnp.float32)
    k = len(keep)
    if rx.shape[-1] % k:
        raise ValueError(
            f"punctured length {rx.shape[-1]} not a multiple of the "
            f"pattern's {k} kept bits")
    rows = rx.reshape(-1, k)
    full = jnp.zeros((rows.shape[0], period * n), rx.dtype)
    full = full.at[:, list(keep)].set(rows)
    return full.reshape(-1)
