"""Generic linear modem: M-PSK / M-QAM map, pulse shape, slice, demap.

The reference stubbed its modulation layer entirely (src/modulation/ is an
empty module, SURVEY §2 #33); beyond the required FM/QPSK/AM this module
gives the framework a liquid-dsp-class linear modem family:

* gray-coded constellations: BPSK/QPSK/8PSK/...-PSK, 16/64/256-QAM,
* ideal RRC pulse shaping (zero-stuff + convolution),
* matched filter + decimation receive path,
* nearest-point slicing as ONE distance matmul over the constellation
  (accelerator-native: |y - c|^2 argmin batches as matmuls for any M),
* hard-decision bit demap + SER/BER helpers,
* max-log soft demapping to bit LLRs (``demap_soft``) in the convention
  of ``models.fec.viterbi_decode(soft=True)`` — positive favors bit 0 —
  from the SAME per-point metric matrix the slicer computes.

All transforms are pure block functions; carrier/timing recovery compose
from models.qpsk (4th-power / Costas) and models.timing (Oerder-Meyr,
Gardner).
"""

from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np

from ..design import firdes
from ..ops import fir as fir_ops

__all__ = [
    "psk_constellation", "qam_constellation", "apsk_constellation",
    "constellation",
    "bits_to_symbols", "symbols_to_bits", "modulate_symbols",
    "slice_symbols", "demap_soft", "pulse_shape", "matched_filter",
    "LinearModem",
 "vv_carrier_correct"]


def _gray(n: int) -> np.ndarray:
    k = np.arange(n)
    return k ^ (k >> 1)


@lru_cache(maxsize=32)
def psk_constellation(m: int) -> np.ndarray:
    """Gray-coded M-PSK points, unit energy; index = symbol value."""
    if m < 2 or m & (m - 1):
        raise ValueError("M-PSK order must be a power of two >= 2")
    pts = np.empty(m, dtype=np.complex128)
    # symbol s sits at the phase slot whose gray code equals s
    phase = 2.0 * np.pi * np.arange(m) / m + (np.pi / 4.0 if m == 4 else 0.0)
    pts[_gray(m)] = np.exp(1j * phase)
    return pts


@lru_cache(maxsize=32)
def qam_constellation(m: int) -> np.ndarray:
    """Gray-coded square M-QAM, unit average energy."""
    side = int(np.sqrt(m))
    if side * side != m or side < 2 or side & (side - 1):
        # side must be a power of two: the per-axis gray/bit packing
        # shifts by log2(side) bits
        raise ValueError("M-QAM order must be 4^k (4, 16, 64, 256, ...)")
    levels = 2.0 * np.arange(side) - (side - 1)  # ..., -3, -1, 1, 3, ...
    pts = np.empty(m, dtype=np.complex128)
    gray = _gray(side)
    bits_per_axis = int(np.log2(side))
    for i in range(side):       # I index (high bits)
        for q in range(side):   # Q index (low bits)
            sym = (gray[i] << bits_per_axis) | gray[q]
            pts[sym] = levels[i] + 1j * levels[q]
    return pts / np.sqrt(np.mean(np.abs(pts) ** 2))


@lru_cache(maxsize=8)
def apsk_constellation(m: int) -> np.ndarray:
    """DVB-S2-style M-APSK (4+12 for 16, 4+12+16 for 32), unit energy.

    Ring radii use the DVB-S2 ratios for the mid-rate codes (gamma = 2.7
    for 16APSK; 2.84 / 5.27 for 32APSK — EN 302 307 Table 9/10).  Bit
    mapping: the two MSBs select the ring-quadrant pattern and remaining
    bits the phase within the ring, quasi-Gray within each ring (exact
    DVB-S2 bit labelling differs per code rate; the demapper is mapping-
    agnostic since it scores all points).
    """
    if m == 16:
        rings = [(4, 1.0, np.pi / 4), (12, 2.7, np.pi / 12)]
    elif m == 32:
        rings = [(4, 1.0, np.pi / 4), (12, 2.84, np.pi / 12),
                 (16, 5.27, 0.0)]
    else:
        raise ValueError("APSK order must be 16 or 32")
    pts = []
    for n_pts, radius, phase0 in rings:
        ph = phase0 + 2.0 * np.pi * np.arange(n_pts) / n_pts
        ring = radius * np.exp(1j * ph)
        seg = np.empty(n_pts, np.complex128)
        if n_pts & (n_pts - 1):          # 12-ring: no Gray code exists
            seg[:] = ring
        else:
            # same convention as psk_constellation: symbol _gray(k) sits
            # at phase slot k, so phase-adjacent symbols differ by 1 bit
            seg[_gray(n_pts)] = ring
        pts.append(seg)
    pts = np.concatenate(pts)
    return pts / np.sqrt(np.mean(np.abs(pts) ** 2))


def constellation(scheme: str, m: int) -> np.ndarray:
    if scheme == "psk":
        return psk_constellation(m)
    if scheme == "qam":
        return qam_constellation(m)
    if scheme == "apsk":
        return apsk_constellation(m)
    raise ValueError(f"unknown scheme {scheme!r}")


def bits_to_symbols(bits, bits_per_symbol: int) -> jnp.ndarray:
    """Pack a bit stream (len divisible by k) into symbol values, MSB first."""
    bits = jnp.asarray(bits, jnp.int32)
    k = bits_per_symbol
    b = bits.reshape(-1, k)
    weights = jnp.asarray(1 << np.arange(k - 1, -1, -1), jnp.int32)
    return jnp.sum(b * weights, axis=-1)


def symbols_to_bits(symbols, bits_per_symbol: int) -> jnp.ndarray:
    symbols = jnp.asarray(symbols, jnp.int32)
    k = bits_per_symbol
    shifts = jnp.asarray(np.arange(k - 1, -1, -1), jnp.int32)
    return ((symbols[:, None] >> shifts) & 1).reshape(-1)


def modulate_symbols(symbols, points) -> jnp.ndarray:
    """Symbol values -> constellation points (static gather)."""
    return jnp.asarray(points)[jnp.asarray(symbols, jnp.int32)]


@jax.jit
def slice_symbols(y, points) -> jnp.ndarray:
    """Nearest-constellation-point decision as one distance matmul.

    |y - c|^2 = |y|^2 - 2 Re(y conj(c)) + |c|^2; the |y|^2 term is common
    per sample, so argmax of Re(y conj(c)) - |c|^2/2 over the (T, M)
    matrix decides — a single matmul-friendly outer product for any M.
    """
    y = jnp.asarray(y)
    c = jnp.asarray(points).astype(y.dtype)
    metric = (y[..., None] * jnp.conj(c)).real - 0.5 * (c * jnp.conj(c)).real
    return jnp.argmax(metric, axis=-1).astype(jnp.int32)


def demap_soft(y, points, noise_var=1.0) -> jnp.ndarray:
    """Max-log bit LLRs from received symbols, one row per symbol.

    LLR_i = ln P(b_i=0|y) - ln P(b_i=1|y)
          ~ (min_{c: b_i=1} |y-c|^2 - min_{c: b_i=0} |y-c|^2) / noise_var
    (max-log approximation, AWGN).  Positive favors bit 0 — the convention
    ``models.fec.viterbi_decode(soft=True)`` consumes directly.

    The |y|^2 term of |y-c|^2 is common to both hypotheses and cancels, so
    the LLR reduces to differences of the SAME metric matrix the hard
    slicer computes: m(c) = Re(y conj(c)) - |c|^2/2, giving
    LLR_i = (2/noise_var) * (max_{b_i=0} m - max_{b_i=1} m) — one
    (T, M) matmul-friendly product for all bits of all symbols.

    Returns (T * k,) LLRs, bit order matching ``symbols_to_bits``
    (MSB first within each symbol).
    """
    y = jnp.asarray(y)
    c = jnp.asarray(points).astype(y.dtype)
    m = int(c.shape[-1])
    k = int(np.log2(m))
    metric = (y[..., None] * jnp.conj(c)).real - 0.5 * (c * jnp.conj(c)).real
    neg_inf = jnp.asarray(-np.inf, metric.dtype)
    llrs = []
    for i in range(k):                       # static, k <= 8
        bit_i = (np.arange(m) >> (k - 1 - i)) & 1   # MSB-first bit i of c
        mask1 = jnp.asarray(bit_i == 1)
        m1 = jnp.max(jnp.where(mask1, metric, neg_inf), axis=-1)
        m0 = jnp.max(jnp.where(mask1, neg_inf, metric), axis=-1)
        llrs.append(m0 - m1)
    scale = 2.0 / jnp.asarray(noise_var, metric.dtype)
    return (jnp.stack(llrs, axis=-1) * scale).reshape(-1)


def pulse_shape(iq_symbols, sps: int, delay_symbols: int = 6,
                rolloff: float = 0.35, dtype=jnp.complex64,
                flush: bool = False):
    """Ideal RRC pulse shaping: explicit zero-stuff + convolution.

    With ``flush=False`` the output is n_symbols*sps samples and the
    ring-out of the last 2*delay_symbols symbols is TRUNCATED (their
    pulses are cut mid-flight) — only appropriate for continuous
    streaming where the next block continues the waveform.  Burst
    transmitters must use ``flush=True``: 2*delay_symbols zero symbols
    are shaped after the payload so every symbol's full pulse is
    emitted ((n + 2*delay)*sps samples out); appending zero SAMPLES
    instead erases the tail symbols at the receiver.

    (The class InterpolatingFIRFilter reproduces the reference's
    reversed-branch quirk, which adds a branch-dependent fractional shift
    — see its docstring; modems need the ideal interpolator.)
    """
    iq = jnp.asarray(iq_symbols, dtype)
    if flush:
        iq = jnp.concatenate(
            [iq, jnp.zeros(2 * delay_symbols, dtype)], axis=-1)
    rrc = firdes.firdes_rrcos(sps, delay_symbols, rolloff)
    up = jnp.zeros(iq.shape[-1] * sps, dtype).at[::sps].set(iq)
    x_ext = jnp.concatenate([jnp.zeros(len(rrc) - 1, dtype), up])
    return fir_ops.conv1d_mxu(x_ext, jnp.asarray(rrc, dtype))


def matched_filter(x, sps: int, delay_symbols: int = 6,
                   rolloff: float = 0.35):
    """Receive RRC (matched) filter at the full input rate."""
    x = jnp.asarray(x)
    rrc = firdes.firdes_rrcos(sps, delay_symbols, rolloff)
    x_ext = jnp.concatenate([jnp.zeros(len(rrc) - 1, x.dtype), x])
    return fir_ops.conv1d_mxu(x_ext, jnp.asarray(rrc, x.dtype))


class LinearModem:
    """M-PSK / M-QAM modem with RRC shaping.

    modulate(bits) -> IQ at sps samples/symbol;
    demodulate(iq) -> (bits, symbols) with matched filtering and the
    combined TX+RX RRC group delay compensated.  Carrier/timing offsets are
    assumed corrected upstream (models.qpsk / models.timing).
    """

    def __init__(self, scheme: str = "qam", m: int = 16, sps: int = 4,
                 delay_symbols: int = 6, rolloff: float = 0.35,
                 dtype=jnp.complex64):
        self.points = constellation(scheme, m)
        self.scheme = scheme
        self.m = int(m)
        self.k = int(np.log2(m))
        self.sps = int(sps)
        self.delay_symbols = int(delay_symbols)
        self.rolloff = float(rolloff)
        self.dtype = dtype

    def modulate(self, bits) -> jnp.ndarray:
        """bits -> (n_symbols + 2*delay_symbols) * sps burst samples.

        The flush tail carries the ring-out of the last symbols, so
        demodulate(modulate(bits)) recovers EVERY symbol (no tail loss).
        """
        syms = bits_to_symbols(bits, self.k)
        iq = modulate_symbols(syms, self.points).astype(self.dtype)
        return pulse_shape(iq, self.sps, self.delay_symbols, self.rolloff,
                           self.dtype, flush=True)

    def _symbol_estimates(self, x):
        y = matched_filter(jnp.asarray(x, self.dtype), self.sps,
                           self.delay_symbols, self.rolloff)
        # combined TX+RX RRC delay = 2 * delay_symbols * sps samples
        start = 2 * self.delay_symbols * self.sps
        y_sym = y[start::self.sps]
        # energy-normalize to the unit-average-energy constellations
        return y_sym / jnp.sqrt(
            jnp.mean(jnp.real(y_sym * jnp.conj(y_sym))) + 1e-30)

    def demodulate(self, x):
        y_sym = self._symbol_estimates(x)
        syms = slice_symbols(y_sym, self.points)
        return symbols_to_bits(syms, self.k), syms

    def demodulate_soft(self, x, noise_var=None):
        """Bit LLRs (positive favors 0) for soft-decision decoding.

        When ``noise_var`` is None it is estimated from the decision
        residual: sigma^2 ~ E|y - c_hard|^2 (accurate above ~5 dB SNR,
        and the max-log Viterbi path metric is scale-invariant anyway).
        """
        y_sym = self._symbol_estimates(x)
        if noise_var is None:
            c = jnp.asarray(self.points).astype(y_sym.dtype)
            hard = c[slice_symbols(y_sym, self.points)]
            r = y_sym - hard
            noise_var = jnp.mean(jnp.real(r * jnp.conj(r))) + 1e-12
        return demap_soft(y_sym, self.points, noise_var)


# ---------------------------------------------------- differential PSK

def dpsk_modulate(bits, m: int = 4) -> jnp.ndarray:
    """Differential M-PSK: information rides on PHASE INCREMENTS.

    Each k-bit group gray-selects a phase step 2*pi*g/m; transmitted
    phase indices are the cumulative sum mod m (a parallel jnp.cumsum,
    no scan).  A leading reference symbol (phase 0) is prepended, so
    len(output) = n_symbols + 1.  No carrier-phase recovery is needed
    at the receiver — any constant rotation cancels in the differential
    detector (tested).
    """
    if m < 2 or m & (m - 1):
        raise ValueError("DPSK order must be a power of two >= 2")
    k = int(np.log2(m))
    sym = bits_to_symbols(bits, k)
    gray_slot = jnp.asarray(_gray(m), jnp.int32)[sym]   # increment slots
    idx = jnp.cumsum(gray_slot) % m
    phase = 2.0 * jnp.pi * idx.astype(jnp.float32) / m
    ref = jnp.ones(1, jnp.complex64)
    return jnp.concatenate([ref, jnp.exp(1j * phase).astype(jnp.complex64)])


@partial(jax.jit, static_argnames=("m",))
def dpsk_demodulate(y, m: int = 4) -> jnp.ndarray:
    """Noncoherent differential detection: bits from phase differences.

    d[n] = y[n+1] conj(y[n]) collapses any constant carrier phase (and
    tolerates slow CFO); the increment slot is the nearest multiple of
    2*pi/m, inverse-gray-mapped back to bits.  y: (n_symbols + 1,)
    -> (n_symbols * log2(m),) hard bits.
    """
    if m < 2 or m & (m - 1):
        raise ValueError("DPSK order must be a power of two >= 2")
    k = int(np.log2(m))
    y = jnp.asarray(y)
    d = y[1:] * jnp.conj(y[:-1])
    slot = jnp.round(jnp.angle(d) * m / (2.0 * jnp.pi)).astype(jnp.int32) % m
    # inverse gray permutation (host-side table)
    inv = np.zeros(m, np.int32)
    inv[_gray(m)] = np.arange(m)
    sym = jnp.asarray(inv)[slot]
    return symbols_to_bits(sym, k)


# ------------------------------------- blind carrier phase (V&V)

@partial(jax.jit, static_argnames=("m", "seg_len"))
def vv_carrier_correct(y, m: int = 4, seg_len: int = 64):
    """Viterbi&Viterbi M-th-power carrier phase tracking (pilot-free).

    Raises symbols to the M-th power (wiping M-PSK modulation), averages
    per length-``seg_len`` segment, unwraps the segment phases, divides
    by M, interpolates per symbol, and derotates — the classic
    feedforward tracker for residual CFO + phase noise on M-PSK.
    Returns (y_corrected, phase_trajectory).

    The estimate has the inherent M-fold ambiguity (the constellation
    may come back rotated by a multiple of 2*pi/M): resolve downstream
    with differential coding (dpsk_*), pilots (PacketModem), or a known
    preamble.  Tail symbols beyond the last full segment reuse its
    phase.
    """
    y = jnp.asarray(y)
    if y.ndim != 1:
        raise ValueError("vv_carrier_correct takes a 1-D symbol stream "
                         "(vmap for batches)")
    n = y.shape[-1]
    n_seg = n // seg_len
    if n_seg < 1:
        raise ValueError(f"need at least seg_len={seg_len} symbols")
    yp = (y[: n_seg * seg_len] ** m).reshape(n_seg, seg_len)
    s = jnp.sum(yp, axis=-1)
    # remove the constellation's own M-th-power phase: with this
    # module's convention (psk_constellation) QPSK sits at pi/4 + k
    # pi/2, whose 4th power is -1; all other orders power to +1
    ref = np.pi if m == 4 else 0.0
    ph = jnp.unwrap(jnp.angle(s * np.exp(-1j * ref))) / m  # (n_seg,)
    centers = (jnp.arange(n_seg) + 0.5) * seg_len
    traj = jnp.interp(jnp.arange(n, dtype=ph.dtype), centers, ph)
    return y * jnp.exp(-1j * traj).astype(y.dtype), traj
