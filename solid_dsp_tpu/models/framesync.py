"""Preamble-based frame synchronization + data-aided CFO/phase estimation.

Completes the acquisition path around utils.sequences: a known preamble
(Zadoff-Chu / Gold / m-sequence BPSK) is located with a normalized matched
filter — one correlation plus a sliding-energy normalization, so the
detection metric |rho| in [0, 1] is invariant to input scale and the
threshold has a constant false-alarm interpretation against noise.

Data-aided estimators on the located preamble:

* ``estimate_cfo_repeated`` — Moose: a [p, p] repeated preamble gives
  cfo = angle(sum conj(x1) x2) / (2 pi L), ML for AWGN, range +-1/(2L).
* ``estimate_cfo_kay``      — phase-slope (Kay) estimator on the
  de-modulated preamble z = x conj(p): works with ANY known preamble,
  wider range (+-1/2 cycle/sample) but noisier.
* ``estimate_phase``        — common phase angle(sum conj(p) x).

``FrameSync`` composes them: detect -> CFO correct -> phase correct ->
return the payload-aligned block.  All transforms are pure block functions
(jit/shard_map friendly); the burst-stream analog with carried state is
``models.detect.BurstDetector`` (energy gate), which this module refines
with symbol-accurate alignment.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.fir import conv1d_mxu

__all__ = [
    "preamble_correlate", "detect_preamble",
    "estimate_cfo_repeated", "estimate_cfo_kay", "estimate_phase",
    "FrameSync", "scan_bursts",
]


def preamble_correlate(x, preamble):
    """Normalized matched-filter metric |rho|^2 per alignment.

    rho[n] = sum_k conj(p[k]) x[n+k] / sqrt(E_p * E_x[n]) with E_x the
    sliding input energy over the preamble span; returns (|rho|^2, raw
    correlation) with index n = candidate START of the preamble.
    |rho| = 1 for a perfect scaled/rotated match (Cauchy-Schwarz).
    """
    x = jnp.asarray(x)
    p = jnp.asarray(preamble).astype(x.dtype)
    L = p.shape[-1]
    rdt = jnp.real(x).dtype
    # conv1d_mxu slides the tap vector forward: out[n] = sum_k h[k] x[n+k];
    # pad L-1 trailing zeros so every start index n = 0..len(x)-1 exists
    tail = jnp.zeros(L - 1, x.dtype)
    corr = conv1d_mxu(jnp.concatenate([x, tail]), jnp.conj(p))
    energy = conv1d_mxu(
        jnp.concatenate([jnp.real(x * jnp.conj(x)), jnp.zeros(L - 1, rdt)]),
        jnp.ones(L, rdt))
    ep = jnp.sum(jnp.real(p * jnp.conj(p)))
    rho2 = jnp.real(corr * jnp.conj(corr)) / (ep * energy + 1e-30)
    return rho2, corr


def detect_preamble(x, preamble, threshold: float = 0.5):
    """Best preamble alignment: (start_index, rho2_peak, found).

    ``found`` is a bool array-scalar (peak exceeded threshold); all three
    are traced values so the caller can lax.cond on them.
    """
    rho2, _ = preamble_correlate(x, preamble)
    idx = jnp.argmax(rho2)
    peak = rho2[idx]
    return idx.astype(jnp.int32), peak, peak >= threshold


def estimate_cfo_repeated(x_pp, L: int):
    """Moose CFO estimate from a received [p, p] repeated preamble.

    x_pp: the 2L samples at the detected preamble start.  Returns
    cycles/sample; unambiguous range +-1/(2L).
    """
    x_pp = jnp.asarray(x_pp)
    x1 = x_pp[..., :L]
    x2 = x_pp[..., L:2 * L]
    acc = jnp.sum(jnp.conj(x1) * x2, axis=-1)
    return jnp.angle(acc) / (2.0 * jnp.pi * L)


def estimate_cfo_kay(x_seg, preamble):
    """Kay phase-slope CFO estimate from any known preamble.

    z = x conj(p) is a constant-amplitude tone at the CFO; the smoothed
    phase-increment average angle(sum z[k+1] conj(z[k])) / 2pi estimates
    it over the full +-0.5 cycles/sample range.
    """
    x_seg = jnp.asarray(x_seg)
    p = jnp.asarray(preamble).astype(x_seg.dtype)
    z = x_seg * jnp.conj(p)
    acc = jnp.sum(z[..., 1:] * jnp.conj(z[..., :-1]), axis=-1)
    return jnp.angle(acc) / (2.0 * jnp.pi)


def estimate_phase(x_seg, preamble):
    """Common-phase estimate angle(sum conj(p) x) on the aligned preamble."""
    x_seg = jnp.asarray(x_seg)
    p = jnp.asarray(preamble).astype(x_seg.dtype)
    return jnp.angle(jnp.sum(jnp.conj(p) * x_seg, axis=-1))


class FrameSync:
    """Detect a [p, p]-preambled frame, correct CFO + phase, extract payload.

    The preamble transmitted is ``concatenate([p, p])`` (repetition gives
    the Moose CFO estimate); ``extract`` returns the payload samples
    after the corrections plus the estimates for telemetry.
    """

    def __init__(self, preamble, payload_len: int, threshold: float = 0.5):
        self.p = np.asarray(preamble)
        self.L = len(self.p)
        self.payload_len = int(payload_len)
        self.threshold = float(threshold)

    def full_preamble(self) -> np.ndarray:
        return np.concatenate([self.p, self.p])

    def extract(self, x):
        """x -> (payload, info dict of start/rho2/cfo/phase/found).

        The input must contain the full frame; payload windows are cut
        with a dynamic slice so the whole routine stays jittable.
        """
        x = jnp.asarray(x)
        pp = jnp.asarray(self.full_preamble()).astype(x.dtype)
        start, peak, found = detect_preamble(x, pp, self.threshold)
        x_pp = jax.lax.dynamic_slice_in_dim(x, start, 2 * self.L)
        cfo = estimate_cfo_repeated(x_pp, self.L)
        # de-rotate from the preamble start so the phase estimate is
        # consistent with the corrected samples
        k = (jnp.arange(x.shape[-1]) - start).astype(jnp.float32)
        xc = x * jnp.exp(-2j * jnp.pi * cfo * k).astype(x.dtype)
        xc = jnp.roll(xc, -start)  # frame at index 0 (traced shift is fine)
        phase = estimate_phase(xc[: 2 * self.L], pp)
        xc = xc * jnp.exp(-1j * phase).astype(x.dtype)
        payload = xc[2 * self.L: 2 * self.L + self.payload_len]
        return payload, {"start": start, "rho2": peak, "found": found,
                         "cfo": cfo, "phase": phase}


def scan_bursts(above, frame_samples: int, margin: int, n_total: int,
                decode_fn, max_bursts: int = 64) -> list:
    """Shared burst-capture scan for the packet modems' receive_stream.

    above: host boolean detection metric (possibly shorter than the
    capture — e.g. a sliding metric).  For each first-crossing d, calls
    ``decode_fn(lo, hi)`` on the slice [d - margin, d + frame_samples +
    margin) clipped to [0, n_total), records ``info["offset"] = lo``,
    and advances past the frame.  Robust to detections near the end of
    the capture (no empty-argmax crash).
    """
    above = np.asarray(above, bool)
    out = []
    pos = 0
    while len(out) < max_bursts and pos < len(above):
        nxt = int(np.argmax(above[pos:]))
        if not above[pos + nxt]:
            break
        d = pos + nxt
        lo = max(0, d - margin)
        hi = min(n_total, d + frame_samples + margin)
        data, info = decode_fn(lo, hi)
        info["offset"] = lo
        out.append((data, info))
        pos = d + frame_samples
    return out
