"""Zero-phase (forward-backward) filtering — offline ``filtfilt``.

The streaming filters (ops/fir.py, ops/iir.py) are causal and therefore
delay/phase-distort; analysis and measurement paths often want the
zero-phase variant instead: run the filter forward, reverse, run again,
reverse.  The magnitude response applies twice (|H|^2) and the phase
cancels exactly.

Formulation: both passes are the existing block-functional filter
cores (conv-as-matmul for FIR, scan/associative-scan w-recurrence for IIR)
inside one jit; the reversals are free layout changes to XLA.  Edge
transients are suppressed scipy-style with odd-reflection padding
(2*(ntaps or 3*nsections) samples at each end, mirrored around the end
samples) so step discontinuities at the block edges do not ring.

The reference framework is streaming-only (no offline analysis filters);
this is new surface in the same spirit as analysis/spectral.py.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .fir import fir_apply, fir_init
from .iir import iir_apply, iir_init, max_pole_radius, sos_cascade_apply, \
    sos_init

__all__ = ["filtfilt_fir", "filtfilt_iir", "filtfilt_sos"]


def _transient_pad(base: int, r: float) -> int:
    """Pad long enough for the slowest pole's transient to decay to 1e-6
    (interior accuracy is pad-independent; this sets EDGE accuracy)."""
    if 0.0 < r < 0.9999:
        return max(base, int(np.ceil(np.log(1e-6) / np.log(r))))
    return base


def _odd_reflect(x, pad: int):
    """Odd reflection around the end samples: 2*x[0] - x[pad:0:-1], etc."""
    if pad <= 0:
        return x
    if x.shape[-1] <= pad:
        raise ValueError(
            f"signal length {x.shape[-1]} must exceed pad {pad}")
    head = 2 * x[..., :1] - x[..., pad:0:-1]
    tail = 2 * x[..., -1:] - x[..., -2:-pad - 2:-1]
    return jnp.concatenate([head, x, tail], axis=-1)


@partial(jax.jit, static_argnames=("pad",))
def _filtfilt_fir(taps, x, pad: int):
    ntaps = taps.shape[-1]
    xe = _odd_reflect(x, pad)
    dtype = jnp.result_type(taps.dtype, xe.dtype)
    tail = fir_init(ntaps, dtype)
    y, _ = fir_apply(taps, tail, xe.astype(dtype))
    y = y[..., ::-1]
    y, _ = fir_apply(taps, tail, y)
    y = y[..., ::-1]
    # forward conv then anticausal conv composes to the tap AUTO-
    # correlation response: symmetric about lag 0, so no delay shift —
    # only the reflection pad (which absorbs both edge transients,
    # pad >= ntaps-1 enforced by the wrapper) is trimmed
    return y[..., pad: y.shape[-1] - pad]


def filtfilt_fir(taps, x, pad: int | None = None) -> jnp.ndarray:
    """Zero-phase FIR filtering.  taps: (ntaps,), x: (..., N).

    Effective magnitude response is |H(f)|^2 with exactly zero phase.
    pad defaults to 2*ntaps (must be < N).
    """
    taps = jnp.asarray(taps)
    x = jnp.asarray(x)
    ntaps = int(taps.shape[-1])
    if pad is None:
        pad = 2 * ntaps
    if pad < ntaps - 1:
        raise ValueError("pad must be at least ntaps-1")
    return _filtfilt_fir(taps, x, int(pad))


@partial(jax.jit, static_argnames=("pad", "method"))
def _filtfilt_iir(b, a_tail, x, pad: int, method: str):
    xe = _odd_reflect(x, pad)
    dtype = jnp.result_type(b.dtype, xe.dtype)
    w0 = iir_init(a_tail.shape[-1], dtype)
    y, _ = iir_apply(b, a_tail, w0, xe.astype(dtype), method=method)
    y, _ = iir_apply(b, a_tail, w0, y[..., ::-1], method=method)
    y = y[..., ::-1]
    return y[..., pad: y.shape[-1] - pad]


def filtfilt_iir(b, a, x, pad: int | None = None,
                 method: str = "parallel") -> jnp.ndarray:
    """Zero-phase IIR filtering with (b, a) coefficients (a[0] == 1).

    Unlike scipy's exact steady-state initialization, edge accuracy
    comes from the odd-reflection pad; the default pad is sized from the
    slowest pole so the edge transient decays below 1e-6 (interior
    samples agree with scipy to machine precision regardless).
    """
    b = jnp.asarray(b)
    a = jnp.asarray(a)
    a_tail = a[..., 1:]
    order = int(a_tail.shape[-1])
    if pad is None:
        pad = _transient_pad(6 * max(order, 1),
                             float(max_pole_radius(np.asarray(a))))
    return _filtfilt_iir(b, a_tail, jnp.asarray(x), int(pad), method)


@partial(jax.jit, static_argnames=("pad", "method"))
def _filtfilt_sos(sos_b, sos_a_tail, x, pad: int, method: str):
    xe = _odd_reflect(x, pad)
    dtype = jnp.result_type(sos_b.dtype, xe.dtype)
    s0 = sos_init(sos_b.shape[0], dtype)
    y, _ = sos_cascade_apply(sos_b, sos_a_tail, s0, xe.astype(dtype),
                             method=method)
    y, _ = sos_cascade_apply(sos_b, sos_a_tail, s0, y[..., ::-1],
                             method=method)
    y = y[..., ::-1]
    return y[..., pad: y.shape[-1] - pad]


def filtfilt_sos(sos_b, sos_a, x, pad: int | None = None,
                 method: str = "parallel") -> jnp.ndarray:
    """Zero-phase filtering through an SOS cascade.

    sos_b: (S, 3) numerators, sos_a: (S, 3) denominators with a0 == 1
    (matching ops.iir.sos_cascade_apply's convention).  The default pad
    is sized from the slowest section pole (see filtfilt_iir).
    """
    sos_b = jnp.asarray(sos_b)
    sos_a = jnp.asarray(sos_a)
    if pad is None:
        r = max(float(max_pole_radius(np.asarray(row)))
                for row in np.asarray(sos_a))
        pad = _transient_pad(18 * int(sos_b.shape[0]), r)
    return _filtfilt_sos(sos_b, sos_a[..., 1:], jnp.asarray(x),
                         int(pad), method)
