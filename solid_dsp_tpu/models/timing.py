"""Symbol timing recovery: feedforward Oerder-Meyr + Gardner loop.

New capability (the reference modem layer is empty); completes the QPSK
receive path for streams sampled at sps > 1 samples/symbol.

Two strategies, mirroring the carrier-recovery split in ``qpsk``:

* ``symbol_sync_block`` — accelerator-native feedforward: the Oerder&Meyr squaring
  estimator recovers the fractional timing offset of a whole block in
  closed form (one FFT-bin projection of |x|^2 — zero sequential
  dependency), then a windowed-sinc fractional-delay FIR (taps computed
  in-graph from the traced offset, applied with ``conv1d_mxu``) aligns the
  stream and a strided slice picks the symbol instants.  This is the
  1 Gsample/s-class path.
* ``gardner_scan`` — the classic decision-free Gardner timing PLL as a
  ``lax.scan`` over symbols with in-loop cubic (Farrow) interpolation:
  exact streaming semantics for parity/verification.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.fir import conv1d_mxu

__all__ = ["oerder_meyr_offset", "fractional_delay_taps",
           "symbol_sync_block", "gardner_scan"]


@partial(jax.jit, static_argnames=("sps",))
def oerder_meyr_offset(x: jnp.ndarray, sps: int) -> jnp.ndarray:
    """Feedforward timing estimate in samples, in [-sps/2, sps/2).

    tau = -sps/(2 pi) * arg( sum_n |x[n]|^2 e^{-j 2 pi n / sps} ).
    """
    n = x.shape[-1]
    k = jnp.arange(n)
    ph = jnp.exp(-2j * jnp.pi * k / sps).astype(
        jnp.result_type(x.dtype, jnp.complex64))
    m = jnp.sum(jnp.abs(x) ** 2 * ph, axis=-1)
    return -sps / (2.0 * jnp.pi) * jnp.angle(m)


def fractional_delay_taps(tau, ntaps: int = 17):
    """Windowed-sinc fractional-delay FIR for traced delay ``tau`` in
    (-1, 1) samples; group delay = (ntaps-1)/2 + tau.  ``ntaps`` must be
    odd so the base delay is an integer number of samples."""
    if ntaps % 2 == 0:
        raise ValueError("ntaps must be odd (integer base delay)")
    center = (ntaps - 1) / 2.0
    i = jnp.arange(ntaps)
    t = i - center - tau
    from ..design.windows import hamming

    w = jnp.asarray(hamming(ntaps))  # package-wide window family
    return jnp.sinc(t) * w


@partial(jax.jit, static_argnames=("sps", "ntaps"))
def symbol_sync_block(x: jnp.ndarray, sps: int, ntaps: int = 17):
    """Block symbol synchronizer: returns (symbols, tau_hat).

    ``x``: matched-filtered stream at ``sps`` samples/symbol.  The output
    contains (len(x) - ntaps)//sps - t0 - 1 symbols where
    t0 = ((ntaps-1)//2 + sps)//sps + 1 (head margin + filter edges dropped).
    """
    tau = oerder_meyr_offset(x, sps)  # symbol instants at n = t*sps + tau
    frac = tau - jnp.floor(tau)
    shift = jnp.floor(tau).astype(jnp.int32)
    C = (ntaps - 1) // 2
    h = fractional_delay_taps(frac, ntaps).astype(x.dtype)
    # correlation form: y[n] = sum_i h[i] x[n+i] = x(n + C + frac)
    y = conv1d_mxu(x, h)
    # strobe y at n = t*sps + shift - C  ->  y = x(t*sps + tau)
    t0 = (C + sps) // sps + 1  # static head margin covering shift >= -sps
    n_sym = (x.shape[-1] - ntaps) // sps - t0 - 1
    idx = (t0 + jnp.arange(n_sym)) * sps + shift - C
    idx = jnp.clip(idx, 0, y.shape[-1] - 1)
    syms = jnp.take(y, idx, axis=-1)
    return syms, tau


def gardner_scan(x: jnp.ndarray, sps: int, bandwidth: float = 0.01,
                 mu0: float = 0.0):
    """Gardner timing PLL with cubic interpolation (exact streaming mode).

    Returns (symbols, final_mu).  One symbol per loop iteration; the
    interpolator reads 4 samples around the strobe point.
    """
    sps = int(sps)
    alpha = bandwidth
    beta = bandwidth * bandwidth / 4.0
    n_sym = (x.shape[-1] - 4) // sps - 1

    def interp(base, mu):
        s = jax.lax.dynamic_slice_in_dim(x, base, 4, axis=-1)
        # Farrow cubic (Lagrange) on points at offsets -1, 0, 1, 2
        c0 = s[1]
        c1 = 0.5 * (s[2] - s[0])
        c2 = s[0] - 2.5 * s[1] + 2.0 * s[2] - 0.5 * s[3]
        c3 = 0.5 * (s[3] - s[0]) + 1.5 * (s[1] - s[2])
        return ((c3 * mu + c2) * mu + c1) * mu + c0

    def step(carry, k):
        mu, rate, prev_sym = carry
        pos = k * sps + mu  # strobe position (samples)
        base = jnp.clip(pos.astype(jnp.int32), 1, x.shape[-1] - 3) - 1
        frac = pos - jnp.floor(pos)
        sym = interp(base, frac)
        # midpoint between previous and current symbol
        mid_pos = pos - sps / 2.0
        mbase = jnp.clip(mid_pos.astype(jnp.int32), 1, x.shape[-1] - 3) - 1
        mfrac = mid_pos - jnp.floor(mid_pos)
        mid = interp(mbase, mfrac)
        e = jnp.real(jnp.conj(mid) * (prev_sym - sym))
        rate = rate + beta * e
        mu = mu + alpha * e + rate
        return (mu, rate, sym), sym

    (mu, _, _), syms = jax.lax.scan(
        step,
        (jnp.asarray(mu0, x.real.dtype), jnp.asarray(0.0, x.real.dtype),
         jnp.zeros((), x.dtype)),
        jnp.arange(1, n_sym + 1),
    )
    return syms, mu
