"""QPSK modem: modulation, matched filtering, carrier recovery, slicing.

New capability (the reference's modem layer is an empty stub; the driver's
rx-chain config requires QPSK demod — BASELINE.json config 4).

Two carrier-recovery strategies:

* ``qpsk_carrier_pll`` — decision-directed Costas loop built on the NCO's
  PLL coupling semantics (alpha = bw, beta = sqrt(alpha), nco/mod.rs:124-138)
  as a ``lax.scan``: the exact streaming recovery, vectorizable over
  channels.
* ``qpsk_carrier_block`` — accelerator-native block recovery: raise to the 4th power
  (strips QPSK modulation), one FFT to locate the residual carrier, linear
  phase fit, derotate.  O(n log n) with zero sequential dependency — this is
  the throughput path for the 1 Gsample/s chain.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "GRAY_MAP",
    "qpsk_modulate_symbols",
    "bits_to_symbols",
    "symbols_to_bits",
    "qpsk_slice",
    "qpsk_carrier_block",
    "qpsk_carrier_pll",
    "qpsk_demodulate",
    "symbol_error_rate",
]

# Gray-coded constellation: 2 bits -> unit-energy QPSK point
GRAY_MAP = np.array(
    [1 + 1j, -1 + 1j, 1 - 1j, -1 - 1j], dtype=np.complex128
) / np.sqrt(2.0)


def bits_to_symbols(bits: jnp.ndarray) -> jnp.ndarray:
    """Pairs of bits (MSB first) -> symbol indices 0..3."""
    b = bits.reshape(*bits.shape[:-1], -1, 2)
    return (b[..., 0] * 2 + b[..., 1]).astype(jnp.int32)


def symbols_to_bits(symbols: jnp.ndarray) -> jnp.ndarray:
    b0 = (symbols >> 1) & 1
    b1 = symbols & 1
    return jnp.stack([b0, b1], axis=-1).reshape(*symbols.shape[:-1], -1)


def qpsk_modulate_symbols(symbols: jnp.ndarray) -> jnp.ndarray:
    """Symbol indices -> constellation points."""
    return jnp.take(jnp.asarray(GRAY_MAP), symbols)


def qpsk_slice(x: jnp.ndarray) -> jnp.ndarray:
    """Hard decision back to symbol indices (inverse of the Gray map)."""
    b0 = (jnp.real(x) < 0).astype(jnp.int32)
    b1 = (jnp.imag(x) < 0).astype(jnp.int32)
    return b0 + 2 * b1


@jax.jit
def qpsk_carrier_block(x: jnp.ndarray):
    """Block carrier recovery via the 4th-power spectral line.

    Returns (y, f_hat, phi_hat): derotated samples plus the frequency
    (rad/sample) and phase estimates.  Phase has a pi/2 ambiguity inherent
    to QPSK — resolve with differential coding or pilots upstream.
    """
    n = x.shape[-1]
    x4 = x ** 4
    X = jnp.fft.fft(x4, axis=-1)
    mag = jnp.abs(X)
    k = jnp.argmax(mag, axis=-1)

    def _at(idx):
        return jnp.take_along_axis(mag, (idx % n)[..., None], axis=-1)[..., 0]

    # fractional-bin refinement by parabolic interpolation on |X|
    a, b, c = _at(k - 1), _at(k), _at(k + 1)
    denom = a - 2 * b + c
    delta = jnp.where(jnp.abs(denom) > 1e-12, 0.5 * (a - c) / denom, 0.0)
    # signed fractional bin, wrapped in integers before the fraction is
    # added: (k + delta) % n would round a small negative offset near
    # bin 0 to n (float32 spacing at n is far coarser than delta)
    kd = k.astype(delta.dtype) + delta
    kf = jnp.where(kd > n / 2, (k - n).astype(delta.dtype) + delta, kd)
    f4 = 2.0 * jnp.pi * kf / n
    f_hat = f4 / 4.0
    t = jnp.arange(n)
    z = x4 * jnp.exp(-1j * f4[..., None] * t)
    phi4 = jnp.angle(jnp.sum(z, axis=-1))
    phi_hat = phi4 / 4.0 + jnp.pi / 4.0  # align to the Gray constellation
    y = x * jnp.exp(-1j * (f_hat[..., None] * t + phi_hat[..., None]))
    return y, f_hat, phi_hat


@partial(jax.jit, static_argnames=())
def qpsk_carrier_pll(x: jnp.ndarray, bandwidth=0.01, theta0=0.0, dtheta0=0.0):
    """Decision-directed Costas loop (exact streaming recovery).

    Phase detector: e = angle(y * conj(decision(y))); loop coupling uses the
    reference NCO's alpha/beta form (nco/mod.rs:124-138): freq += e * alpha,
    phase += e * beta with alpha = bw, beta = sqrt(bw).
    Returns (y, (theta_end, dtheta_end)).
    """
    alpha = bandwidth
    beta = jnp.sqrt(bandwidth)
    qmap = jnp.asarray(GRAY_MAP, dtype=x.dtype)

    def step(carry, x_n):
        theta, dtheta = carry
        y_n = x_n * jnp.exp(-1j * theta)
        d = qmap[qpsk_slice(y_n)]
        e = jnp.angle(y_n * jnp.conj(d))
        dtheta = dtheta + alpha * e
        theta = theta + dtheta + beta * e
        return (theta, dtheta), y_n

    (theta, dtheta), y = jax.lax.scan(
        step, (jnp.asarray(theta0, x.real.dtype), jnp.asarray(dtheta0, x.real.dtype)),
        x,
    )
    return y, (theta, dtheta)


def qpsk_demodulate(x: jnp.ndarray, recovery: str = "block", **kw):
    """Full demod: carrier recovery -> slice.  Returns (symbols, corrected)."""
    if recovery == "block":
        y, _, _ = qpsk_carrier_block(x)
    elif recovery == "pll":
        y, _ = qpsk_carrier_pll(x, **kw)
    else:
        y = x
    return qpsk_slice(y), y


def symbol_error_rate(tx_symbols, rx_symbols) -> float:
    """SER with the QPSK pi/2 phase ambiguity resolved (best of 4 rotations)."""
    tx = jnp.take(jnp.asarray(GRAY_MAP), tx_symbols)
    rx = jnp.take(jnp.asarray(GRAY_MAP), rx_symbols)
    best = 1.0
    for r in range(4):
        rot = rx * jnp.exp(1j * jnp.pi / 2 * r)
        ser = float(jnp.mean(qpsk_slice(rot) != qpsk_slice(tx)))
        best = min(best, ser)
    return best
