"""Quantization, companding, and ADC front-end modeling.

The layer between the native ingest formats (runtime ci8/ci16 IQ) and
link-level simulation: uniform quantizers (with optional subtractive
dither), G.711 mu-law / A-law companders (both the continuous
compressor curves and the 8-bit codec), and a complex ADC model
(clip -> quantize -> optional dither) for studying quantization noise
in receiver chains.

Everything is elementwise work under one jit and batches over any
shape; codecs use arithmetic segment math (no table gathers).

The reference framework has no quantization layer (its IO is float
in/out, src/circular_buffer); this models the fixed-point boundary its
users would hit in real SDR deployments, complementing the runtime's
ci8/ci16 ingest (runtime/__init__.py:34).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["quantize_uniform", "adc_model", "mulaw_compress",
           "mulaw_expand", "alaw_compress", "alaw_expand",
           "mulaw_encode", "mulaw_decode", "alaw_encode", "alaw_decode",
           "sqnr"]


@partial(jax.jit, static_argnames=("bits", "mode"))
def quantize_uniform(x, bits: int, full_scale: float = 1.0,
                     mode: str = "midrise") -> jnp.ndarray:
    """Uniform quantizer on [-full_scale, +full_scale].

    bits: total bits (2^bits levels).  mode "midrise" (no zero level,
    levels at odd multiples of delta/2 — what ADCs do) or "midtread"
    (zero is a level).  Saturates at the rails.  Real arrays only
    (complex callers quantize I/Q separately or use adc_model).
    """
    if bits < 1:
        raise ValueError("bits must be >= 1")
    if mode not in ("midrise", "midtread"):
        raise ValueError(f"unknown mode {mode!r}")
    x = jnp.asarray(x)
    levels = 1 << bits
    delta = 2.0 * full_scale / levels
    if mode == "midrise":
        q = jnp.floor(x / delta) + 0.5
        q = jnp.clip(q, -(levels // 2) + 0.5, levels // 2 - 0.5)
    else:
        q = jnp.round(x / delta)
        q = jnp.clip(q, -(levels // 2), levels // 2 - 1)
    return (q * delta).astype(x.dtype)


@partial(jax.jit, static_argnames=("bits", "dither"))
def adc_model(x, bits: int = 12, full_scale: float = 1.0,
              dither: bool = False, key=None) -> jnp.ndarray:
    """Complex ADC: clip to the rails, midrise-quantize I and Q.

    With ``dither=True`` applies SUBTRACTIVE uniform dither of
    +/- delta/2: Q(x + d) - d, which makes the quantization error
    exactly uniform, white, and independent of the signal (Schuchman's
    condition) at no SNR cost — the known dither is removed again.
    key: jax PRNG key, required when dithering.
    """
    x = jnp.asarray(x)
    if jnp.iscomplexobj(x):
        i, q = jnp.real(x), jnp.imag(x)
    else:
        i, q = x, None
    delta = 2.0 * full_scale / (1 << bits)
    di = dq = None
    if dither:
        if key is None:
            raise ValueError("dither=True requires a PRNG key")
        ki, kq = jax.random.split(key)
        di = jax.random.uniform(ki, i.shape, i.dtype, -delta / 2, delta / 2)
        i = i + di
        if q is not None:
            dq = jax.random.uniform(kq, q.shape, q.dtype,
                                    -delta / 2, delta / 2)
            q = q + dq
    i = quantize_uniform(jnp.clip(i, -full_scale, full_scale), bits,
                         full_scale)
    if di is not None:
        i = i - di
    if q is None:
        return i
    q = quantize_uniform(jnp.clip(q, -full_scale, full_scale), bits,
                         full_scale)
    if dq is not None:
        q = q - dq
    return i + 1j * q


# ------------------------------------------------------------- G.711
_MU = 255.0
_A = 87.6


@partial(jax.jit, static_argnames=("mu",))
def mulaw_compress(x, mu: float = _MU) -> jnp.ndarray:
    """Continuous mu-law compressor: sign(x) ln(1+mu|x|)/ln(1+mu), |x|<=1."""
    x = jnp.asarray(x)
    return jnp.sign(x) * jnp.log1p(mu * jnp.abs(x)) / np.log1p(mu)


@partial(jax.jit, static_argnames=("mu",))
def mulaw_expand(y, mu: float = _MU) -> jnp.ndarray:
    """Inverse of mulaw_compress."""
    y = jnp.asarray(y)
    return jnp.sign(y) * (jnp.exp(jnp.abs(y) * np.log1p(mu)) - 1.0) / mu


@partial(jax.jit, static_argnames=("A",))
def alaw_compress(x, A: float = _A) -> jnp.ndarray:
    """Continuous A-law compressor (ITU G.711 curve), |x| <= 1."""
    x = jnp.asarray(x)
    ax = jnp.abs(x)
    denom = 1.0 + np.log(A)
    small = A * ax / denom
    large = (1.0 + jnp.log(jnp.maximum(A * ax, 1.0))) / denom
    return jnp.sign(x) * jnp.where(ax < 1.0 / A, small, large)


@partial(jax.jit, static_argnames=("A",))
def alaw_expand(y, A: float = _A) -> jnp.ndarray:
    """Inverse of alaw_compress."""
    y = jnp.asarray(y)
    ay = jnp.abs(y)
    denom = 1.0 + np.log(A)
    thr = 1.0 / denom
    small = ay * denom / A
    large = jnp.exp(ay * denom - 1.0) / A
    return jnp.sign(y) * jnp.where(ay < thr, small, large)


@jax.jit
def mulaw_encode(x) -> jnp.ndarray:
    """G.711 mu-law 8-bit codec: float in [-1, 1] -> uint8 codewords.

    Segmented arithmetic form (bias 33, 8 chords x 16 steps on a 14-bit
    mantissa), matching the ITU tables; no lookup gathers.
    """
    x = jnp.asarray(x)
    mag = jnp.clip(jnp.abs(x) * 8159.0, 0, 8159.0)  # 14-bit range
    mag = mag + 33.0
    exp = jnp.floor(jnp.log2(mag)) - 5.0        # chord 0..7
    exp = jnp.clip(exp, 0.0, 7.0)
    mant = jnp.floor(mag / jnp.exp2(exp + 1.0)) - 16.0
    mant = jnp.clip(mant, 0.0, 15.0)
    code = (exp * 16.0 + mant).astype(jnp.uint8)
    sign = (x < 0).astype(jnp.uint8) * jnp.uint8(0x80)
    return (code | sign) ^ jnp.uint8(0xFF)      # G.711 inverts all bits


@jax.jit
def mulaw_decode(code) -> jnp.ndarray:
    """uint8 mu-law codewords -> float in [-1, 1]."""
    c = jnp.asarray(code).astype(jnp.uint8) ^ jnp.uint8(0xFF)
    sign = jnp.where((c & jnp.uint8(0x80)) != 0, -1.0, 1.0)
    c = (c & jnp.uint8(0x7F)).astype(jnp.float32)
    exp = jnp.floor(c / 16.0)
    mant = c - exp * 16.0
    mag = (mant * 2.0 + 33.0) * jnp.exp2(exp) - 33.0
    return sign * mag / 8159.0


@jax.jit
def alaw_encode(x) -> jnp.ndarray:
    """G.711 A-law 8-bit codec: float in [-1, 1] -> uint8 codewords."""
    x = jnp.asarray(x)
    mag = jnp.clip(jnp.abs(x) * 4096.0, 0, 4095.0)  # 13-bit range
    exp = jnp.floor(jnp.log2(jnp.maximum(mag, 1.0))) - 4.0
    exp = jnp.clip(exp, 0.0, 7.0)
    mant = jnp.where(exp < 1.0, jnp.floor(mag / 2.0),
                     jnp.floor(mag / jnp.exp2(exp)) - 16.0)
    mant = jnp.clip(mant, 0.0, 15.0)
    code = (exp * 16.0 + mant).astype(jnp.uint8)
    sign = (x >= 0).astype(jnp.uint8) * jnp.uint8(0x80)
    return (code | sign) ^ jnp.uint8(0x55)      # G.711 even-bit inversion


@jax.jit
def alaw_decode(code) -> jnp.ndarray:
    """uint8 A-law codewords -> float in [-1, 1]."""
    c = jnp.asarray(code).astype(jnp.uint8) ^ jnp.uint8(0x55)
    sign = jnp.where((c & jnp.uint8(0x80)) != 0, 1.0, -1.0)
    c = (c & jnp.uint8(0x7F)).astype(jnp.float32)
    exp = jnp.floor(c / 16.0)
    mant = c - exp * 16.0
    mag = jnp.where(exp < 1.0, mant * 2.0 + 1.0,
                    (mant * 2.0 + 33.0) * jnp.exp2(exp - 1.0))
    return sign * mag / 4096.0


@jax.jit
def sqnr(x, xq) -> jnp.ndarray:
    """Signal-to-quantization-noise ratio in dB along the last axis."""
    x = jnp.asarray(x)
    err = jnp.asarray(xq) - x
    ps = jnp.sum(jnp.abs(x) ** 2, axis=-1)
    pn = jnp.maximum(jnp.sum(jnp.abs(err) ** 2, axis=-1),
                     jnp.finfo(err.real.dtype).tiny)
    return 10.0 * jnp.log10(ps / pn)
