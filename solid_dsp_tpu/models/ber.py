"""Link-level Monte-Carlo simulation: BER/BLER sweeps on device.

The reference has no link simulator (it has no modem layer at all —
src/modulation is an empty stub, SURVEY §2 #33); every SDR framework user
ends up hand-rolling one.  This module makes the textbook symbol-rate AWGN
link a first-class, accelerator-shaped primitive:

* ``ber_sweep`` — uncoded BER across a whole Eb/N0 grid in ONE jitted
  program: the modulated burst is generated once and ``vmap`` fans the
  AWGN + hard-slicing across SNR points, so a 20-point × 1M-bit sweep is a
  single device launch dominated by matmul/elementwise work, not Python.
* ``link_sim`` — coded links: any ``encode``/``decode`` pair (BlockCode,
  ConvCode, LDPCCode, TurboCode, PolarCode, or your own callables) measured
  for BER and BLER per SNR point, with the Eb/N0 → noise-variance mapping
  rate-adjusted so coding gain is reported on the standard axis.

Noise convention matches ``models.channel``: ``ebn0_to_noise_var`` returns
the total complex noise variance N0 (both quadratures), and theory curves
to plot against come from ``models.channel.ber_theory``.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from . import channel as ch
from . import linear_mod as lm

__all__ = ["ber_sweep", "link_sim"]


@partial(jax.jit, static_argnames=("n_points", "kmod"))
def _ber_points(key, tx, bits, pts, nvs, n_points: int, kmod: int):
    def one(k, nv):
        rx = ch.awgn(k, tx, noise_var=nv)
        got = lm.symbols_to_bits(lm.slice_symbols(rx, pts), kmod)
        return jnp.sum(got != bits)
    keys = jax.random.split(key, n_points)
    return jax.vmap(one)(keys, nvs)


def ber_sweep(ebn0_db, scheme: str = "psk", m: int = 4,
              n_bits: int = 1_000_000, seed: int = 0) -> np.ndarray:
    """Uncoded BER at each Eb/N0 point (dB array-like) -> BER array.

    Symbol-rate AWGN model (no pulse shaping) — the channel the closed
    forms in ``models.channel.ber_theory`` describe.  One jit: the burst
    is modulated once, then noise + slicing is vmapped over SNR points
    with independent noise per point.
    """
    ebn0_db = np.atleast_1d(np.asarray(ebn0_db, float))
    kmod = int(np.log2(m))
    n_bits -= n_bits % kmod
    if n_bits <= 0:
        raise ValueError("n_bits must be >= bits-per-symbol")
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, n_bits).astype(np.int32)
    pts = lm.constellation(scheme, m)                   # host numpy
    syms = lm.bits_to_symbols(bits, kmod)
    tx = lm.modulate_symbols(jnp.asarray(syms), jnp.asarray(pts))
    nvs = np.array([ch.ebn0_to_noise_var(e, kmod) for e in ebn0_db])
    errs = _ber_points(jax.random.PRNGKey(seed), tx, jnp.asarray(bits),
                       jnp.asarray(pts), jnp.asarray(nvs),
                       len(ebn0_db), kmod)
    return np.asarray(errs, float) / n_bits


def link_sim(encode, decode, k: int, n: int, ebn0_db, *,
             n_blocks: int = 200, scheme: str = "psk", m: int = 2,
             soft: bool = True, code_rate: float | None = None,
             seed: int = 0) -> dict:
    """Coded-link Monte Carlo: BER + BLER per Eb/N0 point.

    ``encode`` maps data bits ``(blocks, k)`` -> code bits ``(blocks, n)``;
    ``decode`` maps ``(blocks, n)`` LLRs (``soft=True``, positive favors
    bit 0 — the ``linear_mod.demap_soft`` convention every decoder here
    consumes) or hard bits (``soft=False``) back to ``(blocks, k)``; a
    tuple return's first element is taken (BlockCode/LDPC style).  The
    noise variance at each point is rate-adjusted (``code_rate`` defaults
    to k/n) so curves are comparable to uncoded theory on the Eb/N0 axis.

    Returns ``{"ebn0_db", "ber", "bler", "bits_per_point"}``.
    """
    ebn0_db = np.atleast_1d(np.asarray(ebn0_db, float))
    kmod = int(np.log2(m))
    rate = k / n if code_rate is None else float(code_rate)
    rng = np.random.default_rng(seed)
    pts = lm.constellation(scheme, m)
    ber = np.zeros(len(ebn0_db))
    bler = np.zeros(len(ebn0_db))
    for i, e in enumerate(ebn0_db):
        data = rng.integers(0, 2, (n_blocks, k)).astype(np.int32)
        coded = np.asarray(encode(data)).reshape(-1)
        pad = (-len(coded)) % kmod
        flat = np.concatenate([coded, np.zeros(pad, coded.dtype)])
        syms = lm.bits_to_symbols(flat, kmod)
        tx = lm.modulate_symbols(jnp.asarray(syms), jnp.asarray(pts))
        nv = ch.ebn0_to_noise_var(e, kmod, code_rate=rate)
        rx = ch.awgn(jax.random.PRNGKey(seed + 7919 * i), tx, noise_var=nv)
        if soft:
            llr = np.asarray(lm.demap_soft(rx, jnp.asarray(pts), nv))
            obs = llr.reshape(-1)[: len(coded)].reshape(n_blocks, n)
        else:
            idx = np.asarray(lm.slice_symbols(rx, pts))
            hard = np.asarray(lm.symbols_to_bits(jnp.asarray(idx), kmod))
            obs = hard.reshape(-1)[: len(coded)].reshape(n_blocks, n)
        dec = decode(jnp.asarray(obs))
        if isinstance(dec, tuple):
            dec = dec[0]
        dec = np.asarray(dec).reshape(n_blocks, k)
        errs = dec != data
        ber[i] = errs.mean()
        bler[i] = errs.any(axis=1).mean()
    return {"ebn0_db": ebn0_db, "ber": ber, "bler": bler,
            "bits_per_point": n_blocks * k}
