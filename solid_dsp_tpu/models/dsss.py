"""Direct-sequence spread spectrum: spread / despread / acquire / RAKE.

New model family (the reference has no spread-spectrum support; its
modulation module is an empty stub, src/modulation/mod.rs:1).  Built on
the framework's sequence generators (utils/sequences.py: m-sequences,
Gold codes, Zadoff-Chu) and the conv path:

* spreading is a rank-1 outer product symbol x chip (one broadcast
  multiply);
* despreading is a (T, N) x (N,) matmul;
* code acquisition is one strided correlation over all chip offsets
  (conv1d_mxu), the same machinery as preamble search
  (models/framesync.py);
* the RAKE receiver despreads at several code phases ("fingers") and
  maximum-ratio combines with pilot-estimated finger gains — a batched
  matmul over fingers.

Everything is stateless block processing (burst-oriented, like the other
acquisition paths); chip-rate streaming continuity would ride the same
ChainState pattern if needed.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "dsss_spread",
    "dsss_despread",
    "dsss_acquire",
    "rake_finger_gains",
    "rake_despread",
]


def dsss_spread(symbols, code):
    """Spread: out[t*N + i] = symbols[t] * code[i].

    ``symbols``: (..., T) complex data symbols (any linear constellation);
    ``code``: (N,) chips (+-1 real or unit-modulus complex).
    Returns (..., T*N) chips at the chip rate.
    """
    symbols = jnp.asarray(symbols)
    code = jnp.asarray(code, symbols.dtype)
    chips = symbols[..., None] * code
    return chips.reshape(*symbols.shape[:-1], symbols.shape[-1] * code.shape[-1])


def dsss_despread(x, code):
    """Despread a chip-aligned stream: one (T, N) @ (N,) matmul.

    Returns (..., T) symbol estimates, normalized by the code energy so a
    clean spread-despread loop is the identity.
    """
    x = jnp.asarray(x)
    code = jnp.asarray(code, x.dtype)
    N = code.shape[-1]
    T = x.shape[-1] // N
    blocks = x[..., : T * N].reshape(*x.shape[:-1], T, N)
    return blocks @ jnp.conj(code) / jnp.sum(jnp.abs(code) ** 2)


@partial(jax.jit, static_argnames=("max_offset",))
def dsss_acquire(x, code, max_offset: int):
    """Code acquisition: find the chip-timing offset of the spreading code.

    Correlates ``x`` against the code at every lag in [0, max_offset) and
    sums despread energy over the symbols that fit — one strided
    correlation per lag, batched as a single conv1d_mxu call with the
    code as taps.  Returns (offset, metric) where metric[k] is the mean
    |correlation|^2 at lag k (peak = code-aligned).
    """
    from ..ops.fir import conv1d_mxu

    x = jnp.asarray(x)
    code = jnp.asarray(code, x.dtype)
    N = code.shape[-1]
    # full correlation at every sample lag: c[n] = sum_i conj(code[i]) x[n+i]
    c = conv1d_mxu(x, jnp.conj(code))
    L = c.shape[-1]
    T = (L - max_offset) // N
    # energy of symbol correlations at each candidate offset
    seg = jax.vmap(
        lambda k: jnp.mean(
            jnp.abs(jax.lax.dynamic_slice_in_dim(c, k, T * N, axis=-1)[::N]) ** 2)
    )(jnp.arange(max_offset))
    return jnp.argmax(seg), seg


def rake_finger_gains(x, code, pilots, offsets):
    """Estimate complex path gains at the finger offsets by JOINT least
    squares against the re-spread pilot chips.

    Independent per-finger correlations are biased here: with a short
    repeating code and unit-modulus symbols, the partial autocorrelation
    at a few chips' shift adds coherently across symbols (no long
    scrambling cover to whiten it), so each finger sees a deterministic
    leak of the other paths.  Solving the F x F Gram system
    ``(A^H A) g = A^H x`` with A = [shifted pilot chips] deconvolves the
    known cross-correlations exactly.
    """
    x = jnp.asarray(x)
    pilots = jnp.asarray(pilots, x.dtype)
    ref = dsss_spread(pilots, code)  # (P*N,) known pilot chips
    L = ref.shape[-1]
    refs = jnp.stack([
        jnp.concatenate([jnp.zeros((int(o),), ref.dtype), ref])[:L]
        for o in offsets])  # (F, L)
    gram = jnp.conj(refs) @ refs.T
    rhs = jnp.conj(refs) @ x[..., :L]
    return jnp.linalg.solve(gram, rhs)


def rake_despread(x, code, offsets, gains):
    """RAKE receiver: despread at each finger offset, maximum-ratio
    combine with the (pilot-estimated) complex gains.

    ``offsets``: static python ints (chip delays of the resolved paths);
    ``gains``: (F,) complex.  Returns (..., T) combined symbol estimates,
    normalized so a unit-energy channel yields unit-gain symbols.
    """
    x = jnp.asarray(x)
    fingers = jnp.stack(
        [dsss_despread(jnp.roll(x, -int(o), axis=-1), code) for o in offsets],
        axis=-1)  # (..., T, F)
    g = jnp.asarray(gains, x.dtype)
    return (fingers @ jnp.conj(g)) / jnp.sum(jnp.abs(g) ** 2)
