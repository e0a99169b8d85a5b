"""GF(2) bit-stream utilities: scramblers and CRC as block ops.

Framing-layer plumbing for the digital-link stack (FEC + interleaver +
modem are in models/): energy-dispersal scramblers and cyclic redundancy
checks.  Both are linear systems over GF(2), which is the whole trick for
the Accelerator formulation:

* the **additive scrambler** XORs a precomputed m-sequence — pure
  elementwise work;
* the **multiplicative (self-synchronizing) descrambler** is feed-forward
  — shifted XORs, fully vectorized; only the scrambler side carries a
  register, via a tiny ``lax.scan``;
* **CRC** folds L input bits at a time through precomputed GF(2)
  matrices: state' = M_L state + C_L chunk (int8 matmul mod 2), a
  ``lax.scan`` over T/L chunks instead of a per-bit loop.  The matrices
  come from the bitwise reference recurrence simulated once on the host.

Conventions: bits are int arrays of 0/1.  ``crc32`` matches
``binascii.crc32`` (IEEE reflected); ``crc16_ccitt`` is CCITT-FALSE
(0x1021, init 0xFFFF, check value 0x29B1 over "123456789").
"""

from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np

from .sequences import m_sequence, MSEQ_TAPS

__all__ = [
    "additive_scramble", "multiplicative_scramble",
    "multiplicative_descramble",
    "crc_compute", "crc32", "crc16_ccitt", "crc_check",
]


# ----------------------------------------------------------- scramblers

def additive_scramble(bits, nbits: int = 15, taps=None,
                      seed: int = 1) -> jnp.ndarray:
    """XOR with a maximal-length sequence (synchronous scrambler).

    Self-inverse: applying it twice with the same parameters restores the
    input (descrambling = scrambling).  Default register: the DVB 15-bit
    generator family (length 32767 before repeating).
    """
    bits = jnp.asarray(bits, jnp.int32)
    n = bits.shape[-1]
    ms = m_sequence(nbits, taps, seed).astype(np.int32)
    reps = -(-n // len(ms))
    pn = jnp.asarray(np.tile(ms, reps)[:n])
    return bits ^ pn


def _taps_mask(taps, nbits: int) -> int:
    mask = 0
    for t in taps:
        if not 1 <= t <= nbits:
            raise ValueError(f"tap {t} outside 1..{nbits}")
        mask |= 1 << (t - 1)
    return mask


def multiplicative_scramble(bits, nbits: int = 7, taps=(7, 4),
                            state: int = 0x7F):
    """Self-synchronizing scrambler (802.11-style x^7 + x^4 + 1 default).

    v[n] = b[n] XOR v[n-t1] XOR v[n-t2] ... — the OUTPUT feeds the
    register, so the receiver recovers alignment after ``nbits`` bits with
    no side channel.  Sequential by construction: a lax.scan carrying the
    packed register (the recurrence is 1 bit deep; block-parallel forms
    exist but the descrambler is the hot direction and is vectorized).
    Returns (scrambled, final_state).
    """
    bits = jnp.asarray(bits, jnp.int32)
    mask = _taps_mask(taps, nbits)
    full = (1 << nbits) - 1

    def step(reg, b):
        fb = jax.lax.population_count(
            jnp.bitwise_and(reg, mask)) & jnp.int32(1)
        v = b ^ fb
        reg = ((reg << 1) | v) & jnp.int32(full)
        return reg, v

    final, out = jax.lax.scan(step, jnp.asarray(state & full, jnp.int32),
                              bits)
    return out, final


def multiplicative_descramble(bits, nbits: int = 7, taps=(7, 4),
                              state: int = 0x7F) -> jnp.ndarray:
    """Inverse of ``multiplicative_scramble`` — feed-forward, vectorized.

    b[n] = v[n] XOR v[n-t1] XOR ... with v the RECEIVED stream, so every
    output is a static shifted-XOR of the input: no scan, no carry.
    ``state`` seeds the v[n<0] history (must match the scrambler's seed
    for the first ``nbits`` outputs; afterwards it self-synchronizes).
    """
    v = jnp.asarray(bits, jnp.int32)
    full = (1 << nbits) - 1
    st = int(state) & full
    # scrambler register holds [.. v[n-2], v[n-1]] packed LSB-newest:
    # bit (t-1) of the register is v[n-t]
    hist = jnp.asarray([(st >> (nbits - 1 - i)) & 1 for i in range(nbits)],
                       jnp.int32)  # oldest .. newest = v[-nbits] .. v[-1]
    ext = jnp.concatenate([hist, v])
    out = v
    for t in taps:
        out = out ^ ext[nbits - t: nbits - t + v.shape[-1]]
    return out


# ------------------------------------------------------------------ CRC

def _bit_step(state: np.ndarray, b: int, poly_vec: np.ndarray,
              reflected: bool) -> np.ndarray:
    """One-bit reference CRC update on a GF(2) state vector (LSB first)."""
    w = len(state)
    if reflected:
        fb = state[0] ^ b          # input enters at the LSB
        out = np.zeros(w, np.int8)
        out[: w - 1] = state[1:]   # right shift
        if fb:
            out ^= poly_vec
    else:
        fb = state[w - 1] ^ b      # input enters at the MSB
        out = np.zeros(w, np.int8)
        out[1:] = state[: w - 1]   # left shift
        if fb:
            out ^= poly_vec
    return out


@lru_cache(maxsize=32)
def _crc_matrices(poly: int, width: int, reflected: bool, nbits: int):
    """(M, C): state' = M state + C chunk over GF(2) for an nbits chunk.

    Columns of M = response to unit states; columns of C = response to
    unit input bits from the zero state (the recurrence is linear, so
    superposition assembles any chunk).  Chunk bit order: index 0 is the
    FIRST bit processed.
    """
    pv = np.array([(poly >> i) & 1 for i in range(width)], np.int8)
    def run(state, bits_):
        s = state.copy()
        for b in bits_:
            s = _bit_step(s, int(b), pv, reflected)
        return s

    zeros_bits = np.zeros(nbits, np.int8)
    M = np.zeros((width, width), np.int8)
    for j in range(width):
        e = np.zeros(width, np.int8)
        e[j] = 1
        M[:, j] = run(e, zeros_bits)
    C = np.zeros((width, nbits), np.int8)
    z = np.zeros(width, np.int8)
    for j in range(nbits):
        bits_ = np.zeros(nbits, np.int8)
        bits_[j] = 1
        C[:, j] = run(z, bits_)
    return M, C


@partial(jax.jit, static_argnames=("poly", "width", "init", "xorout",
                                   "reflected", "chunk"))
def crc_compute(bits, poly: int, width: int, init: int, xorout: int,
                reflected: bool = False, chunk: int = 32) -> jnp.ndarray:
    """CRC of a 0/1 bit array; returns the checksum as a uint32 scalar.

    Bit order: ``bits[0]`` is the first bit on the wire.  For reflected
    CRCs (e.g. CRC-32) bytes are conventionally sent LSB-first — the
    ``crc32`` preset handles that packing.

    The whole-block fold runs ``len(bits)//chunk`` GF(2) mat-vecs inside
    one scan (int32 matmul, mod 2) plus one remainder step.
    """
    bits = jnp.asarray(bits, jnp.int32)
    n = int(bits.shape[-1])
    state0 = jnp.asarray(
        [(init >> i) & 1 for i in range(width)], jnp.int32)

    n_full = n // chunk
    rem = n - n_full * chunk
    state = state0
    if n_full:
        M, C = _crc_matrices(poly, width, reflected, chunk)
        Mj = jnp.asarray(M, jnp.int32)
        Cj = jnp.asarray(C, jnp.int32)
        chunks = bits[: n_full * chunk].reshape(n_full, chunk)

        def step(s, ck):
            return (Mj @ s + Cj @ ck) & 1, None

        state, _ = jax.lax.scan(step, state, chunks)
    if rem:
        Mr, Cr = _crc_matrices(poly, width, reflected, rem)
        state = (jnp.asarray(Mr, jnp.int32) @ state
                 + jnp.asarray(Cr, jnp.int32) @ bits[n - rem:]) & 1
    state = state ^ jnp.asarray(
        [(xorout >> i) & 1 for i in range(width)], jnp.int32)
    weights = jnp.asarray(np.uint32(1) << np.arange(width, dtype=np.uint32))
    return jnp.sum(state.astype(jnp.uint32) * weights)


def _bytes_to_bits_lsb_first(data: bytes) -> np.ndarray:
    a = np.frombuffer(data, np.uint8)
    return ((a[:, None] >> np.arange(8)) & 1).astype(np.int8).reshape(-1)


def _bytes_to_bits_msb_first(data: bytes) -> np.ndarray:
    a = np.frombuffer(data, np.uint8)
    return ((a[:, None] >> np.arange(7, -1, -1)) & 1).astype(
        np.int8).reshape(-1)


def crc32(data) -> int:
    """IEEE CRC-32 (zlib/binascii convention) of bytes or a bit array."""
    if isinstance(data, (bytes, bytearray)):
        data = _bytes_to_bits_lsb_first(bytes(data))
    v = crc_compute(data, poly=0xEDB88320, width=32, init=0xFFFFFFFF,
                    xorout=0xFFFFFFFF, reflected=True)
    return int(v)


def crc16_ccitt(data) -> int:
    """CRC-16/CCITT-FALSE (0x1021, init 0xFFFF) of bytes or a bit array."""
    if isinstance(data, (bytes, bytearray)):
        data = _bytes_to_bits_msb_first(bytes(data))
    v = crc_compute(data, poly=0x1021, width=16, init=0xFFFF,
                    xorout=0x0000, reflected=False)
    return int(v)


def crc_check(bits_with_crc, width: int = 32, **kw) -> bool:
    """Verify a frame whose last ``width`` bits are the transmitted CRC
    (appended in the same wire bit order the preset produced)."""
    bits = np.asarray(bits_with_crc)
    payload, tail = bits[:-width], bits[-width:]
    fn = kw.pop("fn", crc32 if width == 32 else crc16_ccitt)
    got = fn(payload.astype(np.int8))
    if width == 32:
        shifts = np.arange(width, dtype=np.uint64)
    else:
        shifts = np.arange(width - 1, -1, -1).astype(np.uint64)
    sent = int(np.sum(np.left_shift(tail.astype(np.uint64), shifts)))
    return got == sent
