"""Short block codes: Hamming, SECDED, Golay, repetition.

Rounds out the FEC stack (convolutional/turbo in fec.py/turbo.py, LDPC,
polar, Reed-Solomon elsewhere) with the classic short binary block codes a
liquid-dsp user expects from the ``fec`` scheme table: Hamming(7,4),
SECDED(8,4), Hamming(12,8), Golay(23,12)/(24,12), SECDED(22,16)/(39,32)/
(72,64), and repetition — the codes used by pagers (POCSAG's BCH(31,21)
lives in pocsag.py), DMR/P25 (Golay), and memory-style parity protection
(SECDED).  The reference itself has no FEC at all (its modulation layer is
an empty stub, SURVEY §2 #33); this module is beyond-reference surface.

Formulation: every encoder is a GF(2) matmul (``(blocks, k) @ (k, n)
mod 2`` — an integer matmul, then a parity mask), and every decoder is
a syndrome matmul followed by a host-precomputed syndrome→error-pattern
lookup table applied as a device gather + XOR.  No per-bit Python loops on
the hot path; all host precomputation is cached per code.

Golay(23,12) is a *perfect* 3-error-correcting code: the 2^11 syndromes are
exactly covered by the 1+23+253+1771 = 2048 error patterns of weight ≤ 3,
so its syndrome LUT corrects every ≤3-bit error pattern with a single
gather.  The extended (24,12) code appends an overall parity bit, which
turns weight-4 errors into detected (flagged) failures.
"""

from __future__ import annotations

from functools import lru_cache

import jax.numpy as jnp
import numpy as np

__all__ = ["gf2_encode", "hamming_matrices", "golay_tables",
           "block_encode", "block_decode", "BlockCode", "SCHEMES"]

# Golay generator polynomial x^11 + x^10 + x^6 + x^5 + x^4 + x^2 + 1.
_GOLAY_GEN = 0b110001110101


# ----------------------------------------------------------------- helpers

def _poly_mod(value: int, gen: int, gen_deg: int) -> int:
    """value(x) mod gen(x) over GF(2), ints as bit-polynomials (host)."""
    d = value.bit_length() - 1
    while d >= gen_deg:
        value ^= gen << (d - gen_deg)
        d = value.bit_length() - 1
    return value


def _bits_msb_first(value: int, width: int) -> np.ndarray:
    return np.array([(value >> (width - 1 - i)) & 1 for i in range(width)],
                    dtype=np.uint8)


def gf2_encode(data, G) -> jnp.ndarray:
    """Batched GF(2) encode: (blocks, k) @ G (k, n) mod 2, an integer matmul."""
    return (jnp.dot(data.astype(jnp.int32), jnp.asarray(G, jnp.int32)) & 1)


# ------------------------------------------------------- Hamming / SECDED

@lru_cache(maxsize=None)
def hamming_matrices(m: int, k: int):
    """Systematic (shortened) Hamming matrices for m parity bits, k data bits.

    Returns ``(G (k, k+m), H (m, k+m), col_ids (k+m,))`` with codewords laid
    out ``[data | parity]``.  Data columns of H are the first k non-power-of-
    two m-bit values (the standard shortening), parity columns the powers of
    two, so each received syndrome equals the H-column (an m-bit int) of the
    flipped bit — ``col_ids`` maps syndrome values back to bit positions.
    """
    if k > (1 << m) - 1 - m:
        raise ValueError(f"Hamming with {m} parity bits supports at most "
                         f"{(1 << m) - 1 - m} data bits, got {k}")
    data_cols = [v for v in range(3, 1 << m) if v & (v - 1)][:k]
    # descending powers so the parity block of H is I_m (MSB-first bits)
    parity_cols = [1 << (m - 1 - i) for i in range(m)]
    cols = np.array(data_cols + parity_cols, dtype=np.int64)
    H = np.stack([_bits_msb_first(int(c), m) for c in cols], axis=1)  # (m, n)
    # Systematic: parity p = P^T d with P^T = data part of H.
    P = H[:, :k].T                                                    # (k, m)
    G = np.concatenate([np.eye(k, dtype=np.uint8), P], axis=1)        # (k, n)
    return G.astype(np.uint8), H.astype(np.uint8), cols


@lru_cache(maxsize=None)
def _hamming_lut(m: int, k: int):
    """Syndrome -> (error row (n,), uncorrectable flag) tables."""
    _, _, cols = hamming_matrices(m, k)
    n = k + m
    errors = np.zeros((1 << m, n), dtype=np.uint8)
    bad = np.ones(1 << m, dtype=np.uint8)
    bad[0] = 0
    for pos, c in enumerate(cols):
        errors[c, pos] = 1
        bad[c] = 0            # a syndrome matching a used column is 1 error
    return errors, bad        # unused-column syndromes stay flagged (shortened)


def _syndrome_int(r, H) -> jnp.ndarray:
    s_bits = jnp.dot(r.astype(jnp.int32), jnp.asarray(H.T, jnp.int32)) & 1
    m = H.shape[0]
    weights = jnp.asarray([1 << (m - 1 - i) for i in range(m)], jnp.int32)
    return jnp.dot(s_bits, weights)


def _hamming_decode(r, m: int, k: int):
    _, H, _ = hamming_matrices(m, k)
    errors, bad = _hamming_lut(m, k)
    s = _syndrome_int(r, H)
    e = jnp.asarray(errors, jnp.int32)[s]
    fail = jnp.asarray(bad, jnp.int32)[s]
    return (r.astype(jnp.int32) ^ e)[:, :k], fail.astype(bool)


def _secded_encode(data, m: int, k: int):
    G, _, _ = hamming_matrices(m, k)
    inner = gf2_encode(data, G)
    overall = jnp.sum(inner, axis=-1) & 1
    return jnp.concatenate([inner, overall[:, None]], axis=-1)


def _secded_decode(r, m: int, k: int):
    """Extended Hamming: correct singles, detect (flag) doubles."""
    _, H, _ = hamming_matrices(m, k)
    errors, bad_lut = _hamming_lut(m, k)
    inner = r[:, :-1]
    s = _syndrome_int(inner, H)
    parity = jnp.sum(r.astype(jnp.int32), axis=-1) & 1
    e = jnp.asarray(errors, jnp.int32)[s]
    corrected = (inner.astype(jnp.int32) ^ e)[:, :k]
    # parity odd  -> odd-weight error: s==0 means the overall bit itself
    #                flipped (data fine); else correct via the LUT.
    # parity even -> s==0 is clean, s!=0 is a detected double error.
    odd = parity == 1
    fail = jnp.where(odd, jnp.asarray(bad_lut, jnp.int32)[s].astype(bool),
                     s != 0)
    return corrected, fail


# ------------------------------------------------------------------ Golay

@lru_cache(maxsize=None)
def golay_tables():
    """Host tables for the perfect (23,12) Golay code.

    Returns ``(G (12, 23), S (23, 11), lut (2048, 23))`` — systematic
    generator, per-bit syndrome columns (bit j of the codeword contributes
    x^(22-j) mod g), and the complete syndrome→error-pattern table built
    from all 2048 weight-≤3 patterns (perfect cover, asserted).
    """
    deg = 11
    P = np.zeros((12, deg), dtype=np.uint8)          # parity of x^(11+i)
    for i in range(12):
        rem = _poly_mod(1 << (22 - i), _GOLAY_GEN, deg)
        P[i] = _bits_msb_first(rem, deg)
    G = np.concatenate([np.eye(12, dtype=np.uint8), P], axis=1)  # (12, 23)
    S = np.zeros((23, deg), dtype=np.uint8)
    for j in range(23):
        S[j] = _bits_msb_first(_poly_mod(1 << (22 - j), _GOLAY_GEN, deg), deg)
    lut = np.zeros((1 << deg, 23), dtype=np.uint8)
    seen = np.zeros(1 << deg, dtype=bool)
    from itertools import combinations
    pw = [1 << (deg - 1 - i) for i in range(deg)]
    syn_of = [int(sum(int(b) * w for b, w in zip(S[j], pw))) for j in range(23)]
    for wgt in (1, 2, 3):
        for pos in combinations(range(23), wgt):
            s = 0
            for p in pos:
                s ^= syn_of[p]
            assert not seen[s], "Golay syndrome collision"
            seen[s] = True
            for p in pos:
                lut[s, p] = 1
    seen[0] = True
    assert seen.all(), "Golay weight-3 patterns must cover every syndrome"
    return G, S, lut


def _golay23_decode(r):
    _, S, lut = golay_tables()
    s_bits = jnp.dot(r.astype(jnp.int32), jnp.asarray(S, jnp.int32)) & 1
    weights = jnp.asarray([1 << (10 - i) for i in range(11)], jnp.int32)
    s = jnp.dot(s_bits, weights)
    e = jnp.asarray(lut, jnp.int32)[s]
    return (r.astype(jnp.int32) ^ e)[:, :12], e


def _golay24_encode(data):
    G, _, _ = golay_tables()
    inner = gf2_encode(data, G)
    overall = jnp.sum(inner, axis=-1) & 1
    return jnp.concatenate([inner, overall[:, None]], axis=-1)


def _golay24_decode(r):
    """Correct ≤3 errors; flag patterns the parity proves were ≥4."""
    data, e = _golay23_decode(r[:, :23])
    nflip = jnp.sum(e, axis=-1)
    parity = jnp.sum(r.astype(jnp.int32), axis=-1) & 1
    # Extended codewords have even weight, so the received overall parity
    # equals the total error weight mod 2; the estimated flip count on the
    # overall bit is parity ^ (nflip mod 2).  Estimated total weight 4
    # (3 in the 23-bit part + 1 implied on the parity bit — which is also
    # what every true weight-4 pattern aliases to, since d(23,12)=7 forces
    # nflip=3 there) is the detected-uncorrectable case.
    est_p24 = parity ^ (nflip & 1)
    fail = (nflip == 3) & (est_p24 == 1)
    return data, fail


# -------------------------------------------------------------- dispatch

SCHEMES = {
    # name: (k, n, description)
    "none": (1, 1, "pass-through"),
    "rep3": (1, 3, "3x repetition, majority vote"),
    "rep5": (1, 5, "5x repetition, majority vote"),
    "h74": (4, 7, "Hamming(7,4), corrects 1"),
    "h84": (4, 8, "SECDED(8,4): corrects 1, detects 2"),
    "h128": (8, 12, "shortened Hamming(12,8), corrects 1"),
    "g2312": (12, 23, "perfect Golay(23,12), corrects 3"),
    "g2412": (12, 24, "extended Golay(24,12): corrects 3, detects 4"),
    "secded2216": (16, 22, "SECDED(22,16)"),
    "secded3932": (32, 39, "SECDED(39,32)"),
    "secded7264": (64, 72, "SECDED(72,64)"),
}

_HAMMING_PARAMS = {"h74": (3, 4), "h128": (4, 8)}
_SECDED_PARAMS = {"h84": (3, 4), "secded2216": (5, 16),
                  "secded3932": (6, 32), "secded7264": (7, 64)}


def _to_blocks(bits, k: int):
    bits = jnp.asarray(bits)
    if bits.ndim == 1:
        if bits.shape[0] % k:
            raise ValueError(f"bit count {bits.shape[0]} not a multiple of "
                             f"k={k}")
        bits = bits.reshape(-1, k)
    elif bits.ndim != 2 or bits.shape[-1] != k:
        raise ValueError(f"expected (n,) or (blocks, {k}) bits, "
                         f"got {bits.shape}")
    return bits


def block_encode(bits, scheme: str) -> jnp.ndarray:
    """Encode a flat bit vector (or (blocks, k) array) -> (blocks, n) bits."""
    if scheme not in SCHEMES:
        raise ValueError(f"unknown scheme {scheme!r}; one of {list(SCHEMES)}")
    k, n, _ = SCHEMES[scheme]
    d = _to_blocks(bits, k).astype(jnp.int32)
    if scheme == "none":
        return d
    if scheme.startswith("rep"):
        return jnp.repeat(d, n, axis=-1)
    if scheme in _HAMMING_PARAMS:
        m, kk = _HAMMING_PARAMS[scheme]
        return gf2_encode(d, hamming_matrices(m, kk)[0])
    if scheme in _SECDED_PARAMS:
        return _secded_encode(d, *_SECDED_PARAMS[scheme])
    if scheme == "g2312":
        return gf2_encode(d, golay_tables()[0])
    return _golay24_encode(d)


def block_decode(bits, scheme: str):
    """Decode (blocks, n) (or flat) hard bits -> ((blocks, k), fail flags).

    ``fail[b]`` is True when block b held a detectable-but-uncorrectable
    error pattern (always False for schemes with no detection headroom).
    """
    if scheme not in SCHEMES:
        raise ValueError(f"unknown scheme {scheme!r}; one of {list(SCHEMES)}")
    k, n, _ = SCHEMES[scheme]
    r = _to_blocks(bits, n).astype(jnp.int32)
    nb = r.shape[0]
    if scheme == "none":
        return r, jnp.zeros(nb, bool)
    if scheme.startswith("rep"):
        votes = jnp.sum(r, axis=-1, keepdims=True)
        return (votes > n // 2).astype(jnp.int32), jnp.zeros(nb, bool)
    if scheme in _HAMMING_PARAMS:
        m, kk = _HAMMING_PARAMS[scheme]
        return _hamming_decode(r, m, kk)
    if scheme in _SECDED_PARAMS:
        return _secded_decode(r, *_SECDED_PARAMS[scheme])
    if scheme == "g2312":
        data, _ = _golay23_decode(r)
        return data, jnp.zeros(nb, bool)
    return _golay24_decode(r)


class BlockCode:
    """liquid-style scheme-by-name block code: ``BlockCode("g2412")``."""

    def __init__(self, scheme: str = "h74"):
        if scheme not in SCHEMES:
            raise ValueError(f"unknown scheme {scheme!r}; "
                             f"one of {list(SCHEMES)}")
        self.scheme = scheme
        self.k, self.n, self.description = SCHEMES[scheme]

    @property
    def rate(self) -> float:
        return self.k / self.n

    def encode(self, bits) -> jnp.ndarray:
        """Flat data bits (multiple of k) -> flat coded bits."""
        return block_encode(bits, self.scheme).reshape(-1)

    def decode(self, bits):
        """Flat coded bits -> (flat data bits, per-block fail flags)."""
        data, fail = block_decode(bits, self.scheme)
        return data.reshape(-1), fail

    def __repr__(self):
        return (f"BlockCode({self.scheme!r}: ({self.n},{self.k}) "
                f"rate {self.rate:.3f} — {self.description})")
