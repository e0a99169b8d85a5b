"""LDPC: QC expansion, systematic GF(2) encoder, min-sum decoder.

The modern-FEC companion to models.fec (convolutional/Viterbi): LDPC is
the capacity-class code of 802.11n/ac, DVB-S2 and 5G, and its decoder is
embarrassingly parallel — exactly the workload this framework exists for.

Formulation of belief propagation (normalized min-sum):

* H is laid out densely per check: a (C, d_max) matrix of variable
  indices + validity mask.  Message routing between variables and edge
  slots is expressed as multiplication by the one-hot edge-incidence
  matrix A ((C*d_max, N)): variable-total scatter-add is ``R @ A`` and
  the per-edge gather is ``S @ A.T`` — both matmuls, so the hot loop has
  no gather/scatter and runs on the matrix units.  One
  ``lax.scan`` carries the check-to-variable messages across iterations.
* The exclude-self check minimum is the classic min1/min2 trick: argmin
  along the degree axis (d_max <= 8ish) picks which of the two smallest
  magnitudes each edge sees, and the sign product excludes self by one
  extra multiply (signs are +-1).
* Decoding BATCHES over codewords: all message tensors carry a leading
  frame axis, so a whole burst of frames decodes in one device program.

Encoding is systematic via the GF(2) row-reduced form of H, computed once
on the host: free (non-pivot) columns carry the information bits and
pivot columns follow by back-substitution — one int8 matmul mod 2
(matmul work) per frame batch, valid for ANY full-row-rank H.

LLR convention matches the rest of the framework (models.linear_mod
``demap_soft`` / models.fec): positive LLR favors bit 0.

The bundled base matrix is the IEEE 802.11n rate-1/2, Z=27 (n=648)
quasi-cyclic prototype; ``qc_expand`` turns any prototype of cyclic-shift
values into a dense parity-check matrix.
"""

from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "qc_expand", "WIFI_N648_R12_Z27", "wifi_ldpc_648",
    "ldpc_encode", "ldpc_decode", "LDPCCode",
]

# IEEE 802.11n-style rate-1/2 prototype, Z=27 (24 block-columns x 12
# block-rows; entries are cyclic right-shifts, None = all-zero block).
_ = None
WIFI_N648_R12_Z27 = [
    [0, _, _, _, 0, 0, _, _, 0, _, _, 0, 1, 0, _, _, _, _, _, _, _, _, _, _],
    [22, 0, _, _, 17, _, 0, 0, 12, _, _, _, _, 0, 0, _, _, _, _, _, _, _, _, _],
    [6, _, 0, _, 10, _, _, _, 24, _, 0, _, _, _, 0, 0, _, _, _, _, _, _, _, _],
    [2, _, _, 0, 20, _, _, _, 25, 0, _, _, _, _, _, 0, 0, _, _, _, _, _, _, _],
    [23, _, _, _, 3, _, _, _, 0, _, 9, 11, _, _, _, _, 0, 0, _, _, _, _, _, _],
    [24, _, 23, 1, 17, _, 3, _, 10, _, _, _, _, _, _, _, _, 0, 0, _, _, _, _, _],
    [25, _, _, _, 8, _, _, _, 7, 18, _, _, 0, _, _, _, _, _, 0, 0, _, _, _, _],
    [13, 24, _, _, 0, _, 8, _, 6, _, _, _, _, _, _, _, _, _, _, 0, 0, _, _, _],
    [7, 20, _, 16, 22, 10, _, _, 23, _, _, _, _, _, _, _, _, _, _, _, 0, 0, _, _],
    [11, _, _, _, 19, _, _, _, 13, _, 3, 17, _, _, _, _, _, _, _, _, _, 0, 0, _],
    [25, _, 8, _, 23, 18, _, 14, 9, _, _, _, _, _, _, _, _, _, _, _, _, _, 0, 0],
    [3, _, _, _, 16, _, _, 2, 25, 5, _, _, 1, _, _, _, _, _, _, _, _, _, _, 0],
]
del _


def qc_expand(base, z: int) -> np.ndarray:
    """Expand a quasi-cyclic prototype to a dense 0/1 parity-check matrix.

    Entry s >= 0 becomes the z x z identity cyclically right-shifted by s;
    None becomes the zero block.
    """
    rows = len(base)
    cols = len(base[0])
    H = np.zeros((rows * z, cols * z), np.int8)
    eye = np.eye(z, dtype=np.int8)
    for r, brow in enumerate(base):
        if len(brow) != cols:
            raise ValueError("ragged prototype")
        for c, s in enumerate(brow):
            if s is None:
                continue
            H[r * z:(r + 1) * z, c * z:(c + 1) * z] = np.roll(
                eye, int(s) % z, axis=1)
    return H


@lru_cache(maxsize=4)
def wifi_ldpc_648() -> "LDPCCode":
    """The bundled 802.11n-style (648, 324) rate-1/2 code."""
    return LDPCCode(qc_expand(WIFI_N648_R12_Z27, 27))


# ------------------------------------------------------- host-side prep

def _rref_gf2(H: np.ndarray):
    """GF(2) row reduction: (R, pivot_cols). R has identity on pivots."""
    R = H.copy().astype(np.int8) & 1
    rows, cols = R.shape
    pivots = []
    r = 0
    for c in range(cols):
        if r == rows:
            break
        sel = np.nonzero(R[r:, c])[0]
        if len(sel) == 0:
            continue
        p = r + sel[0]
        if p != r:
            R[[r, p]] = R[[p, r]]
        elim = np.nonzero(R[:, c])[0]
        for e in elim:
            if e != r:
                R[e] ^= R[r]
        pivots.append(c)
        r += 1
    if r != rows:
        raise ValueError("H is not full row rank")
    return R, np.asarray(pivots)


class _Layout:
    """Host-side precompute shared by encoder and decoder."""

    def __init__(self, H: np.ndarray):
        H = np.asarray(H, np.int8) & 1
        self.H = H
        self.C, self.N = H.shape
        self.K = self.N - self.C
        # encoder: systematic on free columns, pivots by back-substitution
        R, piv = _rref_gf2(H)
        free = np.setdiff1d(np.arange(self.N), piv)
        if len(free) != self.K:
            raise ValueError("unexpected rank structure")
        # pivot bits = F @ info bits (mod 2), F = R[:, free]
        self.pivot_cols = piv
        self.free_cols = free
        self.F = R[:, free].astype(np.int8)
        # codeword assembly / extraction as selection matmuls (no
        # scatters/gathers)
        E_free = np.zeros((self.K, self.N), np.int32)
        E_free[np.arange(self.K), free] = 1
        E_piv = np.zeros((self.C, self.N), np.int32)
        E_piv[np.arange(self.C), piv] = 1
        self.E_free = E_free
        self.E_piv = E_piv
        # decoder: dense per-check adjacency
        deg = H.sum(axis=1)
        self.d_max = int(deg.max())
        vmat = np.zeros((self.C, self.d_max), np.int32)
        mask = np.zeros((self.C, self.d_max), bool)
        for c in range(self.C):
            idx = np.nonzero(H[c])[0]
            vmat[c, : len(idx)] = idx
            mask[c, : len(idx)] = True
        self.vmat = vmat
        self.mask = mask
        # one-hot edge incidence (C*d_max, N): row e = slot, col = its
        # variable (zero row for padding slots).  Routing matmuls ride
        # the matrix units and avoid backend gather/scatter paths entirely.
        A = np.zeros((self.C * self.d_max, self.N), np.float32)
        flat_v = vmat.reshape(-1)
        flat_m = mask.reshape(-1)
        A[np.arange(self.C * self.d_max)[flat_m], flat_v[flat_m]] = 1.0
        self.A = A


@lru_cache(maxsize=8)
def _layout_cached(h_key) -> _Layout:
    H = np.frombuffer(h_key[2], np.int8).reshape(h_key[0], h_key[1])
    return _Layout(H)


def _layout(H) -> _Layout:
    H = np.ascontiguousarray(np.asarray(H, np.int8) & 1)
    return _layout_cached((H.shape[0], H.shape[1], H.tobytes()))


# ------------------------------------------------------------- encoding

def ldpc_encode(info_bits, H) -> jnp.ndarray:
    """Systematic encode: (..., K) info bits -> (..., N) codewords.

    Information bits occupy the free (non-pivot) columns of H in order;
    parity (pivot) bits solve H c = 0 by the host-precomputed GF(2)
    back-substitution matrix — the device work is one int matmul mod 2.
    """
    lay = _layout(H)
    b = jnp.asarray(info_bits, jnp.int32)
    if b.shape[-1] != lay.K:
        raise ValueError(f"expected {lay.K} info bits, got {b.shape[-1]}")
    par = (b @ jnp.asarray(lay.F.T, jnp.int32)) & 1
    # scatter-free assembly: place info/parity via selection matmuls
    return (b @ jnp.asarray(lay.E_free)
            + par @ jnp.asarray(lay.E_piv))


# ------------------------------------------------------------- decoding

@partial(jax.jit, static_argnames=("n_iters", "h_key", "alpha"))
def _decode_jit(llr, h_key, n_iters: int, alpha: float):
    lay = _layout_cached(h_key)
    mask = jnp.asarray(lay.mask)
    A = jnp.asarray(lay.A)                       # (C*d_max, N) one-hot
    llr = jnp.asarray(llr, jnp.float32)
    batch = llr.shape[:-1]
    R0 = jnp.zeros(batch + (lay.C, lay.d_max), jnp.float32)

    big = jnp.float32(np.inf)
    slot_shape = batch + (lay.C, lay.d_max)

    def to_slots(x):                             # S (..., N) -> (..., C, d)
        return (x @ A.T).reshape(slot_shape)

    def from_slots(r):                           # (..., C, d) -> (..., N)
        return r.reshape(batch + (lay.C * lay.d_max,)) @ A

    def iteration(R, _):
        # variable totals S_v = llr + sum of incoming R (scatter = matmul)
        S = llr + from_slots(jnp.where(mask, R, 0.0))
        # variable -> check messages (exclude self); gather = matmul
        Q = to_slots(S) - R
        a = jnp.where(mask, jnp.abs(Q), big)
        s = jnp.where(mask & (Q < 0), jnp.float32(-1), jnp.float32(1))
        # min1/min2 with NO gather ops (no take_along_axis):
        # first-occurrence argmin as a cumsum-gated equality mask, min2
        # by masking it out
        min1 = jnp.min(a, axis=-1, keepdims=True)
        eq = (a == min1)
        is_min = eq & (jnp.cumsum(eq, axis=-1) == 1)
        min2 = jnp.min(jnp.where(is_min, big, a), axis=-1, keepdims=True)
        stot = jnp.prod(s, axis=-1, keepdims=True)
        mag = jnp.where(is_min, min2, min1)
        R_new = jnp.where(mask, jnp.float32(alpha) * stot * s * mag,
                          jnp.float32(0))
        return R_new, None

    R, _ = jax.lax.scan(iteration, R0, None, length=n_iters)
    posterior = llr + from_slots(jnp.where(mask, R, 0.0))
    bits = (posterior < 0).astype(jnp.int32)
    # syndrome: every check XOR-sums to 0 (same routing matmul)
    slot_bits = to_slots(bits.astype(jnp.float32)).astype(jnp.int32)
    chk = jnp.sum(jnp.where(mask, slot_bits, 0), axis=-1) & 1
    ok = jnp.all(chk == 0, axis=-1)
    return bits, ok


def ldpc_decode(llr, H, n_iters: int = 25, alpha: float = 0.75):
    """Normalized min-sum decode of (..., N) LLRs (positive favors 0).

    Returns (codeword_bits (..., N) int32, syndrome_ok (...,) bool).
    ``alpha`` is the standard min-sum normalization (0.75-0.8 recovers
    most of the sum-product gap).  Batches over leading axes.
    """
    lay = _layout(H)  # also validates/caches
    h_key = (lay.C, lay.N, lay.H.tobytes())
    return _decode_jit(jnp.asarray(llr), h_key, int(n_iters), float(alpha))


def ldpc_extract_info(codeword_bits, H) -> jnp.ndarray:
    """Pull the systematic (free-column) info bits back out (matmul)."""
    lay = _layout(H)
    return jnp.asarray(codeword_bits, jnp.int32) @ jnp.asarray(lay.E_free.T)


class LDPCCode:
    """Encode/decode wrapper with host-precomputed layout."""

    def __init__(self, H):
        self._lay = _layout(H)
        self.H = self._lay.H

    @property
    def n(self) -> int:
        return self._lay.N

    @property
    def k(self) -> int:
        return self._lay.K

    @property
    def rate(self) -> float:
        return self._lay.K / self._lay.N

    def encode(self, info_bits) -> jnp.ndarray:
        return ldpc_encode(info_bits, self.H)

    def decode(self, llr, n_iters: int = 25, alpha: float = 0.75):
        """(..., N) LLRs -> (info_bits (..., K), syndrome_ok)."""
        bits, ok = ldpc_decode(llr, self.H, n_iters, alpha)
        return ldpc_extract_info(bits, self.H), ok

    def __repr__(self):
        return (f"LDPCCode [n={self.n}] [k={self.k}] "
                f"[rate={self.rate:.3f}] [d_max={self._lay.d_max}]")
