"""Polar codes: Bhattacharyya construction, butterfly encoder, BP decoder.

Fourth FEC family (after convolutional/Viterbi, Reed-Solomon, LDPC —
models/fec.py, rs.py, ldpc.py); the reference has no FEC at all.

accelerator-first choices:

* Encoding is the F^{(x)n} butterfly network — log2(N) stages of block
  XORs on a reshaped lattice (no gathers, no sequential bit loop).
* Decoding uses **belief propagation** on the Arikan factor graph rather
  than successive cancellation: SC is a strictly sequential N-step
  recursion (the classic polar bottleneck), while BP sweeps all N/2
  butterflies of a stage at once with min-sum updates — each iteration is
  2·log2(N) fully vectorized stage updates, and multiple codewords batch
  on the leading axis.
* Construction evolves the Bhattacharyya parameter z -> {2z - z^2, z^2}
  through the polarization levels (design-SNR parameterized) and freezes
  the worst-reliability positions.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["polar_construct", "polar_encode", "polar_decode_bp",
           "PolarCode"]


def polar_construct(n: int, k: int, design_snr_db: float = 2.0) -> np.ndarray:
    """Return the sorted info-bit positions (k best of n) by Bhattacharyya
    reliability at the given design Eb/N0.

    z0 = exp(-R * Eb/N0) for a BPSK-AWGN channel (R = k/n); polarization:
    the minus (upper) branch gets 2z - z^2, the plus (lower) branch z^2.
    Smaller z = more reliable.
    """
    if n & (n - 1) or n <= 0:
        raise ValueError("polar block length must be a power of two")
    if not 0 < k <= n:
        raise ValueError("need 0 < k <= n")
    rate = k / n
    z0 = np.exp(-rate * 10.0 ** (design_snr_db / 10.0))
    z = np.array([z0], np.float64)
    while len(z) < n:
        z = np.concatenate([2.0 * z - z * z, z * z])
    # The doubling above applies ops LSB-outermost; the natural-order
    # butterfly encoder below polarizes with the OUTER combining on the
    # index MSB, so encoder index i sees reliability z[bitrev(i)]
    # (verified empirically against a genie-aided SC per-position error
    # ranking — see tests/test_polar.py).
    nb = int(np.log2(n))
    rev = np.array([int(format(i, f"0{nb}b")[::-1], 2) for i in range(n)])
    info = np.sort(np.argsort(z[rev])[:k]).astype(np.int32)
    return info


@jax.jit
def _butterfly_xor(x: jnp.ndarray) -> jnp.ndarray:
    """Apply the full F^{(x)n} butterfly: log2(N) stages of paired XORs.

    Stage s pairs index i with i + 2^s inside blocks of 2^(s+1); the top
    half becomes top XOR bottom.  x: (..., N) int32 bits.
    """
    N = x.shape[-1]
    n = int(np.log2(N))
    lead = x.shape[:-1]
    for s in range(n):
        d = 1 << s
        v = x.reshape(*lead, N // (2 * d), 2, d)
        top = v[..., 0, :] ^ v[..., 1, :]
        x = jnp.stack([top, v[..., 1, :]], axis=-2).reshape(*lead, N)
    return x


def polar_encode(info_bits, info_set, n: int) -> jnp.ndarray:
    """Encode k info bits -> N-bit codeword (frozen positions = 0)."""
    info_bits = jnp.asarray(info_bits, jnp.int32)
    u = jnp.zeros((*info_bits.shape[:-1], n), jnp.int32)
    u = u.at[..., jnp.asarray(info_set)].set(info_bits)
    return _butterfly_xor(u)


def _minsum(a, b):
    return jnp.sign(a) * jnp.sign(b) * jnp.minimum(jnp.abs(a), jnp.abs(b))


@partial(jax.jit, static_argnames=("n_iters",))
def polar_decode_bp(llr, frozen_mask, n_iters: int = 40):
    """Belief-propagation decode.  llr: (..., N) channel LLRs (positive =
    bit 0 more likely); frozen_mask: (N,) 1.0 where frozen.  Returns
    (u_hat bits (..., N lattice u-side), x_hat re-encoded codeword bits,
    ok (...,) frozen-consistency flag).

    Message lattice: B[0] = u side, B[n] = channel side; stage s
    butterflies pair (i, i + 2^s) within blocks of 2^(s+1):
        L[s][top]   = f(L[s+1][top], L[s+1][bot] + R[s][bot])
        L[s][bot]   = f(R[s][top],  L[s+1][top]) + L[s+1][bot]
        R[s+1][top] = f(R[s][top],  L[s+1][bot] + R[s][bot])
        R[s+1][bot] = f(R[s][top],  L[s+1][top]) + R[s][bot]
    with f = min-sum.  Frozen u positions carry a large prior toward 0.
    """
    llr = jnp.asarray(llr)
    N = llr.shape[-1]
    n = int(np.log2(N))
    lead = llr.shape[:-1]
    BIG = jnp.asarray(1e4, llr.dtype)
    frozen = jnp.asarray(frozen_mask, llr.dtype)

    # R[s] for s=0..n-1 are left-to-right messages INTO stage s's left
    # side; L[s+1] are right-to-left messages into its right side.
    Rmsg = jnp.zeros((n, *lead, N), llr.dtype)
    Rmsg = Rmsg.at[0].set(frozen * BIG)
    Lmsg = jnp.zeros((n, *lead, N), llr.dtype)

    def pairs(t, s):
        d = 1 << s
        v = t.reshape(*t.shape[:-1], N // (2 * d), 2, d)
        return v[..., 0, :], v[..., 1, :]

    def unpairs(top, bot):
        return jnp.stack([top, bot], axis=-2).reshape(*top.shape[:-2], N)

    def body(carry, _):
        Lm, Rm = carry
        # ---- left pass: s = n-1 .. 0, compute L into each left side
        def lstage(Lm, s):
            Lin = llr if s == n - 1 else Lm[s + 1]
            lt, lb = pairs(Lin, s)
            rt, rb = pairs(Rm[s], s)
            out_t = _minsum(lt, lb + rb)
            out_b = _minsum(rt, lt) + lb
            return Lm.at[s].set(unpairs(out_t, out_b))
        for s in range(n - 1, -1, -1):
            Lm = lstage(Lm, s)
        # Lm[s] now holds messages into the LEFT side of stage s; the u-side
        # total LLR is Lm[0] + Rm[0].
        # ---- right pass: s = 0 .. n-1, compute R into each right side
        Rnew = Rm
        for s in range(n):
            Rin = Rnew[s]
            Lin = llr if s == n - 1 else Lm[s + 1]
            lt, lb = pairs(Lin, s)
            rt, rb = pairs(Rin, s)
            out_t = _minsum(rt, lb + rb)
            out_b = _minsum(rt, lt) + rb
            r_right = unpairs(out_t, out_b)
            if s < n - 1:
                Rnew = Rnew.at[s + 1].set(r_right)
        return (Lm, Rnew), None

    (Lmsg, Rmsg), _ = jax.lax.scan(body, (Lmsg, Rmsg), None, length=n_iters)
    u_total = Lmsg[0] + Rmsg[0]
    raw = (u_total < 0).astype(jnp.int32)
    # decode-health indicator: does the graph-side evidence (L messages
    # alone, WITHOUT the huge frozen prior baked into R) agree that every
    # frozen bit is 0?  (False = likely block error.)
    ok = jnp.all(jnp.where(frozen > 0, Lmsg[0] >= 0, True), axis=-1)
    u_hat = jnp.where(frozen > 0, 0, raw)
    x_hat = _butterfly_xor(u_hat)
    return u_hat, x_hat, ok


class PolarCode:
    """(N, K) polar code with BP decoding."""

    def __init__(self, n: int, k: int, design_snr_db: float = 2.0,
                 n_iters: int = 40):
        self.n, self.k = int(n), int(k)
        self.n_iters = int(n_iters)
        self.info_set = polar_construct(self.n, self.k, design_snr_db)
        mask = np.ones(self.n, np.float32)
        mask[self.info_set] = 0.0
        self.frozen_mask = mask

    def encode(self, info_bits) -> jnp.ndarray:
        return polar_encode(info_bits, self.info_set, self.n)

    def decode(self, llr, n_iters: int | None = None):
        """llr (..., N) -> (info_bits (..., K), ok (...,)).

        Same return contract as LDPCCode.decode: ``ok`` is a per-block
        decode-health flag (BP marginals consistent with the frozen
        constraints).  For the re-encoded codeword use polar_decode_bp.
        """
        u_hat, _x_hat, ok = polar_decode_bp(
            llr, self.frozen_mask,
            self.n_iters if n_iters is None else int(n_iters))
        return u_hat[..., jnp.asarray(self.info_set)], ok

    def __repr__(self):
        return f"PolarCode [N={self.n}] [K={self.k}]"
