"""Turbo codes: parallel-concatenated RSC + iterative max-log-MAP.

Completes the FEC family (convolutional/Viterbi in models/fec.py,
Reed-Solomon in models/rs.py, LDPC in models/ldpc.py, polar in
models/polar.py) with the classic turbo construction used by LTE/UMTS
and CCSDS telemetry: two identical rate-1 recursive systematic
convolutional (RSC) encoders, the second fed through a quadratic
permutation-polynomial (QPP) interleaver, decoded by iterating two
soft-in/soft-out BCJR decoders that exchange extrinsic information.

The reference framework stops at hard-decision links (its modulation
module is a stub we already exceeded); this module follows the same
"block-functional, scan over irreducible time recurrences, vectorize
over everything else" design used across solid_dsp_tpu:

* the ENCODER is table-driven — one ``lax.scan`` over time whose carry
  is the 3-bit register, all table lookups static gathers;
* each BCJR half-iteration runs the alpha (forward) and beta (backward)
  recurrences as ``lax.scan``s whose per-step work is a pure gather +
  max over the S=2^m state axis (max-log-MAP), so XLA vectorizes the
  state dimension and the only sequential axis is time;
* iteration count is static, so the whole decoder jits into one
  program; blocks batch with ``jax.vmap``.

Default constituent code: LTE's (1, g1/g0) RSC with g0 = 1 + D^2 + D^3,
g1 = 1 + D + D^3, m=3 (3GPP TS 36.212 5.1.3.2).  QPP parameters for common block sizes ship in ``LTE_QPP``;
any (f1, f2) pair is accepted and validated for bijectivity at build
time.

LLR convention matches models/fec.py: POSITIVE favors bit 0.

Flat codeword layout (rate ~1/3, length 3*T + 4*m):
    [ sys(T) | par1(T) | par2(T) |
      tail_sys1(m) | tail_par1(m) | tail_sys2(m) | tail_par2(m) ]
Both trellises are tail-terminated to state 0 (m tail pairs each).
"""

from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["qpp_permutation", "turbo_encode", "turbo_decode",
           "TurboCode", "LTE_QPP"]

# Constituent RSC generator polynomials with NATURAL bit order (bit j =
# coefficient of D^j).  LTE (3GPP 36.212 5.1.3.2) specifies
# g0 = 1 + D^2 + D^3 (feedback) and g1 = 1 + D + D^3 (feedforward) —
# quoted "13/15" in the spec's MSB-first octal, which in natural order
# is fb = 0o15 (0b1101) and ff = 0o13 (0b1011).
DEFAULT_FB = 0o15
DEFAULT_FF = 0o13
DEFAULT_M = 3

# 3GPP TS 36.212 Table 5.1.3-3 QPP parameters (subset of common sizes).
# Every entry is re-validated for bijectivity when used, so an
# off-spec pair fails loudly instead of silently mis-permuting.
LTE_QPP = {
    40: (3, 10), 64: (7, 16), 80: (11, 20), 104: (7, 26),
    128: (15, 32), 160: (21, 120), 256: (15, 32), 320: (21, 120),
    512: (31, 64), 1024: (31, 64), 2048: (31, 64), 6144: (263, 480),
}


def qpp_permutation(K: int, f1: int | None = None,
                    f2: int | None = None) -> np.ndarray:
    """QPP interleaver pi(i) = (f1*i + f2*i^2) mod K, validated.

    With no (f1, f2) the LTE table supplies them; for sizes not
    tabulated a small search finds the first valid pair (f1 odd and
    coprime with K, f2 even) — deterministic, so encoder and decoder
    built independently for the same K agree.  Raises ValueError if the
    polynomial is not a bijection on [0, K).
    """
    if f1 is None or f2 is None:
        if K in LTE_QPP:
            f1, f2 = LTE_QPP[K]
        else:
            f1, f2 = _qpp_search(K)
    i = np.arange(K, dtype=np.int64)
    pi = (f1 * i + f2 * i * i) % K
    if np.unique(pi).size != K:
        raise ValueError(f"QPP({f1},{f2}) mod {K} is not a permutation")
    return pi.astype(np.int32)


def _qpp_search(K: int) -> tuple:
    """First (f1, f2) giving a bijective QPP mod K, f1 near sqrt(K).

    Starting f1 near sqrt(K) (rather than 1) gives the large-spread
    permutations good interleavers need; f2 even preserves the QPP
    contention-free property for even K.
    """
    i = np.arange(K, dtype=np.int64)
    start = max(3, int(np.sqrt(K)) | 1)
    for f2 in range(2, 20 * K, 2):
        for f1 in range(start, start + 2 * K, 2):
            if np.gcd(f1, K) != 1:
                continue
            pi = (f1 * i + f2 * i * i) % K
            if np.unique(pi).size == K:
                return int(f1), int(f2)
    raise ValueError(f"no QPP parameters found for K={K}")


def _masks(fb: int, ff: int, m: int):
    """Register masks with D^1 at the MSB .. D^m at the LSB."""
    fbm = ffm = 0
    for j in range(1, m + 1):
        if (fb >> j) & 1:
            fbm |= 1 << (m - j)
        if (ff >> j) & 1:
            ffm |= 1 << (m - j)
    return fbm, ffm, ff & 1


def _par(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint32)
    for sh in (16, 8, 4, 2, 1):
        x ^= x >> sh
    return (x & 1).astype(np.int32)


@lru_cache(maxsize=8)
def _rsc_tables(fb: int, ff: int, m: int):
    """Forward + inverse trellis tables for the RSC (numpy, cached).

    Returns (ns, p, prev, prev_u, tail_u):
      ns (S,2)      next state for (state, input u)
      p  (S,2)      parity output
      prev (S,2)    the two predecessor states of each state
      prev_u (S,2)  the input bit on each incoming transition
      tail_u (S,)   the input that steers the feedback to 0 (termination)
    """
    S = 1 << m
    fbm, ffm, ff0 = _masks(fb, ff, m)
    s = np.arange(S)[:, None]
    u = np.arange(2)[None, :]
    a = u ^ _par(s & fbm)                      # feedback-resolved bit
    p = (ff0 * a) ^ _par(s & ffm)              # parity out
    ns = (a << (m - 1)) | (s >> 1)
    # invert: state t+1 = n has predecessors s with s >> 1 == n's low bits
    prev = np.empty((S, 2), np.int32)
    prev_u = np.empty((S, 2), np.int32)
    n = np.arange(S)
    a_of_n = n >> (m - 1)
    low = (n & ((1 << (m - 1)) - 1)) << 1
    for c in (0, 1):
        sp = low | c
        prev[:, c] = sp
        prev_u[:, c] = a_of_n ^ _par(sp & fbm)
    tail_u = _par(np.arange(S) & fbm)
    return (ns.astype(np.int32), p.astype(np.int32), prev, prev_u,
            tail_u.astype(np.int32))


def _rsc_encode(bits: jnp.ndarray, fb: int, ff: int, m: int):
    """One RSC constituent: (parity(T,), tail_sys(m,), tail_par(m,))."""
    ns_t, p_t, _, _, tail_t = _rsc_tables(fb, ff, m)
    ns_j, p_j, tail_j = jnp.asarray(ns_t), jnp.asarray(p_t), jnp.asarray(tail_t)

    def step(s, u):
        return ns_j[s, u], p_j[s, u]

    s_end, par = jax.lax.scan(step, jnp.asarray(0, jnp.int32),
                              bits.astype(jnp.int32))

    def tail_step(s, _):
        u = tail_j[s]
        return ns_j[s, u], (u, p_j[s, u])

    _, (tsys, tpar) = jax.lax.scan(tail_step, s_end, None, length=m)
    return par, tsys, tpar


def turbo_encode(bits, perm, fb: int = DEFAULT_FB, ff: int = DEFAULT_FF,
                 m: int = DEFAULT_M) -> jnp.ndarray:
    """Encode (T,) info bits into the flat (3T + 4m,) codeword.

    ``perm`` is the interleaver permutation (see qpp_permutation);
    len(perm) must equal len(bits).
    """
    bits = jnp.asarray(bits, jnp.int32)
    perm = np.asarray(perm)
    if perm.shape[0] != bits.shape[-1]:
        raise ValueError("interleaver length != block length")
    par1, ts1, tp1 = _rsc_encode(bits, fb, ff, m)
    par2, ts2, tp2 = _rsc_encode(bits[perm], fb, ff, m)
    return jnp.concatenate([bits, par1, par2, ts1, tp1, ts2, tp2])


def _bcjr_extrinsic(l_sys, l_par, l_apr, t_sys, t_par, tabs, m: int):
    """Max-log BCJR for one terminated constituent.

    l_sys/l_par/l_apr: (T,) channel systematic / parity / a-priori LLRs
    (positive favors 0); t_sys/t_par: (m,) tail LLRs.  Returns (T,)
    EXTRINSIC LLRs and the (T,) full a-posteriori LLRs.

    The alpha/beta recurrences run as RADIX-R blocked max-plus scans:
    per-step (S, S) transition matrices are built in parallel, R
    consecutive matrices are pre-combined with R-1 PARALLEL max-plus
    products (tropical semiring — associative), and the sequential scan
    runs over T/R block steps instead of T.  Per-step work is tiny, so
    the loop overhead of each scan step dominates and a shorter scan is
    a faster decoder; the within-block prefix products reconstruct every
    per-step alpha/beta exactly (max-plus algebra, identical values to
    the step-by-step scan up to f32 max/add associativity).
    """
    ns_t, p_t, prev_t, prev_u_t, _ = tabs
    ns_j = jnp.asarray(ns_t)
    sgn_p = jnp.asarray(1.0 - 2.0 * p_t, jnp.float32)          # (S,2)
    prev_p = p_t[prev_t, prev_u_t]                             # numpy
    S = ns_t.shape[0]
    NEG = jnp.float32(-1e9)
    R = 8                                                      # radix

    ls = jnp.concatenate([l_sys + l_apr, t_sys]).astype(jnp.float32)
    lp = jnp.concatenate([l_par, t_par]).astype(jnp.float32)
    Tm = ls.shape[-1]
    pad = (-Tm) % R
    # pad with zero-LLR steps: their transition matrices are valid
    # (uniform gammas) and the padded alphas/betas are simply dropped
    lsp = jnp.concatenate([ls, jnp.zeros((pad,), jnp.float32)])
    lpp = jnp.concatenate([lp, jnp.zeros((pad,), jnp.float32)])
    TB = (Tm + pad) // R

    # forward transition matrices M[t, n, s'] = gamma(s' -> n at t), -inf
    # where no transition exists: scatter the (S, 2) incoming-transition
    # tables into dense (S, S) (host-side one-hot masks, numpy)
    in_mask = np.full((S, S, 2), 0.0, np.float32)              # [n, s', c]
    for n in range(S):
        for c in range(2):
            in_mask[n, prev_t[n, c], c] = 1.0
    in_mask_j = jnp.asarray(in_mask)                           # (S, S, 2)
    sgn_pu_d = jnp.asarray(1.0 - 2.0 * prev_u_t, jnp.float32)  # (S,2)
    sgn_pp_d = jnp.asarray(1.0 - 2.0 * prev_p, jnp.float32)

    g_in = 0.5 * (sgn_pu_d * lsp[:, None, None]
                  + sgn_pp_d * lpp[:, None, None])             # (T', S, 2)
    # M[t, n, s'] = max_c in_mask * (g_in) with -inf off-structure
    M = jnp.max(jnp.where(in_mask_j[None], g_in[:, :, None, :], NEG),
                axis=-1)                                       # (T', S, S)

    def mp(A, B):
        """Max-plus product C[.., i, j] = max_k A[.., i, k] + B[.., k, j]."""
        return jnp.max(A[..., :, :, None] + B[..., None, :, :], axis=-2)

    # padded steps must be the max-plus IDENTITY (0 diagonal, -inf off)
    # so the backward terminal condition still applies at index T+m and
    # forward propagation past the end is a no-op
    if pad:
        id_mp = jnp.where(jnp.eye(S, dtype=bool), 0.0, NEG)
        M = M.at[Tm:].set(id_mp)

    # within-block prefixes P[i] = M_{jR+i} (x) ... (x) M_{jR}
    Mb = M.reshape(TB, R, S, S)
    prefixes = [Mb[:, 0]]
    for i in range(1, R):
        prefixes.append(mp(Mb[:, i], prefixes[-1]))
    Pstack = jnp.stack(prefixes, axis=1)                       # (TB, R, S, S)

    def fstep_blk(alpha, Pj):
        # alpha entering the block; emit alphas BEFORE each step
        a_all = jnp.max(Pj + alpha[None, None, :], axis=-1)    # (R, S)
        a_next = a_all[-1]
        a_next = a_next - jnp.max(a_next)
        # alphas[i] = alpha before step i: [alpha, a_all[0..R-2]]
        outs = jnp.concatenate([alpha[None], a_all[:-1]], axis=0)
        return a_next, outs

    alpha0 = jnp.full((S,), NEG).at[0].set(0.0)
    _, alphas_b = jax.lax.scan(fstep_blk, alpha0, Pstack)      # (TB, R, S)
    alphas = alphas_b.reshape(TB * R, S)[:Tm]

    sgn_u = jnp.asarray([1.0, -1.0], jnp.float32)              # u=0, u=1

    # backward matrices N[t, s, n] = gamma(s -> n at t) (outgoing form)
    out_mask = np.full((S, S, 2), 0.0, np.float32)             # [s, n, c]
    for s in range(S):
        for u in range(2):
            out_mask[s, ns_t[s, u], u] = 1.0
    out_mask_j = jnp.asarray(out_mask)
    g_out_t = 0.5 * (sgn_u[None, None, :] * lsp[:, None, None]
                     + sgn_p[None] * lpp[:, None, None])       # (T', S, 2)
    N = jnp.max(jnp.where(out_mask_j[None], g_out_t[:, :, None, :], NEG),
                axis=-1)                                       # (T', S, S)
    if pad:
        N = N.at[Tm:].set(jnp.where(jnp.eye(S, dtype=bool), 0.0, NEG))
    # beta_t = N_t (x) beta_{t+1}; block products run right-to-left
    Nb = N.reshape(TB, R, S, S)
    sufs = [Nb[:, R - 1]]
    for i in range(R - 2, -1, -1):
        sufs.append(mp(Nb[:, i], sufs[-1]))
    # sufs[k] = N_i (x) ... (x) N_{R-1} for i = R-1-k
    Sstack = jnp.stack(sufs[::-1], axis=1)                     # (TB, R, S, S)

    def bstep_blk(beta_next, Sj):
        # betas AFTER each step i: beta_{jR+i+1}; suffix products give
        # beta_{jR+i} = S[i] (x) beta_{(j+1)R}; emit beta_next of step i
        b_all = jnp.max(Sj + beta_next[None, None, :], axis=-1)  # (R, S)
        b_start = b_all[0]
        b_start = b_start - jnp.max(b_start)
        # betas_next[i] = beta after step i = S[i+1]-products: b_all[1:]
        outs = jnp.concatenate([b_all[1:], beta_next[None]], axis=0)
        return b_start, outs

    betaT = jnp.full((S,), NEG).at[0].set(0.0)                 # terminated
    _, betas_b = jax.lax.scan(bstep_blk, betaT, Sstack, reverse=True)
    betas_next = betas_b.reshape(TB * R, S)[:Tm]

    # a-posteriori LLR per step: max over transitions with u=0 minus u=1
    g_out = 0.5 * (sgn_u[None, None, :] * ls[:, None, None]
                   + sgn_p[None] * lp[:, None, None])          # (T+m,S,2)
    metric = alphas[:, :, None] + g_out + betas_next[:, ns_j]  # (T+m,S,2)
    llr = (jnp.max(metric[:, :, 0], axis=-1)
           - jnp.max(metric[:, :, 1], axis=-1))
    T = l_sys.shape[-1]
    llr_info = llr[:T]
    return llr_info - l_sys - l_apr, llr_info


@partial(jax.jit, static_argnames=("n_iter", "fb", "ff", "m"))
def _turbo_decode_perm(rx_llr, perm_j, inv_j, n_iter: int,
                       fb: int, ff: int, m: int):
    tabs = _rsc_tables(fb, ff, m)
    T = perm_j.shape[0]
    ls = rx_llr[:T]
    lp1 = rx_llr[T:2 * T]
    lp2 = rx_llr[2 * T:3 * T]
    t = rx_llr[3 * T:].reshape(4, m)
    ls2 = ls[perm_j]
    apr1 = jnp.zeros_like(ls)
    llr = ls
    for _ in range(n_iter):
        ext1, _ = _bcjr_extrinsic(ls, lp1, apr1, t[0], t[1], tabs, m)
        ext2, llr2 = _bcjr_extrinsic(ls2, lp2, ext1[perm_j],
                                     t[2], t[3], tabs, m)
        apr1 = ext2[inv_j]
        llr = llr2[inv_j]
    return (llr < 0).astype(jnp.int32), llr


def turbo_decode(rx_llr, perm, n_iter: int = 8, fb: int = DEFAULT_FB,
                 ff: int = DEFAULT_FF, m: int = DEFAULT_M):
    """Iteratively decode a flat (3T + 4m,) LLR vector.

    rx_llr: channel LLRs in the turbo_encode layout (positive favors
    bit 0, e.g. 2*y/sigma^2 for BPSK +1 == bit 0).  Returns
    (bits (T,), llr (T,)) — hard decisions and final a-posteriori LLRs.
    Batched inputs decode with ``jax.vmap`` over the leading axis.
    """
    perm = np.asarray(perm, np.int64)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size)
    return _turbo_decode_perm(jnp.asarray(rx_llr, jnp.float32),
                              jnp.asarray(perm.astype(np.int32)),
                              jnp.asarray(inv.astype(np.int32)),
                              int(n_iter), fb, ff, m)


class TurboCode:
    """Convenience wrapper with a fixed block size and interleaver."""

    def __init__(self, K: int, f1: int | None = None,
                 f2: int | None = None, n_iter: int = 8):
        self.K = int(K)
        self.perm = qpp_permutation(self.K, f1, f2)
        self.n_iter = int(n_iter)
        self.m = DEFAULT_M
        self.n_coded = 3 * self.K + 4 * self.m

    @property
    def rate(self) -> float:
        return self.K / self.n_coded

    def encode(self, bits):
        return turbo_encode(bits, self.perm)

    def decode(self, rx_llr, n_iter: int | None = None):
        return turbo_decode(rx_llr, self.perm,
                            self.n_iter if n_iter is None else n_iter)

    def __repr__(self):
        return (f"TurboCode [K={self.K}] [rate={self.rate:.3f}] "
                f"[iters={self.n_iter}]")
