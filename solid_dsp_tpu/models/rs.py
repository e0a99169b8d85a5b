"""Reed-Solomon over GF(256): the classic byte-oriented outer code.

Completes the FEC family (convolutional/Viterbi + LDPC are in): RS is the
outer code of CCSDS/DVB concatenated links and of storage framing, fixing
burst errors that slip through the inner code.

Formulation: GF(256) addition is XOR and multiplication by a CONSTANT
is linear over GF(2), so every fixed GF(256)-linear map — systematic
parity generation AND syndrome computation — is a binary matrix acting on
the message's bit-planes.  Both run as one int8 matmul mod 2 (matmul work,
identical machinery to utils.bits CRC and models.ldpc encoding), batched
over blocks.  The error-locator stage (Berlekamp-Massey + Chien + Forney)
is data-dependent control flow over at most 2t=32 tiny iterations and runs
host-side ONLY for blocks whose syndrome is nonzero — the always-on device
path stays branch-free.

Presets: RS(255, 223) (t=16, CCSDS-style primitive poly 0x11D) and
RS(204, 188) (DVB framing: t=8, shortened from RS(255, 239) by 51);
``RSCode(nroots, shorten)`` builds any 2t/shortening combination.
"""

from __future__ import annotations

from functools import lru_cache

import jax.numpy as jnp
import numpy as np

__all__ = ["RSCode", "rs_255_223", "rs_204_188"]

_PRIM_POLY = 0x11D  # x^8 + x^4 + x^3 + x^2 + 1


@lru_cache(maxsize=1)
def _gf_tables():
    exp = np.zeros(512, np.int32)
    log = np.zeros(256, np.int32)
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= _PRIM_POLY
    exp[255:510] = exp[:255]
    return exp, log


def _gf_mul(a, b):
    exp, log = _gf_tables()
    a = np.asarray(a, np.int32)
    b = np.asarray(b, np.int32)
    out = exp[(log[a] + log[b]) % 255]
    return np.where((a == 0) | (b == 0), 0, out)


def _gf_div(a, b):
    exp, log = _gf_tables()
    if np.any(b == 0):
        raise ZeroDivisionError("GF division by zero")
    return np.where(a == 0, 0, exp[(log[a] - log[b]) % 255])


def _gf_poly_mul(p, q):
    out = np.zeros(len(p) + len(q) - 1, np.int32)
    for i, c in enumerate(p):
        out[i: i + len(q)] ^= _gf_mul(c, q)
    return out


def _gf_poly_eval(poly, x):
    """Horner evaluate poly (highest degree first) at scalar/array x."""
    y = np.zeros_like(np.asarray(x), np.int32) + poly[0]
    for c in poly[1:]:
        y = _gf_mul(y, x) ^ c
    return y


@lru_cache(maxsize=4)
def _generator_poly(nroots: int) -> tuple:
    """g(x) = prod_{j=1..2t} (x - alpha^j), highest degree first."""
    exp, _ = _gf_tables()
    g = np.array([1], np.int32)
    for j in range(1, nroots + 1):
        g = _gf_poly_mul(g, np.array([1, exp[j]], np.int32))
    return tuple(int(c) for c in g)


def _encode_ref(msg: np.ndarray, nroots: int) -> np.ndarray:
    """Reference systematic encoder: parity = msg*x^2t mod g (LFSR)."""
    g = np.asarray(_generator_poly(nroots), np.int32)[1:]  # monic; drop x^2t
    par = np.zeros(nroots, np.int32)
    for m in msg:
        fb = int(m) ^ int(par[0])
        par[:-1] = par[1:]
        par[-1] = 0
        if fb:
            par ^= _gf_mul(fb, g)
    return par


def _bits(x, width=8):
    """(..., B) bytes -> (..., B*8) bits, MSB first per byte."""
    x = np.asarray(x, np.int32)
    return ((x[..., None] >> np.arange(width - 1, -1, -1)) & 1).reshape(
        *x.shape[:-1], -1)


def _bytes(b):
    """(..., B*8) bits -> (..., B) bytes, MSB first."""
    b = np.asarray(b, np.int32).reshape(*np.asarray(b).shape[:-1], -1, 8)
    return (b << np.arange(7, -1, -1)).sum(-1)


@lru_cache(maxsize=8)
def _parity_matrix_bits(k: int, nroots: int):
    """Binary (nroots*8, k*8) map: message bit-planes -> parity bits."""
    M = np.zeros((nroots * 8, k * 8), np.int8)
    for i in range(k):
        for b in range(8):
            msg = np.zeros(k, np.int32)
            msg[i] = 1 << b
            M[:, i * 8 + (7 - b)] = _bits(
                _encode_ref(msg, nroots)).astype(np.int8)
    return M


@lru_cache(maxsize=8)
def _syndrome_matrix_bits(n: int, nroots: int):
    """Binary (nroots*8, n*8) map: received bit-planes -> syndromes.

    S_j = sum_i r_i alpha^{i*j} evaluated with r_0 = LAST codeword byte
    (codeword is a polynomial, highest degree transmitted first).
    """
    exp, _ = _gf_tables()
    M = np.zeros((nroots * 8, n * 8), np.int8)
    for i in range(n):
        deg = n - 1 - i               # transmitted order -> degree
        for b in range(8):
            r = 1 << b
            s = np.array([_gf_mul(r, exp[(deg * j) % 255])
                          for j in range(1, nroots + 1)], np.int32)
            M[:, i * 8 + (7 - b)] = _bits(s).astype(np.int8)
    return M


class RSCode:
    """RS(255-shorten, 255-nroots-shorten) with t = nroots/2 correction.

    ``shorten`` s removes s leading message bytes (implicitly zero on both
    encode and decode — the standard shortened-code construction).
    """

    def __init__(self, nroots: int = 32, shorten: int = 0):
        if nroots < 2 or nroots % 2 or nroots >= 255:
            raise ValueError("nroots must be even, in [2, 254]")
        if not 0 <= shorten < 255 - nroots:
            raise ValueError(
                f"shorten must be in [0, {255 - nroots})")
        self.nroots = int(nroots)
        self.t = self.nroots // 2
        self.n = 255 - shorten
        self.k = 255 - self.nroots - shorten
        self.shorten = shorten

    # ------------------------------------------------------------ encode

    def encode(self, msg) -> jnp.ndarray:
        """(..., k) message bytes -> (..., n) systematic codewords.

        Device path: one binary matmul mod 2 over the message bit-planes.
        """
        msg = jnp.asarray(msg, jnp.int32)
        if msg.shape[-1] != self.k:
            raise ValueError(f"expected {self.k} message bytes")
        M = _parity_matrix_bits(255 - self.nroots, self.nroots)
        # shortened leading bytes are zero: drop their columns
        M = M[:, self.shorten * 8:]
        mbits = ((msg[..., None] >> jnp.arange(7, -1, -1)) & 1).reshape(
            *msg.shape[:-1], -1)
        pbits = (mbits @ jnp.asarray(M.T, jnp.int32)) & 1
        par = (pbits.reshape(*msg.shape[:-1], self.nroots, 8)
               << jnp.arange(7, -1, -1)).sum(-1)
        return jnp.concatenate([msg, par], axis=-1)

    # ------------------------------------------------------------ decode

    def syndromes(self, rx) -> jnp.ndarray:
        """(..., n) received bytes -> (..., 2t) syndromes (device path)."""
        rx = jnp.asarray(rx, jnp.int32)
        S = _syndrome_matrix_bits(255, self.nroots)[:, self.shorten * 8:]
        rbits = ((rx[..., None] >> jnp.arange(7, -1, -1)) & 1).reshape(
            *rx.shape[:-1], -1)
        sbits = (rbits @ jnp.asarray(S.T, jnp.int32)) & 1
        return (sbits.reshape(*rx.shape[:-1], self.nroots, 8)
                << jnp.arange(7, -1, -1)).sum(-1)

    def _correct_one(self, rx: np.ndarray, synd: np.ndarray,
                     era_degs: tuple = ()):
        """Berlekamp-Massey + Chien + Forney for ONE nonzero-syndrome block.

        ``era_degs``: known-unreliable positions as Chien DEGREES
        (deg = n-1-index).  Errors-and-erasures decoding corrects nu
        errors plus mu erasures while 2*nu + mu <= 2t: BM runs on the
        erasure-MODIFIED syndromes T = S * Gamma mod x^2t (Gamma the
        erasure locator), for 2t - mu iterations, and the combined
        locator Psi = Lambda * Gamma feeds the usual Chien/Forney.
        Returns (corrected bytes, ok).
        """
        exp, log = _gf_tables()
        nroots = self.nroots
        mu = len(era_degs)
        if mu > nroots:
            return rx, False
        # initialize Lambda with the erasure locator
        # Gamma(x) = prod (1 + alpha^deg x), lowest first — the classic
        # errors-and-erasures BM (Karn's structure): B starts equal to
        # Lambda and the length condition is offset by mu
        Lam = np.zeros(nroots + 1, np.int32)
        Lam[0] = 1
        for deg in era_degs:
            X = int(exp[int(deg) % 255])
            shifted = np.roll(Lam, 1)
            shifted[0] = 0
            Lam = Lam ^ _gf_mul(X, shifted)
        Bpoly = Lam.copy()
        L = mu                                # combined locator length
        for r in range(mu + 1, nroots + 1):
            d = 0
            for i in range(0, min(r, nroots + 1)):
                if r - 1 - i >= 0 and Lam[i]:
                    d ^= _gf_mul(int(Lam[i]), int(synd[r - 1 - i]))
            d = int(d)
            Bs = np.roll(Bpoly, 1)
            Bs[0] = 0
            if d == 0:
                Bpoly = Bs
            else:
                T = Lam ^ _gf_mul(d, Bs)
                if 2 * L <= r + mu - 1:
                    L = r + mu - L
                    Bpoly = _gf_mul(_gf_div(1, d), Lam)
                else:
                    Bpoly = Bs
                Lam = T
        n_loc = L
        # generalized decode budget: nu = n_loc - mu errors need
        # 2*nu + mu <= 2t, i.e. 2*n_loc - mu <= nroots (reduces to the
        # classic L <= t at mu = 0); beyond it the locator is noise
        if 2 * n_loc - mu > nroots:
            return rx, False
        # Chien search over valid positions (degree 0..n-1); Lambda now
        # carries erasure AND error roots
        degs = np.arange(self.n)
        Xinv = exp[(255 - degs) % 255]        # alpha^{-deg}
        lam_hi = Lam[: n_loc + 1][::-1]       # highest degree first
        vals = _gf_poly_eval(lam_hi, Xinv)
        err_deg = degs[vals == 0]
        if len(err_deg) != n_loc:
            return rx, False                  # locator roots missing
        # Forney: Omega = S(x) * Lambda(x) mod x^2t
        Sp = np.zeros(nroots, np.int32)
        Sp[:] = synd
        Om = np.zeros(nroots, np.int32)
        for i in range(min(n_loc, nroots - 1) + 1):
            Om[i:] ^= _gf_mul(int(Lam[i]), Sp[: nroots - i])
        L = n_loc
        out = rx.copy()
        for deg in err_deg:
            # with S_j starting at j=1, e_l = Omega(X^-1) / Lambda'(X^-1)
            # (single-error check: Omega = e*X const, Lambda' = X)
            xinv = exp[(255 - int(deg)) % 255]
            num = _gf_poly_eval(Om[:nroots][::-1], xinv)
            # Lambda'(x): formal derivative = odd-power terms
            den = 0
            for i in range(1, L + 1, 2):
                den ^= _gf_mul(Lam[i], exp[((i - 1) * (255 - int(deg)))
                                           % 255])
            if den == 0:
                return rx, False
            out[self.n - 1 - deg] ^= int(_gf_div(int(num), int(den)))
        return out, True

    def decode(self, rx, erasures=None):
        """(..., n) received bytes -> (msg (..., k), ok (...,) bool).

        ``erasures``: optional (..., n) boolean mask of known-unreliable
        byte positions (e.g. from inner-code failure flags or demodulator
        confidence).  Errors-and-erasures decoding then corrects nu
        errors + mu erasures while 2*nu + mu <= 2t — up to DOUBLE the
        correction radius when locations are known.  Syndromes batch on
        device; only errored blocks fall to the host locator solve.
        ``ok`` False = beyond the correction budget.
        """
        rx = np.asarray(rx, np.int32)
        flat = rx.reshape(-1, self.n)
        synd = np.asarray(self.syndromes(flat))
        era = None
        if erasures is not None:
            era = np.asarray(erasures, bool).reshape(-1, self.n)
            if era.shape != flat.shape:
                raise ValueError("erasure mask must match rx shape")
        ok = np.ones(len(flat), bool)
        out = flat.copy()
        for i in np.nonzero(synd.any(axis=-1))[0]:
            degs = ()
            if era is not None:
                degs = tuple(self.n - 1 - np.nonzero(era[i])[0])
            out[i], ok[i] = self._correct_one(flat[i], synd[i], degs)
        return (jnp.asarray(out[:, : self.k].reshape(rx.shape[:-1]
                                                     + (self.k,))),
                jnp.asarray(ok.reshape(rx.shape[:-1])))

    def __repr__(self):
        return f"RSCode [n={self.n}] [k={self.k}] [t={self.t}]"


def rs_255_223() -> RSCode:
    return RSCode(nroots=32)


def rs_204_188() -> RSCode:
    return RSCode(nroots=16, shorten=51)
