"""FFT engine: liquid-dsp-style planner + XLA execution.

Parity: reference ``src/fft/`` — planner/dispatch (mod.rs:16-215, method
selection :123-143), direct DFT + codelets (dft/mod.rs), radix-2
(radix2/mod.rs), mixed-radix P*Q decomposition (mixed_radix/mod.rs:9-130),
Rader for primes with pow2 N-1 (rader/mod.rs:9-89) and Rader2 for any prime
via pow2 zero-padding (rader2/mod.rs:9-103).

Conventions (pinned by golden tests, since the reference's FFT has none):
* FORWARD = sum_n x[n] e^{-2 pi i n k / N}; REVERSE uses e^{+...};
* neither direction normalizes by 1/N (the reference's Rader paths divide by
  their internal convolution length only to undo their own internal inverse
  FFT — the overall transform is the plain unnormalized DFT for all sizes).

Execution:
* ``backend="auto"`` / ``"xla"`` — jnp.fft for any size (cuFFT on the
  GPU, pocketfft on the CPU);
* ``backend="plan"`` — structural execution of the reference's plan tree,
  where DFT codelets become matmuls against exact DFT matrices, the
  mixed-radix split becomes reshape -> batched sub-FFT -> twiddle ->
  batched sub-FFT -> transpose (a 2D decomposition that is natively
  batched/shardable), and Rader's permutations become static gathers.
  Everything is static-shaped and works under jit/vmap/shard_map for ANY
  size, including primes (the parity path);
* ``backend="matmul"`` (4-step DFT as matmuls, ops/matfft.py) and
  ``backend="bluestein"`` (chirp-z) — explicit alternatives.

Note: the reference's N=16 codelet uses 8-digit twiddle constants
(dft/mod.rs:39-45), so its pow2 results differ from the exact DFT at ~1e-8;
we use exact twiddles (≈160 dB SNR vs the reference, far above the 60 dB
gate).  RADIX2 exists in the reference but is unreachable from its method
selection (fft/mod.rs:123-143); we keep the method enum for parity and plan
pow2 sizes through MIXEDRADIX exactly as the reference does.
"""

from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np

from ..design import resources
from ..design.windows import get_window

__all__ = [
    "FFTDirection",
    "FFTMethod",
    "estimate_method",
    "FFTPlan",
    "FFT",
    "fft",
    "ifft",
    "windowed_fft",
    "spectrogram",
    "welch_psd",
    "goertzel",
]


class FFTDirection:
    FORWARD = "forward"
    REVERSE = "reverse"


class FFTMethod:
    DEFAULT = "default"
    RADIX2 = "radix2"
    MIXEDRADIX = "mixedradix"
    RADER = "rader"
    RADER2 = "rader2"
    DFT = "dft"
    UNKNOWN = "unknown"


def estimate_method(nfft: int) -> str:
    """Plan-method selection.  Parity: ref fft/mod.rs:123-143."""
    if nfft == 0:
        return FFTMethod.UNKNOWN
    if nfft <= 8 or nfft in (11, 13, 16, 17):
        return FFTMethod.DFT
    if resources.is_pow2(nfft):
        return FFTMethod.MIXEDRADIX  # sic — RADIX2 is unreachable in the ref
    if resources.is_prime(nfft):
        if resources.is_pow2(nfft - 1):
            return FFTMethod.RADER
        return FFTMethod.RADER2
    return FFTMethod.MIXEDRADIX


def _estimate_mixed_radix_q(nfft: int) -> int:
    """Radix pick.  Parity: ref mixed_radix/mod.rs:9-38."""
    factors = resources.factor(nfft)
    if len(factors) < 2:
        return 0
    num_factors_2 = 0
    for i, j in enumerate(factors):
        num_factors_2 = i
        if j != 2:
            break
    if num_factors_2 > 0:
        for q in (16, 8, 4, 2):
            if nfft % q == 0:
                return q
    return factors[0]


def _dft_matrix(n: int, sign: float) -> np.ndarray:
    k = np.arange(n)
    return np.exp(sign * 2j * np.pi * np.outer(k, k) / n)


class FFTPlan:
    """A printable plan tree mirroring the reference's recursive planner."""

    def __init__(self, nfft: int, direction: str = FFTDirection.FORWARD):
        self.nfft = int(nfft)
        self.direction = direction
        self.method = estimate_method(self.nfft)
        self.sign = -1.0 if direction == FFTDirection.FORWARD else 1.0
        d = self.sign

        # all plan tables are host (numpy) arrays: jit embeds them as
        # compile-time constants
        if self.method == FFTMethod.DFT:
            self._W = _dft_matrix(self.nfft, d)
        elif self.method == FFTMethod.MIXEDRADIX:
            q = _estimate_mixed_radix_q(self.nfft)
            if q == 0:
                raise ValueError(f"mixed radix plan with prime nfft {self.nfft}")
            self.q = q
            self.p = self.nfft // q
            self.p_plan = FFTPlan(self.p, direction)
            self.q_plan = FFTPlan(q, direction)
            jj, ii = np.meshgrid(np.arange(self.p), np.arange(q), indexing="ij")
            # (p, q): twiddle[i*j] of ref mixed_radix :112-114
            self._twiddle = np.exp(d * 2j * np.pi * (ii * jj) / self.nfft)
        elif self.method in (FFTMethod.RADER, FFTMethod.RADER2):
            n = self.nfft
            g = resources.primitive_root_prime(n)
            seq = np.array([resources.modpow(g, i + 1, n) for i in range(n - 1)])
            self.seq = seq
            if self.method == FFTMethod.RADER:
                conv_n = n - 1
                tdb = np.exp(d * 2j * np.pi * seq / n)
                self.fft_plan = FFTPlan(conv_n, FFTDirection.FORWARD)
                self.ifft_plan = FFTPlan(conv_n, FFTDirection.REVERSE)
                self._dft = np.fft.fft(tdb)  # host-side DFT of the root seq
                self.conv_n = conv_n
                # gather index: td[i] = x[seq[n-2-i]]
                self._perm_in = seq[::-1].copy()
                self._scatter = seq.copy()
            else:
                m = int(2 * n - 5).bit_length()
                conv_n = 1 << m
                self.conv_n = conv_n
                tdb = np.exp(
                    d * 2j * np.pi * seq[np.arange(conv_n) % (n - 1)] / n
                )
                self.fft_plan = FFTPlan(conv_n, FFTDirection.FORWARD)
                self.ifft_plan = FFTPlan(conv_n, FFTDirection.REVERSE)
                self._dft = np.fft.fft(tdb)  # host-side DFT of padded root seq
                # x_prime[0] = x[seq[n-2]]; x_prime[i + conv_n - n + 1] = x[seq[n-2-i]]
                self._scatter = seq.copy()
        elif self.method == FFTMethod.UNKNOWN:
            raise ValueError("nfft must be > 0")

    # ------------------------------------------------------------------
    def execute(self, x: jnp.ndarray) -> jnp.ndarray:
        """Structural plan execution; batched over leading axes."""
        x = jnp.asarray(x)
        if x.shape[-1] < self.nfft:
            raise ValueError("not enough buffer")
        x = x[..., : self.nfft]
        m = self.method
        if m == FFTMethod.DFT:
            return jnp.matmul(x, self._W.astype(x.dtype).T, precision="highest")
        if m == FFTMethod.MIXEDRADIX:
            p, q = self.p, self.q
            A = x.reshape(*x.shape[:-1], p, q)  # A[j, i] = x[q*j + i]
            B = jnp.moveaxis(
                self.p_plan.execute(jnp.moveaxis(A, -2, -1)), -1, -2
            )  # p-FFT along the j (p) axis, per column i
            B = B * self._twiddle.astype(B.dtype)
            C = self.q_plan.execute(B)  # q-FFT along rows
            # output[p*j2 + i] = C[i, j2]  ->  transpose then flatten
            return jnp.swapaxes(C, -1, -2).reshape(*x.shape[:-1], self.nfft)
        if m == FFTMethod.RADER:
            n = self.nfft
            td = x[..., self._perm_in]  # x[seq[n-2-i]] for i = 0..n-2
            # conv_n = n-1 is pow2 by RADER's selection rule, so the inner
            # convolution runs as the native XLA FFT.  The plan tree
            # (fft_plan/ifft_plan) is kept for the printable repr parity.
            F = jnp.fft.fft(td, axis=-1) * self._dft.astype(x.dtype)
            td2 = jnp.fft.ifft(F, axis=-1) * self.conv_n
            out0 = jnp.sum(x[..., :n], axis=-1, keepdims=True)
            vals = td2 / (n - 1) + x[..., 0:1]
            out = jnp.zeros_like(x)
            out = out.at[..., 0:1].set(out0)
            out = out.at[..., self._scatter].set(vals)
            return out
        if m == FFTMethod.RADER2:
            n = self.nfft
            conv_n = self.conv_n
            xp = jnp.zeros((*x.shape[:-1], conv_n), dtype=x.dtype)
            xp = xp.at[..., 0].set(x[..., int(self.seq[n - 2])])
            i = np.arange(1, n - 1)
            src = self.seq[n - 2 - i]
            dst = i + conv_n - n + 1
            xp = xp.at[..., jnp.asarray(dst)].set(x[..., jnp.asarray(src)])
            # conv_n is pow2 by construction: native XLA FFT convolution
            F = jnp.fft.fft(xp, axis=-1) * self._dft.astype(x.dtype)
            xp = jnp.fft.ifft(F, axis=-1) * conv_n
            out0 = jnp.sum(x[..., :n], axis=-1, keepdims=True)
            vals = xp[..., : n - 1] / conv_n + x[..., 0:1]
            out = jnp.zeros_like(x)
            out = out.at[..., 0:1].set(out0)
            out = out.at[..., self._scatter].set(vals)
            return out
        raise ValueError(f"bad execute method {m!r}")

    def __repr__(self) -> str:
        # in the spirit of the reference's plan-tree Display (fft/mod.rs:217-251)
        s = (
            f"FFT Plan [{self.direction.upper()}] [n={self.nfft}] "
            f"[{self.method.upper()}]"
        )
        if self.method == FFTMethod.MIXEDRADIX:
            s += f" [P={self.p}, Q={self.q}]\n"
            s += f"PFFT:{self.p_plan!r}\nQFFT:{self.q_plan!r}"
        elif self.method in (FFTMethod.RADER, FFTMethod.RADER2):
            s += f" [conv={self.conv_n}]\nFFT:{self.fft_plan!r}"
        return s


@lru_cache(maxsize=256)
def _cached_plan(nfft: int, direction: str) -> FFTPlan:
    return FFTPlan(nfft, direction)


@lru_cache(maxsize=256)
def _bluestein_tables(n: int, sign: float):
    """Host-side chirp-z tables: (chirp c, fft of padded b, conv length L).

    Bluestein turns ANY size-n DFT into a pow2 linear convolution:
        X[k] = c[k] * sum_n (x[n] c[n]) conj(c)[k-n],  c[m] = e^{sign*i*pi*m^2/n}
    using nk = (n^2 + k^2 - (k-n)^2) / 2.  The quadratic phase is reduced
    mod 2n in exact integer arithmetic so precision holds for large n.
    """
    m = np.arange(n, dtype=np.int64)
    phase = (m * m) % (2 * n)  # e^{i pi (m^2 + 2nt)/n} == e^{i pi m^2 / n}
    c = np.exp(sign * 1j * np.pi * phase / n)
    L = 1 << int(2 * n - 2).bit_length() if n > 1 else 1
    b = np.conj(c)
    b_pad = np.zeros(L, dtype=np.complex128)
    b_pad[:n] = b
    if n > 1:
        b_pad[L - (n - 1):] = b[1:][::-1]  # circular wrap of negative lags
    return c, np.fft.fft(b_pad), L


def _bluestein(x: jnp.ndarray, n: int, sign: float) -> jnp.ndarray:
    """Any-size unnormalized DFT via two pow2 native FFTs."""
    c, B, L = _bluestein_tables(n, sign)
    c_ = jnp.asarray(c).astype(x.dtype)
    B_ = jnp.asarray(B).astype(x.dtype)
    a = x[..., :n] * c_
    A = jnp.fft.fft(a, n=L, axis=-1)
    y = jnp.fft.ifft(A * B_, axis=-1)[..., :n]
    return y * c_


# Dot precision for the matmul (4-step) backend (ops.fir._resolve_precision).
MATMUL_PRECISION = "x3"


def fft(x, nfft: int | None = None, backend: str = "auto") -> jnp.ndarray:
    """Unnormalized forward DFT along the last axis.

    backend: "auto" / "xla" (jnp.fft, any size), "matmul" (4-step DFT
    as matmuls, ops/matfft.py), "bluestein" (chirp-z), "plan"
    (structural reference plan-tree execution — the parity path).
    """
    x = jnp.asarray(x)
    n = int(nfft or x.shape[-1])
    cdtype = jnp.result_type(x.dtype, jnp.complex64)
    x = x.astype(cdtype)
    if x.shape[-1] < n:
        pad = [(0, 0)] * (x.ndim - 1) + [(0, n - x.shape[-1])]
        x = jnp.pad(x, pad)
    if backend == "plan":
        return _cached_plan(n, FFTDirection.FORWARD).execute(x)
    if backend == "matmul":
        from .matfft import fft_mx
        return fft_mx(x, n, precision=MATMUL_PRECISION)
    if backend == "bluestein":
        return _bluestein(x, n, -1.0)
    return jnp.fft.fft(x[..., :n], axis=-1)


def ifft(x, nfft: int | None = None, backend: str = "auto") -> jnp.ndarray:
    """UNNORMALIZED inverse DFT (no 1/N — the reference's convention)."""
    x = jnp.asarray(x)
    n = int(nfft or x.shape[-1])
    cdtype = jnp.result_type(x.dtype, jnp.complex64)
    x = x.astype(cdtype)
    if backend == "plan":
        return _cached_plan(n, FFTDirection.REVERSE).execute(x)
    if backend == "matmul":
        from .matfft import ifft_mx
        return ifft_mx(x, n, precision=MATMUL_PRECISION)
    if backend == "bluestein":
        return _bluestein(x, n, 1.0)
    return jnp.fft.ifft(x[..., :n], axis=-1) * n


class FFT:
    """Reference-like FFT object: FFT(nfft, direction, flags).execute(x).

    Parity: ref fft/mod.rs:175-215.  ``flags`` accepts "estimate"/"measure"
    like the reference's vestigial FFTW-style flags (fft/mod.rs:50-54);
    "measure" additionally times both backends once and keeps the faster.
    """

    def __init__(self, nfft: int, direction: str = FFTDirection.FORWARD,
                 flags: str = "estimate"):
        self.nfft = int(nfft)
        self.direction = direction
        self.flags = flags
        self.plan = _cached_plan(self.nfft, direction)
        self.method = self.plan.method
        self._backend = "auto"
        if flags == "measure":
            self._backend = self._measure()

    def _measure(self) -> str:
        import time

        x = jnp.ones(self.nfft, dtype=jnp.complex64)
        results = {}
        for backend in ("plan", "xla"):
            fn = jax.jit(lambda v, b=backend: (
                fft(v, self.nfft, b) if self.direction == FFTDirection.FORWARD
                else ifft(v, self.nfft, b)))
            fn(x).block_until_ready()
            t0 = time.perf_counter()
            for _ in range(3):
                fn(x).block_until_ready()
            results[backend] = time.perf_counter() - t0
        return min(results, key=results.get)

    def execute(self, x) -> jnp.ndarray:
        if self.direction == FFTDirection.FORWARD:
            return fft(x, self.nfft, self._backend)
        return ifft(x, self.nfft, self._backend)

    def __repr__(self) -> str:
        return repr(self.plan)


# --------------------------------------------------------------------------
# spectral analysis helpers (the windowed-FFT layer of the driver configs)
# --------------------------------------------------------------------------

def windowed_fft(x, window: str = "hamming", nfft: int | None = None,
                 *window_args) -> jnp.ndarray:
    """Window then FFT along the last axis (window applied over the frame).

    One elementwise window multiply that XLA fuses into the FFT's input,
    then :func:`fft` (jnp.fft: cuFFT on the GPU).
    """
    x = jnp.asarray(x)
    n = int(x.shape[-1])
    w = jnp.asarray(get_window(window, n, *window_args))
    cdtype = jnp.result_type(x.dtype, jnp.complex64)
    return fft(x.astype(cdtype) * w.astype(cdtype), nfft or n)


def spectrogram(x, frame: int, hop: int | None = None,
                window: str = "hamming", nfft: int | None = None):
    """Framed windowed FFT: (num_frames, nfft) — one batched FFT."""
    x = jnp.asarray(x)
    hop = hop or frame
    n = x.shape[-1]
    T = (n - frame) // hop + 1
    idx = jnp.arange(T)[:, None] * hop + jnp.arange(frame)[None, :]
    frames = x[..., idx]
    return windowed_fft(frames, window, nfft or frame)


def welch_psd(x, frame: int = 1024, overlap: float = 0.5,
              window: str = "hamming", nfft: int | None = None):
    """Welch-averaged power spectral density estimate.

    Thin convenience wrapper over the single implementation in
    analysis/spectral.welch_psd (frame/overlap signature instead of
    nfft/hop, and normalized so the SUM over bins of a unit tone's PSD
    is ~1 regardless of zero-padding — spectral's 1/(fs*sum(w^2))
    density divided by the actual FFT length).  Returns (nfft or frame,)
    real PSD, frequency bins in FFT order.
    """
    from ..analysis.spectral import welch_psd as _welch
    hop = max(1, int(frame * (1.0 - overlap)))
    n_out = nfft or frame
    return _welch(jnp.asarray(x), nfft=frame, hop=hop, window=window,
                  pad_to=None if n_out == frame else n_out) / n_out


@partial(jax.jit, static_argnames=())
def goertzel(x, freq):
    """Single-bin DFT power at normalized frequency ``freq`` (cycles per
    sample) — the tone-detection primitive.  Block form (one complex
    projection, no per-sample recurrence: the classic Goertzel biquad is
    just a sequential way to compute this same projection).  Returns the
    complex bin value sum_n x[n] e^{-2 pi i f n}."""
    x = jnp.asarray(x)
    n = x.shape[-1]
    cdtype = jnp.result_type(x.dtype, jnp.complex64)
    k = jnp.arange(n)
    ph = jnp.exp(jnp.asarray(-2j * jnp.pi, cdtype) *
                 jnp.asarray(freq, cdtype) * k.astype(cdtype))
    return jnp.sum(x.astype(cdtype) * ph, axis=-1)
