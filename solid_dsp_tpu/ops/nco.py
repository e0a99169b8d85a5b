"""NCO — numerically controlled oscillator, mixers, PLL coupling.

Parity: reference ``src/nco/mod.rs`` — struct (:26-33), new (:36-50, 1024-pt
sine LUT), constrain (:175-187), step (:93-96), LUT index (:98-101, rounding
index ((theta + 2^21) >> 22) & 0x3ff), sin/cos (:103-112, cos = LUT[idx+256]),
pll coupling alpha=bw / beta=sqrt(alpha) (:124-138), mix_up/mix_down
(:140-150) and block mixing (:152-172).

The reference steps a u32 phase accumulator one sample at a time; the phase
sequence is closed-form — theta[k] = theta0 + k * dtheta (mod 2^32) — so a
whole block of oscillator samples / mixed samples is one vectorized
expression with NO sequential dependency (SURVEY §2 parallelism table).

Two tone modes:
* ``lut``  — exact reference parity: u32 wraparound + 1024-entry LUT lookup;
* ``exact`` — sin/cos of the exact phase (still u32-quantized frequency), the
  high-fidelity fast path (no gather).

Reference quirks intentionally NOT reproduced: ``get_frequency``/``get_phase``
perform integer division `u64 / 2^32` and therefore always return 0.0
(nco/mod.rs:67-74, 89-91); ``mix_*_block`` writes through an empty Vec (UB,
:152-172).  We implement the documented intent and note the divergence here.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .. import routing

__all__ = [
    "constrain",
    "make_sine_lut",
    "nco_phases",
    "nco_sincos",
    "nco_complex_exponential",
    "mix_up_block",
    "mix_down_block",
    "pll_step",
    "NCO",
]

_TWO_PI = 2.0 * np.pi
_U32 = np.uint64(1) << np.uint64(32)


def constrain(theta: float) -> np.uint32:
    """radians -> u32 phase word.  Parity: ref nco/mod.rs:175-187.

    frac(theta / 2pi), made positive, times 0xffffffff (note: not 2^32),
    truncated toward zero.
    """
    frac = np.float64(theta) / _TWO_PI
    frac = frac - np.trunc(frac)
    if frac < 0.0:
        frac += 1.0
    return np.uint32(np.trunc(frac * np.float64(0xFFFFFFFF)))


def make_sine_lut(dtype=jnp.float64) -> np.ndarray:
    """1024-entry sine table: LUT[i] = sin(2 pi i / 1024) (ref :36-50).

    Returned as host (numpy) data: the LUT is a design-time constant that
    jit embeds directly.
    """
    i = np.arange(1024, dtype=np.float64)
    return np.sin(_TWO_PI * i / 1024.0).astype(dtype)


def nco_phases(theta0, delta_theta, n: int) -> jnp.ndarray:
    """u32 phase words theta0 + k*dtheta (wrapping) for k = 0..n-1."""
    k = jnp.arange(n, dtype=jnp.uint32)
    return (jnp.uint32(theta0) + k * jnp.uint32(delta_theta)).astype(jnp.uint32)


def _lut_index(theta: jnp.ndarray) -> jnp.ndarray:
    """Rounded 10-bit LUT index (ref nco/mod.rs:98-101)."""
    return ((theta + jnp.uint32(1 << 21)) >> jnp.uint32(22)) & jnp.uint32(0x3FF)


def nco_sincos(theta0, delta_theta, n: int, lut=None, mode: str = "lut"):
    """(sin, cos) arrays for a block of n oscillator steps.

    "lut" mode reproduces the reference's phase quantization exactly (the
    rounded 10-bit index, cos = LUT[idx + 256]).  On the GPU
    (routing.nco_reads_lut_table), when the table is the CANONICAL sine
    table, the value is evaluated as sin(idx * 2pi/1024) instead of a
    full-rate ``jnp.take`` — the same quantized angle the table stores,
    agreeing with the f32 table to ~1 ulp (the table itself is the f64
    sine rounded once; <= 6e-7 apart, tests/test_nco_agc.py).  A
    caller-supplied table that is NOT the canonical one (custom
    waveform, or a traced/device array we cannot inspect) is honored
    with the real gather on every backend — never silently ignored.  The
    CPU always keeps the bit-exact table read for the golden parity
    tests; ``mode="lut-table"`` forces the table gather everywhere
    (bit-exact parity on the GPU too).

    The table/angle decision happens HERE, outside any jit boundary, so
    a concrete (numpy) canonical table passed through an outer trace
    still resolves to the fast quantized-angle path (a jitted check
    would see only a tracer and pessimize to the gather).
    """
    if mode in ("lut", "lut-table"):
        use_table = routing.nco_reads_lut_table() or mode == "lut-table"
        if not use_table and lut is not None:
            canonical = (isinstance(lut, np.ndarray)
                         and lut.shape == (1024,)
                         and np.array_equal(lut, make_sine_lut(lut.dtype)))
            use_table = not canonical
        if use_table:
            if lut is None:
                lut = make_sine_lut()
            return _sincos_table(theta0, delta_theta, n, lut)
        return _sincos_angle(theta0, delta_theta, n)
    return _sincos_exact(theta0, delta_theta, n)


@partial(jax.jit, static_argnames=("n",))
def _sincos_table(theta0, delta_theta, n: int, lut):
    theta = nco_phases(theta0, delta_theta, n)
    idx = _lut_index(theta)
    cidx = (idx + jnp.uint32(256)) & jnp.uint32(0x3FF)
    return jnp.take(lut, idx), jnp.take(lut, cidx)


@partial(jax.jit, static_argnames=("n",))
def _sincos_angle(theta0, delta_theta, n: int):
    theta = nco_phases(theta0, delta_theta, n)
    idx = _lut_index(theta)
    cidx = (idx + jnp.uint32(256)) & jnp.uint32(0x3FF)
    step = np.float32(_TWO_PI / 1024.0)
    return (jnp.sin(idx.astype(jnp.float32) * step),
            jnp.sin(cidx.astype(jnp.float32) * step))


@partial(jax.jit, static_argnames=("n",))
def _sincos_exact(theta0, delta_theta, n: int):
    theta = nco_phases(theta0, delta_theta, n)
    ph = theta.astype(jnp.float64 if jax.config.jax_enable_x64
                      else jnp.float32) * (_TWO_PI / float(_U32))
    return jnp.sin(ph), jnp.cos(ph)


@partial(jax.jit, static_argnames=("n",))
def _nco_cexp_fast(theta0, delta_theta, n: int) -> jnp.ndarray:
    """Factorized oscillator block: e^{j(theta0 + k d)} for k = 0..n-1.

    k = Vu + v  =>  e^{j theta_k} = (e^{j(theta0 + u V d)}) * (e^{j v d})
    — a rank-1 outer product of two short exponential vectors, so the
    transcendental count drops from n to ~n/V + V (~128x fewer for the
    4M-sample bench blocks).  u32 phase words keep exact wraparound; the
    fp32 product error is ~1 ulp (>> 60 dB SNR).
    """
    V = 128 if n % 128 == 0 and n >= 128 else 1
    if V == 1:
        theta = nco_phases(theta0, delta_theta, n)
        ph = theta.astype(jnp.float32) * (_TWO_PI / float(_U32))
        return jax.lax.complex(jnp.cos(ph), jnp.sin(ph))
    U = n // V
    d = jnp.uint32(delta_theta)
    coarse = (jnp.uint32(theta0)
              + jnp.arange(U, dtype=jnp.uint32) * (jnp.uint32(V) * d))
    fine = jnp.arange(V, dtype=jnp.uint32) * d
    k = _TWO_PI / float(_U32)
    pc = coarse.astype(jnp.float32) * k
    pf = fine.astype(jnp.float32) * k
    ec = jax.lax.complex(jnp.cos(pc), jnp.sin(pc))
    ef = jax.lax.complex(jnp.cos(pf), jnp.sin(pf))
    return (ec[:, None] * ef[None, :]).reshape(n)


def nco_complex_exponential(theta0, delta_theta, n: int, lut=None,
                            mode: str = "lut") -> jnp.ndarray:
    """Block of e^{+j theta_k} = cos + j sin (ref complex_exponential :119).

    Modes: "lut" (bit-parity with the reference's 1024-entry table),
    "exact" (per-sample sin/cos), "fast" (factorized outer product — same
    math as exact to ~1 ulp at ~1/128 the transcendental cost).
    """
    if mode == "fast":
        return _nco_cexp_fast(theta0, delta_theta, n)
    s, c = nco_sincos(theta0, delta_theta, n, lut, mode)
    return jax.lax.complex(c, s) if s.dtype != jnp.float64 else c + 1j * s


def mix_up_block(x: jnp.ndarray, theta0, delta_theta, lut=None,
                 mode: str = "lut"):
    """y[k] = e^{+j theta_k} x[k]; returns (y, theta_after_block).

    Parity intent of ref nco/mod.rs:152-161 (see module docstring re UB).
    """
    n = x.shape[-1]
    ph = nco_complex_exponential(theta0, delta_theta, n, lut, mode)
    theta_end = (jnp.uint32(theta0) + jnp.uint32(n) * jnp.uint32(delta_theta))
    return x * ph.astype(x.dtype), theta_end


def mix_down_block(x: jnp.ndarray, theta0, delta_theta, lut=None,
                   mode: str = "lut"):
    """y[k] = e^{-j theta_k} x[k]; returns (y, theta_after_block)."""
    n = x.shape[-1]
    ph = nco_complex_exponential(theta0, delta_theta, n, lut, mode)
    theta_end = (jnp.uint32(theta0) + jnp.uint32(n) * jnp.uint32(delta_theta))
    return x * jnp.conj(ph).astype(x.dtype), theta_end


def pll_step(theta, delta_theta, delta_phi, alpha, beta):
    """One PLL coupling step (ref nco/mod.rs:134-138):

    delta_theta += constrain(delta_phi * alpha); theta += constrain(delta_phi * beta)
    Traced (jnp) version of constrain for in-loop carrier recovery.
    """
    def _constrain_traced(rad):
        frac = rad / _TWO_PI
        frac = frac - jnp.trunc(frac)
        frac = jnp.where(frac < 0.0, frac + 1.0, frac)
        # convert float -> uint32 directly: routing through int64 silently
        # truncates to int32 when x64 is disabled, saturating the phase
        # word at 0x7FFFFFFF for any fractional part > 0.5
        return jnp.trunc(frac * 4294967295.0).astype(jnp.uint32)

    ddt = _constrain_traced(delta_phi * alpha)
    dth = _constrain_traced(delta_phi * beta)
    return theta + dth, delta_theta + ddt


class NCO:
    """Stateful oscillator with the reference's API shape (ref nco/mod.rs)."""

    def __init__(self, mode: str = "lut", dtype=None):
        self.mode = mode
        self._lut = make_sine_lut(dtype or (jnp.float64 if jax.config.jax_enable_x64
                                            else jnp.float32))
        self.theta = np.uint32(0)
        self.delta_theta = np.uint32(0)
        self.alpha = 0.1
        self.beta = float(np.sqrt(0.1))

    def reset(self) -> None:
        self.theta = np.uint32(0)
        self.delta_theta = np.uint32(0)

    def set_frequency(self, rad_per_sample: float) -> None:
        self.delta_theta = constrain(rad_per_sample)

    def adjust_frequency(self, d: float) -> None:
        self.delta_theta = np.uint32(
            (np.uint64(self.delta_theta) + np.uint64(constrain(d))) % _U32
        )

    def set_phase(self, phi: float) -> None:
        self.theta = constrain(phi)

    def adjust_phase(self, dphi: float) -> None:
        self.theta = np.uint32(
            (np.uint64(self.theta) + np.uint64(constrain(dphi))) % _U32
        )

    def get_frequency(self) -> float:
        """Corrected semantics: delta_theta as signed radians/sample.

        (The reference's integer-division version always returns 0.0 —
        nco/mod.rs:67-74; we return the documented intent.)
        """
        dt = float(self.delta_theta) / float(_U32) * _TWO_PI
        return dt - _TWO_PI if dt > np.pi else dt

    def get_phase(self) -> float:
        return float(self.theta) / float(_U32) * _TWO_PI

    def set_internal_pll_bandwidth(self, bandwidth: float) -> None:
        if bandwidth < 0.0:
            raise ValueError("bandwidth out of range [0, inf)")
        self.alpha = bandwidth
        self.beta = float(np.sqrt(bandwidth))

    def step(self) -> None:
        self.theta = np.uint32((np.uint64(self.theta)
                                + np.uint64(self.delta_theta)) % _U32)

    def pll_step(self, delta_phi: float) -> None:
        self.adjust_frequency(delta_phi * self.alpha)
        self.adjust_phase(delta_phi * self.beta)

    # block generation ------------------------------------------------------
    def sincos_block(self, n: int):
        """n (sin, cos) pairs, stepping the phase accumulator n times."""
        s, c = nco_sincos(self.theta, self.delta_theta, n, self._lut, self.mode)
        self.theta = np.uint32(
            (np.uint64(self.theta) + np.uint64(n) * np.uint64(self.delta_theta))
            % _U32
        )
        return s, c

    def sincos(self):
        s, c = nco_sincos(self.theta, self.delta_theta, 1, self._lut, self.mode)
        return float(s[0]), float(c[0])

    def sin(self) -> float:
        return self.sincos()[0]

    def cos(self) -> float:
        return self.sincos()[1]

    def complex_exponential_block(self, n: int) -> jnp.ndarray:
        out = nco_complex_exponential(self.theta, self.delta_theta, n,
                                      self._lut, self.mode)
        self.theta = np.uint32(
            (np.uint64(self.theta) + np.uint64(n) * np.uint64(self.delta_theta))
            % _U32
        )
        return out

    def complex_exponential(self) -> complex:
        return complex(np.asarray(
            nco_complex_exponential(self.theta, self.delta_theta, 1,
                                    self._lut, self.mode))[0])

    def mix_up_block(self, x) -> jnp.ndarray:
        x = jnp.asarray(x)
        y, theta = mix_up_block(x, self.theta, self.delta_theta,
                                self._lut, self.mode)
        self.theta = np.uint32(theta)
        return y

    def mix_down_block(self, x) -> jnp.ndarray:
        x = jnp.asarray(x)
        y, theta = mix_down_block(x, self.theta, self.delta_theta,
                                  self._lut, self.mode)
        self.theta = np.uint32(theta)
        return y

    def mix_up(self, sample):
        return complex(np.asarray(self.complex_exponential()) * sample)

    def mix_down(self, sample):
        return complex(np.conj(self.complex_exponential()) * sample)

    def __repr__(self) -> str:
        return (
            f"NCO [Theta={int(self.theta)}] [dTheta={int(self.delta_theta)}] "
            f"[Alpha={self.alpha}] [Beta={self.beta}]"
        )
