"""Channel models + link-budget theory: AWGN, multipath, fading, CFO.

The reference has no channel simulation at all (it is a receive-side DSP
library); link-level validation of the modem/FEC stack needs controlled
impairments and the matching closed-form error-rate baselines.  Everything
here is a pure block transform on device (jax.random noise, one-FFT
Doppler-shaped fading, convolution for multipath), so channels can run
inside the same jit/shard_map programs as the transceiver under test.

Theory helpers (``ber_theory``) give the textbook AWGN bit-error rates the
test suite gates measured BER against — an independent anchor in the same
spirit as tests/ref_sim.py for the filter stack.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.fir import conv1d_mxu

__all__ = [
    "ebn0_to_noise_var", "awgn", "apply_cfo", "phase_noise",
    "multipath_apply", "rayleigh_doppler_fading",
    "qfunc", "ber_theory",
    "TDL_PROFILES", "tdl_taps", "tdl_fading_channel",
]


def ebn0_to_noise_var(ebn0_db, bits_per_symbol: int, code_rate: float = 1.0,
                      es: float = 1.0) -> float:
    """Complex-noise variance (both quadratures total) for a target Eb/N0.

    Es = es (average symbol energy), Eb = Es / (bits_per_symbol *
    code_rate); returns N0 = Eb / 10^(Eb/N0 dB / 10), which is the variance
    of complex AWGN with N0/2 per quadrature.
    """
    eb = es / (bits_per_symbol * code_rate)
    return eb / (10.0 ** (ebn0_db / 10.0))


def awgn(key, x, snr_db=None, noise_var=None):
    """Add complex white Gaussian noise.

    Pass either ``snr_db`` (noise power set relative to the measured mean
    power of ``x``) or an absolute complex ``noise_var`` (= N0; each
    quadrature gets noise_var/2).
    """
    x = jnp.asarray(x)
    if (snr_db is None) == (noise_var is None):
        raise ValueError("pass exactly one of snr_db / noise_var")
    if noise_var is None:
        p = jnp.mean(jnp.real(x * jnp.conj(x)))
        noise_var = p / (10.0 ** (snr_db / 10.0))
    sigma = jnp.sqrt(jnp.asarray(noise_var).astype(jnp.real(x).dtype) / 2.0)
    kr, ki = jax.random.split(key)
    shape = x.shape
    n = (jax.random.normal(kr, shape) + 1j * jax.random.normal(ki, shape))
    return x + sigma * n.astype(x.dtype)


def host_wrapped_phase(n_samples: int, cycles_per_sample: float,
                       phase0: float = 0.0) -> np.ndarray:
    """(N,) float32 phase 2*pi*((f*n) mod 1) + phase0, built host-side.

    Computing 2*pi*f*n directly in float32 loses integer resolution once
    n exceeds 2^24 (~74 s at 228 kHz), phase-jittering the tail of long
    blocks; reducing mod 1 in float64 on the host first keeps the
    WRAPPED phase (|ph| <= 2*pi + |phase0|) exact to ~1e-8 cycles for
    any practical block length.  Shapes are static at trace time, so
    this stays a compile-time constant under jit (and follows the repo
    convention of keeping design-time constants host-side).
    """
    frac = (float(cycles_per_sample) % 1.0) * np.arange(
        n_samples, dtype=np.float64)
    return (2.0 * np.pi * (frac % 1.0) + phase0).astype(np.float32)


def apply_cfo(x, cfo_cycles_per_sample, phase0: float = 0.0):
    """Rotate by a carrier-frequency offset (cycles/sample) + initial phase.

    A concrete (Python-float) offset uses the exact host-side wrapped
    phase, valid for any block length; a TRACED offset falls back to
    in-graph float32 phase, accurate to 2^24 samples per block.
    """
    x = jnp.asarray(x)
    if isinstance(cfo_cycles_per_sample, (int, float, np.floating)):
        ph = jnp.asarray(host_wrapped_phase(
            x.shape[-1], cfo_cycles_per_sample, phase0))
    else:
        k = jnp.arange(x.shape[-1], dtype=jnp.float32)
        ph = 2.0 * jnp.pi * cfo_cycles_per_sample * k + phase0
    return x * jnp.exp(1j * ph).astype(x.dtype)


def phase_noise(key, x, linewidth_cycles: float):
    """Wiener (random-walk) phase noise.

    ``linewidth_cycles`` is the per-sample RMS phase increment in cycles;
    the increment variance maps to an oscillator linewidth of
    (2 pi linewidth_cycles)^2 * fs / (2 pi) Hz (Lorentzian model).
    """
    x = jnp.asarray(x)
    dphi = 2.0 * jnp.pi * linewidth_cycles * jax.random.normal(
        key, (x.shape[-1],))
    phi = jnp.cumsum(dphi)
    return x * jnp.exp(1j * phi).astype(x.dtype)


def multipath_apply(x, taps):
    """Static multipath (FIR) channel y[n] = sum_k h[k] x[n-k].

    Zero initial state (x[n<0] = 0); output length = input length, i.e.
    the first len(taps)-1 outputs see the channel's rising edge, matching
    numpy.convolve(x, taps)[:len(x)].
    """
    x = jnp.asarray(x)
    # conv1d_mxu dots taps against the window oldest-first (DotProduct
    # REVERSE convention); true convolution = reversed taps
    h = jnp.asarray(taps, x.dtype)[::-1]
    x_ext = jnp.concatenate([jnp.zeros(h.shape[-1] - 1, x.dtype), x])
    return conv1d_mxu(x_ext, h)


def rayleigh_doppler_fading(key, n: int, doppler: float,
                            dtype=jnp.complex64):
    """Unit-power Rayleigh flat-fading gain series with a Jakes spectrum.

    ``doppler`` = maximum Doppler shift as a fraction of the sample rate
    (0 < doppler < 0.5).  Spectral method: complex white Gaussian bins
    shaped by the Jakes PSD S(f) = 1/sqrt(1-(f/fd)^2) inside |f| < fd,
    one inverse FFT, power-normalized — a single device-side transform
    with no sequential filtering.
    """
    if not 0.0 < doppler < 0.5:
        raise ValueError("doppler must be in (0, 0.5) cycles/sample")
    freqs = np.fft.fftfreq(n)  # host: static spectrum mask/shape
    inside = np.abs(freqs) < doppler
    # clip the integrable singularity at |f| -> fd
    shape = np.zeros(n)
    shape[inside] = 1.0 / np.sqrt(
        np.maximum(1.0 - (freqs[inside] / doppler) ** 2, 1e-4))
    shape = np.sqrt(shape)
    kr, ki = jax.random.split(key)
    bins = (jax.random.normal(kr, (n,)) + 1j * jax.random.normal(ki, (n,)))
    g = jnp.fft.ifft(bins * jnp.asarray(shape))
    g = g / jnp.sqrt(jnp.mean(jnp.real(g * jnp.conj(g))) + 1e-30)
    return g.astype(dtype)


# ------------------------------------------------------------- theory

def qfunc(x):
    """Gaussian tail probability Q(x) (host scalar/array, float)."""
    return 0.5 * np.vectorize(math.erfc)(np.asarray(x, float) /
                                         math.sqrt(2.0))


def ber_theory(scheme: str, m: int, ebn0_db) -> np.ndarray:
    """Textbook uncoded AWGN bit-error rate for gray-coded M-PSK / M-QAM.

    Exact for BPSK/QPSK; the standard nearest-neighbor (union-bound)
    approximations for higher orders (tight above ~7 dB).
    """
    ebn0 = 10.0 ** (np.asarray(ebn0_db, float) / 10.0)
    k = int(np.log2(m))
    if scheme == "psk":
        if m == 2 or m == 4:
            return qfunc(np.sqrt(2.0 * ebn0))
        return (2.0 / k) * qfunc(np.sqrt(2.0 * k * ebn0) *
                                 math.sin(math.pi / m))
    if scheme == "qam":
        if int(np.sqrt(m)) ** 2 != m:
            raise ValueError("square QAM only")
        return (4.0 / k) * (1.0 - 1.0 / math.sqrt(m)) * qfunc(
            np.sqrt(3.0 * k / (m - 1.0) * ebn0))
    raise ValueError(f"unknown scheme {scheme!r}")


# ------------------------------------------- frequency-selective fading

# 3GPP tapped-delay-line power profiles (delay ns, power dB) — the
# standard LTE evaluation channels.  Delays quantize to the caller's
# sample rate; sub-sample taps merge into the nearest sample.
TDL_PROFILES = {
    "epa": ((0, 0.0), (30, -1.0), (70, -2.0), (90, -3.0), (110, -8.0),
            (190, -17.2), (410, -20.8)),
    "eva": ((0, 0.0), (30, -1.5), (150, -1.4), (310, -3.6), (370, -0.6),
            (710, -9.1), (1090, -7.0), (1730, -12.0), (2510, -16.9)),
    "etu": ((0, -1.0), (50, -1.0), (120, -1.0), (200, 0.0), (230, 0.0),
            (500, 0.0), (1600, -3.0), (2300, -5.0), (5000, -7.0)),
}


def tdl_taps(profile, fs_hz: float) -> tuple:
    """(delays_samples, amplitudes) for a named or custom TDL profile.

    profile: "epa"/"eva"/"etu" or a sequence of (delay_ns, power_db).
    Taps landing on the same sample add in POWER; amplitudes are
    normalized to unit total power.
    """
    if isinstance(profile, str):
        try:
            prof = TDL_PROFILES[profile.lower()]
        except KeyError:
            raise ValueError(f"unknown TDL profile {profile!r}; one of "
                             f"{sorted(TDL_PROFILES)}") from None
    else:
        prof = tuple(profile)
    pow_by_delay: dict = {}
    for delay_ns, p_db in prof:
        d = int(round(delay_ns * 1e-9 * fs_hz))
        pow_by_delay[d] = pow_by_delay.get(d, 0.0) + 10.0 ** (p_db / 10.0)
    delays = np.asarray(sorted(pow_by_delay), np.int64)
    powers = np.asarray([pow_by_delay[d] for d in delays])
    amps = np.sqrt(powers / powers.sum())
    return delays, amps


def tdl_fading_channel(key, x, profile="eva", fs_hz: float = 30.72e6,
                       doppler: float = 1e-4):
    """Frequency-selective time-varying fading (TDL + per-tap Jakes).

    Each tap of the power-delay profile fades INDEPENDENTLY with a
    Jakes-spectrum Rayleigh gain (rayleigh_doppler_fading) — the
    standard 3GPP evaluation channel.  y[n] = sum_k a_k g_k[n] x[n-d_k]
    evaluated as a handful of shifted elementwise multiply-adds (one per
    resolvable tap — typically 4-9), no convolution loop.  Returns
    (y, h_taps) with h_taps (n_taps, T) the per-tap complex gains
    (ground truth for equalizer/estimator tests).
    """
    x = jnp.asarray(x)
    n = x.shape[-1]
    delays, amps = tdl_taps(profile, fs_hz)
    if int(delays[-1]) >= n:
        raise ValueError(
            f"signal length {n} shorter than the largest tap delay "
            f"({int(delays[-1])} samples at fs={fs_hz:g})")
    keys = jax.random.split(key, len(delays))
    gains = [amps[i].astype(np.float32)
             * rayleigh_doppler_fading(keys[i], n, doppler, x.dtype)
             for i in range(len(delays))]
    y = jnp.zeros_like(x)
    for d, g in zip(delays.tolist(), gains):
        xd = (jnp.concatenate(
            [jnp.zeros((*x.shape[:-1], d), x.dtype), x[..., : n - d]],
            axis=-1) if d else x)
        y = y + g * xd
    return y, jnp.stack(gains)
