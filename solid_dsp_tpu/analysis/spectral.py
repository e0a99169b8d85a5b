"""Spectral estimation: STFT, spectrogram, Welch PSD, Goertzel tone bank.

The reference stops at single-shot FFT plans (src/fft/mod.rs) — it has no
spectral-estimation layer at all.  This module supplies the standard one,
formulated accelerator-first:

* framing is GATHER-FREE: when ``hop`` divides ``nfft`` the frame matrix
  is built from ``nfft//hop`` statically-shifted reshapes (XLA fuses the
  stack into the downstream FFT's input read) — no strided gather, which
  would waste memory bandwidth,
* every estimate is one batched op over the frame axis (batched FFT /
  one matmul), never a Python loop over frames,
* the Goertzel bank is expressed as its mathematical equivalent — a
  direct (frames × nfft) @ (nfft × K) complex matmul against K probe
  vectors — because K selected DFT bins as matmuls beat K sequential
  Goertzel recurrences (one batched product instead of a sequential
  recurrence per bin).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["frame_signal", "stft", "istft", "spectrogram", "welch_psd",
           "csd", "coherence", "cepstrum",
           "analytic_signal", "envelope", "instantaneous_frequency",
           "goertzel_bank", "stft_denoise"]


def _check_frame_args(nfft: int, hop: int) -> None:
    if hop <= 0 or nfft <= 0:
        raise ValueError("nfft and hop must be positive")
    if hop > nfft:
        raise ValueError(f"hop ({hop}) must not exceed nfft ({nfft})")
    if nfft % hop:
        raise ValueError(
            f"gather-free framing requires hop ({hop}) to divide "
            f"nfft ({nfft})")


@partial(jax.jit, static_argnames=("nfft", "hop"))
def frame_signal(x: jnp.ndarray, nfft: int, hop: int) -> jnp.ndarray:
    """Overlapping frames (F, nfft) of a 1-D signal, gather-free.

    F = (len(x) - nfft) // hop + 1.  Built as ``nfft//hop`` shifted
    length-hop reshapes stacked on a new axis: pure static slices +
    reshapes, so XLA lowers it to cheap layout ops instead of a strided
    gather.
    """
    _check_frame_args(nfft, hop)
    n = x.shape[-1]
    if n < nfft:
        raise ValueError(f"signal length {n} < nfft {nfft}")
    F = (n - nfft) // hop + 1
    k = nfft // hop
    # chunk view: frame f = chunks[f : f + k] flattened, where chunks are
    # consecutive hop-length pieces starting at offset 0
    usable = (F - 1) * hop + nfft
    chunks = x[..., :usable]
    # pieces[j] = chunks shifted by j*hop, viewed as (F, hop)
    pieces = [
        jax.lax.dynamic_slice_in_dim(
            chunks, j * hop, (F - 1) * hop + hop, axis=-1
        ).reshape(*x.shape[:-1], F, hop)
        for j in range(k)
    ]
    return jnp.concatenate(pieces, axis=-1)


@partial(jax.jit, static_argnames=("nfft", "hop", "window", "pad_to"))
def stft(x: jnp.ndarray, nfft: int = 1024, hop: int = 512,
         window: str = "hann", pad_to: int | None = None) -> jnp.ndarray:
    """Short-time Fourier transform: (F, pad_to or nfft) complex frames.

    ``pad_to`` zero-pads each windowed frame before the FFT (finer bin
    interpolation; bin heights unchanged).  Window taps come from
    design.windows (host-side numpy constants, so nothing here fetches
    device arrays at trace time).
    """
    if pad_to is not None and pad_to < nfft:
        raise ValueError(f"pad_to {pad_to} < frame length {nfft}")
    frames = frame_signal(x, nfft, hop)
    w = _window_taps(window, nfft)
    wc = jnp.asarray(w).astype(
        frames.dtype if jnp.issubdtype(frames.dtype, jnp.complexfloating)
        else frames.real.dtype)
    return jnp.fft.fft(frames * wc, n=pad_to or nfft, axis=-1)


def _window_taps(window: str, nfft: int) -> np.ndarray:
    """Window taps by name — all 8 design.windows families plus rect."""
    if window == "rect":
        return np.ones(nfft, dtype=np.float64)
    from ..design.windows import get_window

    return np.asarray(get_window(window, nfft), dtype=np.float64)


@partial(jax.jit, static_argnames=("nfft", "hop", "window"))
def spectrogram(x: jnp.ndarray, nfft: int = 1024, hop: int = 512,
                window: str = "hann") -> jnp.ndarray:
    """Power spectrogram |STFT|² in dB, shape (F, nfft)."""
    S = stft(x, nfft, hop, window)
    p = jnp.real(S * jnp.conj(S))
    return 10.0 * jnp.log10(jnp.maximum(p, 1e-30))


@partial(jax.jit, static_argnames=("nfft", "hop", "window", "onesided",
                                   "pad_to"))
def welch_psd(x: jnp.ndarray, nfft: int = 1024, hop: int = 512,
              window: str = "hann", fs: float = 1.0,
              onesided: bool = False,
              pad_to: int | None = None) -> jnp.ndarray:
    """Welch-averaged power spectral density.

    Mean of per-frame periodograms with the standard window-power
    normalization 1/(fs · Σw²); ``onesided=True`` folds a real signal's
    spectrum to nfft//2+1 bins (doubling all but DC/Nyquist);
    ``pad_to`` interpolates onto a finer grid (bin heights unchanged,
    so integrating a padded PSD over bins requires a 1/pad factor).
    """
    S = stft(x, nfft, hop, window, pad_to)
    w = _window_taps(window, nfft)
    norm = 1.0 / (fs * float(np.sum(w * w)))
    p = jnp.mean(jnp.real(S * jnp.conj(S)), axis=-2) * norm
    if onesided:
        if pad_to is not None:
            raise ValueError("onesided with pad_to is not supported")
        half = nfft // 2 + 1
        p1 = p[..., :half]
        scale = jnp.ones((half,), p.dtype).at[1:].set(2.0)
        if nfft % 2 == 0:
            scale = scale.at[-1].set(1.0)
        p = p1 * scale
    return p


@partial(jax.jit, static_argnames=("freqs", "frame_len"))
def goertzel_bank(x: jnp.ndarray, freqs: tuple, frame_len: int = 256):
    """Per-frame complex amplitude at K probe frequencies (cycles/sample).

    Mathematically the Goertzel algorithm evaluated at arbitrary (not
    necessarily bin-centered) frequencies; computed as ONE complex matmul
    frames @ probes — (F, N) @ (N, K) — which is the matmul-native form of
    K parallel Goertzel filters.  Returns (F, K) complex, normalized by
    2/N so a unit-amplitude tone at a probe frequency reads ~1.0.
    """
    freqs = np.atleast_1d(np.asarray(freqs, dtype=np.float64))
    n = np.arange(frame_len)[:, None]
    probes = np.exp(-2j * np.pi * n * freqs[None, :]) * (2.0 / frame_len)
    frames = frame_signal(x, frame_len, frame_len)
    cdt = jnp.promote_types(frames.dtype, jnp.complex64)
    return frames.astype(cdt) @ jnp.asarray(probes).astype(cdt)


@partial(jax.jit, static_argnames=("nfft", "hop", "window"))
def csd(x: jnp.ndarray, y: jnp.ndarray, nfft: int = 1024, hop: int = 512,
        window: str = "hann", fs: float = 1.0) -> jnp.ndarray:
    """Welch-averaged cross-spectral density P_xy(f) = E[X(f) conj(Y(f))].

    Same segmentation/normalization as welch_psd, so csd(x, x) equals
    welch_psd(x).  The phase of P_xy gives the per-frequency delay/transfer
    phase between the two channels.
    """
    Sx = stft(x, nfft, hop, window)
    Sy = stft(y, nfft, hop, window)
    w = _window_taps(window, nfft)
    norm = 1.0 / (fs * float(np.sum(w * w)))
    return jnp.mean(Sx * jnp.conj(Sy), axis=-2) * norm


@partial(jax.jit, static_argnames=("nfft", "hop", "window"))
def coherence(x: jnp.ndarray, y: jnp.ndarray, nfft: int = 1024,
              hop: int = 512, window: str = "hann") -> jnp.ndarray:
    """Magnitude-squared coherence C_xy(f) = |P_xy|^2 / (P_xx P_yy) in [0, 1].

    1.0 where y is a (noiseless) LTI response of x; requires >1 averaged
    segment to be meaningful (a single segment is identically 1).
    """
    Sx = stft(x, nfft, hop, window)
    Sy = stft(y, nfft, hop, window)
    pxy = jnp.mean(Sx * jnp.conj(Sy), axis=-2)
    pxx = jnp.mean(jnp.real(Sx * jnp.conj(Sx)), axis=-2)
    pyy = jnp.mean(jnp.real(Sy * jnp.conj(Sy)), axis=-2)
    return jnp.real(pxy * jnp.conj(pxy)) / jnp.maximum(pxx * pyy, 1e-30)


@partial(jax.jit, static_argnames=("kind",))
def cepstrum(x: jnp.ndarray, kind: str = "real") -> jnp.ndarray:
    """Cepstral analysis of one frame (last axis).

    ``kind="real"``:  IFFT(log |X|)            — echo/pitch detection;
    ``kind="power"``: |IFFT(log |X|^2)|^2      — classic power cepstrum.
    An echo at delay D puts a peak at quefrency D; a minimum-phase
    deconvolution lifter follows directly.
    """
    X = jnp.fft.fft(x, axis=-1)
    logmag = jnp.log(jnp.maximum(jnp.abs(X), 1e-30))
    if kind == "real":
        return jnp.real(jnp.fft.ifft(logmag.astype(jnp.complex64)
                                     if x.dtype != jnp.float64
                                     else logmag.astype(jnp.complex128),
                                     axis=-1))
    if kind == "power":
        c = jnp.fft.ifft((2.0 * logmag).astype(
            jnp.complex128 if x.dtype == jnp.float64 else jnp.complex64),
            axis=-1)
        return jnp.real(c * jnp.conj(c))
    raise ValueError(f"unknown cepstrum kind {kind!r} (real|power)")


@jax.jit
def analytic_signal(x: jnp.ndarray) -> jnp.ndarray:
    """Analytic signal of a real block via the FFT method (Marple):
    double positive frequencies, zero negative ones, keep DC/Nyquist.

    Whole-block (periodic) semantics like the other spectral helpers; for
    streaming use the FIR Hilbert designer (design.firdes.firdes_hilbert).
    """
    n = x.shape[-1]
    X = jnp.fft.fft(x.astype(jnp.complex64)
                    if x.dtype != jnp.float64 else x.astype(jnp.complex128),
                    axis=-1)
    h = np.zeros(n)
    h[0] = 1.0
    if n % 2 == 0:
        h[1: n // 2] = 2.0
        h[n // 2] = 1.0            # Nyquist bin kept once
    else:
        h[1: (n + 1) // 2] = 2.0
    return jnp.fft.ifft(X * jnp.asarray(h, X.dtype), axis=-1)


@jax.jit
def envelope(x: jnp.ndarray) -> jnp.ndarray:
    """Instantaneous amplitude |analytic(x)| of a real block."""
    return jnp.abs(analytic_signal(x))


@jax.jit
def instantaneous_frequency(x: jnp.ndarray) -> jnp.ndarray:
    """Instantaneous frequency (cycles/sample, length n-1) from the
    analytic phase difference — real input; complex input is used as its
    own analytic signal."""
    z = analytic_signal(x) if not jnp.iscomplexobj(x) else jnp.asarray(x)
    d = z[..., 1:] * jnp.conj(z[..., :-1])
    return jnp.angle(d) / (2.0 * jnp.pi)


@partial(jax.jit, static_argnames=("nfft", "hop", "window", "length"))
def istft(S: jnp.ndarray, nfft: int = 1024, hop: int = 512,
          window: str = "hann", length: int | None = None) -> jnp.ndarray:
    """Inverse STFT by weighted overlap-add (the stft's WOLA adjoint).

    S: (..., F, nfft) complex frames from ``stft`` (same nfft/hop/
    window).  Each frame is inverse-transformed, re-weighted by the
    analysis window, overlap-added at ``hop``, and divided per sample
    by the window-power envelope sum_f w^2[n - f*hop] — exact
    reconstruction (istft(stft(x)) == x to machine precision, edges
    included, verified in tests) for ANY window/hop with hop | nfft,
    no COLA condition needed.  The overlap-add is the same
    reshape + strided .at[].add scheme the WOLA channelizer synthesis
    uses (models/channelizer.py) — gather-free.
    """
    _check_frame_args(nfft, hop)
    F = S.shape[-2]
    # invert the FULL spectrum, then truncate the time-domain frame:
    # for pad_to > nfft STFT input the zero-padding lives in TIME after
    # the ifft (slicing the frequency axis instead would invert a
    # truncated spectrum — garbage)
    frames = jnp.fft.ifft(S, axis=-1)[..., :nfft]
    w = _window_taps(window, nfft)
    wc = jnp.asarray(w).astype(frames.real.dtype)
    frames = frames * wc            # synthesis window = analysis window
    k = nfft // hop

    def _ola(fr):
        n_chunks = F + k - 1
        out = jnp.zeros((*fr.shape[:-2], n_chunks, hop), fr.dtype)
        pieces = fr.reshape(*fr.shape[:-1], k, hop)
        for j in range(k):
            out = out.at[..., j: j + F, :].add(pieces[..., j, :])
        return out.reshape(*fr.shape[:-2], n_chunks * hop)

    num = _ola(frames)
    env = _ola(jnp.broadcast_to((wc * wc)[None, :], (F, nfft))
               .astype(frames.real.dtype))
    # where the window-power envelope is exactly zero (sample 0 under a
    # zero-edge window like hann) the signal is not represented in S —
    # output 0 there.  Elsewhere the division is exact for unmodified
    # frames (istft(stft(x)) == x); note that if S was MODIFIED
    # (masking, gain rules), the first/last nfft-hop samples have
    # partial overlap coverage and the small-w edge division amplifies
    # frame leakage there — pad the analysis by one frame and trim, as
    # stft_denoise does, when edges matter.
    good = env > 0.0
    y = jnp.where(good,
                  num / jnp.where(good, env, 1.0).astype(num.dtype), 0.0)
    n_out = (F - 1) * hop + nfft
    return y[..., :length if length is not None else n_out]


@partial(jax.jit, static_argnames=("nfft", "hop", "window", "rule"))
def stft_denoise(x: jnp.ndarray, nfft: int = 512, hop: int = 128,
                 window: str = "hann", rule: str = "wiener",
                 oversubtract: float = 1.5, floor: float = 0.05,
                 noise_psd=None) -> jnp.ndarray:
    """STFT-domain noise suppression (Wiener / spectral subtraction).

    Estimates the per-bin noise PSD blindly as the 20th percentile of
    the frame powers (minimum-statistics style: works for signals that
    are INTERMITTENT per bin — speech, bursts, hopping carriers; a
    narrowband component that is on for the whole record is
    indistinguishable from noise floor in its bin and will be
    suppressed — pass ``noise_psd`` measured from a signal-free
    interval for that case) unless ``noise_psd`` (nfft,) is given,
    then applies a per-bin gain:

      rule="wiener":   G = max(1 - nu*N/P, floor)          (power rule)
      rule="subtract": G = max(1 - sqrt(nu*N/P), floor)    (amplitude)

    with P the per-frame power EMA-smoothed along time (alpha = 0.6) to
    avoid musical noise.  Returns the resynthesized signal, same length
    as x.  Complements ops.wavelet.denoise_soft for stationary-in-
    frequency noise; everything is batched frame math + two FFT passes.
    """
    if rule not in ("wiener", "subtract"):
        raise ValueError(f"unknown rule {rule!r}")
    x = jnp.asarray(x)
    n = x.shape[-1]
    if n < nfft:
        raise ValueError(f"signal length {n} < nfft {nfft}")
    # pad a full frame on BOTH sides: every retained sample then has
    # full overlap coverage, so the edge region where gain-modified
    # frames disagree (and the small-window division amplifies their
    # leakage) falls entirely in the discarded padding; the right pad
    # also absorbs the ragged tail the frame grid would drop
    F = -(-(n + nfft) // hop) + 1
    usable = (F - 1) * hop + nfft
    pads = [(0, 0)] * (x.ndim - 1) + [(nfft, usable - n - nfft)]
    xp = jnp.pad(x, pads)
    S = stft(xp, nfft, hop, window)
    P = jnp.real(S * jnp.conj(S))
    if noise_psd is None:
        N = jnp.percentile(P, 20.0, axis=-2)               # (nfft,)
    else:
        N = jnp.asarray(noise_psd).astype(P.dtype)
    # time smoothing of the power track (reduces musical noise)
    def ema(carry, p):
        c = 0.6 * carry + 0.4 * p
        return c, c
    _, Ps = jax.lax.scan(ema, P[..., 0, :], jnp.moveaxis(P, -2, 0))
    Ps = jnp.moveaxis(Ps, 0, -2)
    ratio = oversubtract * N[..., None, :] / jnp.maximum(
        Ps, jnp.finfo(Ps.dtype).tiny)
    if rule == "wiener":
        G = jnp.maximum(1.0 - ratio, floor)
    else:
        G = jnp.maximum(1.0 - jnp.sqrt(ratio), floor)
    y = istft(S * G.astype(S.dtype), nfft, hop, window)[..., nfft:nfft + n]
    return jnp.real(y) if not jnp.issubdtype(x.dtype, jnp.complexfloating) \
        else y
