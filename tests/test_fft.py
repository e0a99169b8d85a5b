"""FFT engine tests: planner parity + numerical correctness for all methods.

The reference's FFT has zero tests (SURVEY §4); conventions are pinned here
against the unnormalized NumPy DFT (forward e^{-j...}; inverse unnormalized).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from solid_dsp_tpu.ops import fft as F


def _dft(x, sign=-1):
    n = len(x)
    k = np.arange(n)
    W = np.exp(sign * 2j * np.pi * np.outer(k, k) / n)
    return W @ x


def _snr(ref, test):
    ref = np.asarray(ref); test = np.asarray(test)
    err = ref - test
    return 10*np.log10(np.mean(np.abs(ref)**2) / (np.mean(np.abs(err)**2) + 1e-300))


# ------------------------------------------------------------------ planner
@pytest.mark.parametrize(
    "n,method",
    [
        (1, F.FFTMethod.DFT), (4, F.FFTMethod.DFT), (8, F.FFTMethod.DFT),
        (11, F.FFTMethod.DFT), (13, F.FFTMethod.DFT), (16, F.FFTMethod.DFT),
        (17, F.FFTMethod.DFT),
        (32, F.FFTMethod.MIXEDRADIX), (64, F.FFTMethod.MIXEDRADIX),
        (4096, F.FFTMethod.MIXEDRADIX),
        (12, F.FFTMethod.MIXEDRADIX), (60, F.FFTMethod.MIXEDRADIX),
        (100, F.FFTMethod.MIXEDRADIX),
        (257, F.FFTMethod.RADER),  # prime, 256 = 2^8
        (29, F.FFTMethod.RADER2),  # prime, 28 not pow2
        (101, F.FFTMethod.RADER2),
        (0, F.FFTMethod.UNKNOWN),
    ],
)
def test_estimate_method_parity(n, method):
    # parity with ref fft/mod.rs:123-143
    assert F.estimate_method(n) == method


def test_plan_tree_printable():
    p = F.FFTPlan(48)
    s = repr(p)
    assert "MIXEDRADIX" in s and "PFFT" in s


# ------------------------------------------------------------------ numerics
@pytest.mark.parametrize("n", [2, 3, 4, 5, 6, 7, 8, 11, 13, 16, 17])
def test_dft_codelet_sizes(n):
    rng = np.random.default_rng(n)
    x = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    got = np.asarray(F.FFTPlan(n).execute(jnp.asarray(x)))
    np.testing.assert_allclose(got, _dft(x), atol=1e-10)


@pytest.mark.parametrize("n", [12, 32, 48, 60, 64, 100, 128, 120, 4096])
def test_mixed_radix_sizes(n):
    rng = np.random.default_rng(n)
    x = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    got = np.asarray(F.FFTPlan(n).execute(jnp.asarray(x)))
    np.testing.assert_allclose(got, np.fft.fft(x), atol=1e-8)


@pytest.mark.parametrize("n", [257])
def test_rader_prime(n):
    rng = np.random.default_rng(n)
    x = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    got = np.asarray(F.FFTPlan(n).execute(jnp.asarray(x)))
    np.testing.assert_allclose(got, np.fft.fft(x), atol=1e-8)


@pytest.mark.parametrize("n", [19, 23, 29, 101, 211])
def test_rader2_prime(n):
    rng = np.random.default_rng(n)
    x = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    got = np.asarray(F.FFTPlan(n).execute(jnp.asarray(x)))
    np.testing.assert_allclose(got, np.fft.fft(x), atol=1e-8)


@pytest.mark.parametrize("n", [16, 48, 257, 29])
def test_reverse_unnormalized(n):
    # reference convention: inverse is NOT 1/N normalized
    rng = np.random.default_rng(n + 1)
    x = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    fwd = F.FFTPlan(n, F.FFTDirection.FORWARD).execute(jnp.asarray(x))
    back = F.FFTPlan(n, F.FFTDirection.REVERSE).execute(fwd)
    np.testing.assert_allclose(np.asarray(back), x * n, atol=1e-7)


def test_fft_ifft_functions():
    rng = np.random.default_rng(99)
    x = rng.standard_normal(64) + 1j * rng.standard_normal(64)
    np.testing.assert_allclose(np.asarray(F.fft(x)), np.fft.fft(x), atol=1e-10)
    np.testing.assert_allclose(
        np.asarray(F.ifft(x)), np.fft.ifft(x) * 64, atol=1e-10
    )


def test_fft_batched():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((4, 48)) + 1j * rng.standard_normal((4, 48))
    got = np.asarray(F.FFTPlan(48).execute(jnp.asarray(x)))
    np.testing.assert_allclose(got, np.fft.fft(x, axis=-1), atol=1e-8)


def test_fft_object_and_flags():
    x = np.random.default_rng(1).standard_normal(30) + 0j
    f = F.FFT(30, F.FFTDirection.FORWARD, "estimate")
    np.testing.assert_allclose(np.asarray(f.execute(x)), np.fft.fft(x), atol=1e-8)
    m = F.FFT(30, F.FFTDirection.FORWARD, "measure")  # autotunes backend
    np.testing.assert_allclose(np.asarray(m.execute(x)), np.fft.fft(x), atol=1e-8)


# ------------------------------------------------------------------ spectral
def test_windowed_fft_4096_hamming():
    # driver config 2: windowed 4096-pt FFT on a chirp
    n = 4096
    t = np.arange(n) / n
    chirp = np.exp(1j * np.pi * 800 * t * t)
    spec = np.asarray(F.windowed_fft(chirp, "hamming"))
    from solid_dsp_tpu.design.windows import hamming

    expect = np.fft.fft(chirp * hamming(n))
    np.testing.assert_allclose(spec, expect, atol=1e-8)


def test_windowed_fft_blackman_harris():
    n = 1024
    x = np.random.default_rng(3).standard_normal(n) + 0j
    spec = np.asarray(F.windowed_fft(x, "blackman_harris"))
    from solid_dsp_tpu.design.windows import blackman_harris

    np.testing.assert_allclose(
        spec, np.fft.fft(x * blackman_harris(n)), atol=1e-8
    )


def test_spectrogram_shape():
    x = np.random.default_rng(4).standard_normal(4096) + 0j
    S = F.spectrogram(x, frame=512, hop=256)
    assert S.shape == (15, 512)


# ------------------------------------------------------------- bluestein
@pytest.mark.parametrize("n", [1000, 1009, 4095, 10007, 97, 360])
def test_bluestein_forward_vs_numpy(n):
    rng = np.random.default_rng(n)
    x = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    got = np.asarray(F.fft(jnp.asarray(x, jnp.complex128),
                                 backend="bluestein"))
    want = np.fft.fft(x)
    assert _snr(want, got) >= 120.0


@pytest.mark.parametrize("n", [1009, 4095])
def test_bluestein_inverse_unnormalized(n):
    rng = np.random.default_rng(n + 1)
    x = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    got = np.asarray(F.ifft(jnp.asarray(x, jnp.complex128),
                                  backend="bluestein"))
    want = np.fft.ifft(x) * n  # reference convention: no 1/N
    assert _snr(want, got) >= 120.0


def test_bluestein_batched():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((7, 1009)) + 1j * rng.standard_normal((7, 1009))
    got = np.asarray(F.fft(jnp.asarray(x, jnp.complex128),
                                 backend="bluestein"))
    want = np.fft.fft(x, axis=-1)
    assert _snr(want, got) >= 120.0


def test_bluestein_roundtrip_scaling():
    n = 1009
    rng = np.random.default_rng(4)
    x = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    X = F.fft(jnp.asarray(x, jnp.complex128), backend="bluestein")
    y = np.asarray(F.ifft(X, backend="bluestein")) / n
    assert _snr(x, y) >= 120.0


def test_plan_path_exhaustive_small_sizes():
    """EVERY size 1..128 through the structural plan path vs numpy — each
    size exercises whatever method the reference planner selects for it
    (codelets, mixed-radix recursion, Rader, Rader2)."""
    rng = np.random.default_rng(99)
    for n in range(1, 129):
        x = rng.standard_normal(n) + 1j * rng.standard_normal(n)
        got = np.asarray(F.fft(jnp.asarray(x, jnp.complex128),
                               backend="plan"))
        want = np.fft.fft(x)
        err = np.linalg.norm(got - want) / (np.linalg.norm(want) + 1e-30)
        assert err < 1e-9, (n, F.estimate_method(n), err)


def test_bluestein_exhaustive_small_sizes():
    rng = np.random.default_rng(98)
    for n in range(1, 129):
        x = rng.standard_normal(n) + 1j * rng.standard_normal(n)
        got = np.asarray(F.fft(jnp.asarray(x, jnp.complex128),
                               backend="bluestein"))
        want = np.fft.fft(x)
        err = np.linalg.norm(got - want) / (np.linalg.norm(want) + 1e-30)
        assert err < 1e-9, (n, err)


def test_welch_psd_tone_and_floor():
    rng = np.random.default_rng(200)
    n = 1 << 15
    k = np.arange(n)
    x = np.exp(2j * np.pi * 0.125 * k) + 0.01 * (
        rng.standard_normal(n) + 1j * rng.standard_normal(n))
    psd = np.asarray(F.welch_psd(jnp.asarray(x, jnp.complex128),
                                 frame=1024))
    peak_bin = int(np.argmax(psd))
    assert peak_bin == int(0.125 * 1024)
    # unit tone integrates to ~1 at the peak region; noise floor way down
    assert 10 * np.log10(psd[peak_bin] / np.median(psd)) > 30.0


def test_welch_psd_variance_reduction():
    """Averaged periodograms have lower variance than one frame."""
    rng = np.random.default_rng(201)
    x = (rng.standard_normal(1 << 15) + 1j * rng.standard_normal(1 << 15))
    one = np.asarray(F.welch_psd(jnp.asarray(x[:1024], jnp.complex128),
                                 frame=1024))
    many = np.asarray(F.welch_psd(jnp.asarray(x, jnp.complex128),
                                  frame=1024))
    assert np.std(many) < 0.4 * np.std(one)


def test_goertzel_matches_fft_bin():
    rng = np.random.default_rng(202)
    n = 512
    x = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    for kbin in (0, 7, 100):
        got = complex(F.goertzel(jnp.asarray(x, jnp.complex128), kbin / n))
        want = np.fft.fft(x)[kbin]
        assert abs(got - want) < 1e-9


def test_welch_psd_zero_padded_nfft_normalization():
    """Review-r2 regression: nfft != frame must keep the power contract."""
    n = 1 << 14
    x = np.exp(2j * np.pi * 0.125 * np.arange(n))
    p1 = np.asarray(F.welch_psd(jnp.asarray(x, jnp.complex128), frame=256))
    p2 = np.asarray(F.welch_psd(jnp.asarray(x, jnp.complex128), frame=256,
                                nfft=512))
    # total tone power (sum over bins) must agree regardless of padding
    np.testing.assert_allclose(np.sum(p2), np.sum(p1), rtol=0.05)


# the framework's Hamming: the reference library's 0.53836/0.46164 pair
def _hamming(n):
    return 0.53836 - 0.46164 * np.cos(2 * np.pi * np.arange(n) / (n - 1))


@pytest.mark.parametrize("F,N", [(16, 4096), (8, 1000), (3, 257), (1, 64)])
@pytest.mark.parametrize("dtype,gate", [(jnp.complex64, 90.0),
                                        (jnp.complex128, 200.0)])
def test_windowed_fft_matches_numpy_float64(F, N, dtype, gate):
    """windowed_fft == numpy float64 window * FFT, for pow2 and odd
    frame lengths (jnp.fft takes any size)."""
    from solid_dsp_tpu.ops.fft import windowed_fft

    rng = np.random.default_rng(F + N)
    x = rng.standard_normal((F, N)) + 1j * rng.standard_normal((F, N))
    got = np.asarray(windowed_fft(jnp.asarray(x, dtype), "hamming"))
    ref = np.fft.fft(np.asarray(x, dtype).astype(np.complex128)
                     * _hamming(N), axis=-1)
    err = np.sum(np.abs(got - ref) ** 2)
    assert 10 * np.log10(np.sum(np.abs(ref) ** 2) / max(err, 1e-300)) > gate


def test_windowed_fft_zero_pads_to_nfft():
    from solid_dsp_tpu.ops.fft import windowed_fft

    x = np.random.default_rng(1).standard_normal((4, 100))
    got = np.asarray(windowed_fft(jnp.asarray(x), "hamming", 128))
    ref = np.fft.fft(x * _hamming(100), n=128, axis=-1)
    np.testing.assert_allclose(got, ref, atol=1e-9)
