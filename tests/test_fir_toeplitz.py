"""fir_toeplitz — banded-Toeplitz matmul FIR vs the conv path.

The two formulations must agree to float tolerance for every dtype
combination, stride, tap count, block size, and batch shape, since
routing.fir_uses_toeplitz() swaps them by backend (GEMMs on the GPU,
XLA convolution on the CPU; see ops/fir.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from solid_dsp_tpu.ops.fir import conv1d_mxu, fir_toeplitz

RNG = np.random.default_rng(42)


def _sig(L, complex_):
    if complex_:
        return (RNG.standard_normal(L) + 1j * RNG.standard_normal(L)).astype(
            np.complex64)
    return RNG.standard_normal(L).astype(np.float32)


@pytest.mark.parametrize("cx", [False, True])
@pytest.mark.parametrize("ck", [False, True])
@pytest.mark.parametrize("stride", [1, 3, 4])
@pytest.mark.parametrize("n", [1, 7, 64])
def test_matches_conv(cx, ck, stride, n):
    L = 1000
    x = jnp.asarray(_sig(L, cx))
    taps = jnp.asarray(_sig(n, ck))
    ref = conv1d_mxu(x, taps, stride=stride)
    got = fir_toeplitz(x, taps, stride=stride)
    assert got.shape == ref.shape
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=0, atol=2e-4 * max(n, 1))


@pytest.mark.parametrize("block", [1, 8, 33, 128, 10_000])
def test_block_sizes(block):
    L, n = 777, 21
    x = jnp.asarray(_sig(L, True))
    taps = jnp.asarray(_sig(n, False))
    ref = conv1d_mxu(x, taps, stride=2)
    got = fir_toeplitz(x, taps, stride=2, block=block)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=0, atol=1e-3)


def test_multi_output_bank():
    # (n, O) tap banks — the PFB path
    L, n, O = 512, 16, 8
    x = jnp.asarray(_sig(L, True))
    bank = jnp.asarray(RNG.standard_normal((n, O)).astype(np.float32))
    ref = conv1d_mxu(x, bank)
    got = fir_toeplitz(x, bank)
    assert got.shape == ref.shape == (L - n + 1, O)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=0, atol=1e-3)


def test_complex_bank_batch():
    # batched input + complex multi-output bank (channelizer-like)
    B, L, n, O = 3, 300, 12, 4
    x = jnp.asarray(
        (RNG.standard_normal((B, L)) + 1j * RNG.standard_normal((B, L))
         ).astype(np.complex64))
    bank = jnp.asarray(
        (RNG.standard_normal((n, O)) + 1j * RNG.standard_normal((n, O))
         ).astype(np.complex64))
    ref = conv1d_mxu(x, bank, stride=2)
    got = fir_toeplitz(x, bank, stride=2)
    assert got.shape == ref.shape
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=0, atol=1e-3)


def test_short_signal_edge():
    # T < block, single frame; also n = L (exactly one output)
    x = jnp.asarray(_sig(64, True))
    taps = jnp.asarray(_sig(64, True))
    ref = conv1d_mxu(x, taps)
    got = fir_toeplitz(x, taps)
    assert got.shape == ref.shape == (1,)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=0, atol=1e-2)


def test_c128_golden_precision():
    # x64 path must stay at reference-golden precision
    x = jnp.asarray(
        (RNG.standard_normal(400) + 1j * RNG.standard_normal(400)
         ).astype(np.complex128))
    taps = jnp.asarray(RNG.standard_normal(31).astype(np.float64))
    ref = np.convolve(np.asarray(x), np.asarray(taps)[::-1], "valid")
    got = fir_toeplitz(x, taps)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0, atol=1e-12)
