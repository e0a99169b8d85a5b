"""Fused-DDC body (ops/ddc.py) against a float64 numpy mix + decimating FIR.

The body splits each block into a tail-straddling head, full Toeplitz
frames and a straggler piece; the block geometries below make each piece
appear, vanish, or take the whole block, for several tap counts and
decimations.  The reference is written straight from the definition:

    y[t] = sum_i h[i] x_ext[first + t M + i] e^{-j theta(first + t M + i)}

with x_ext = [carried raw tail | block], first = M - 1 and u32 phase
words theta(k) = theta0 + (k - (n-1)) dtheta.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from solid_dsp_tpu.ops import ddc as ddc_ops


def _ref_ddc(taps, dtheta, tail, theta0, x, M):
    n = len(taps)
    n1 = n - 1
    x_ext = np.concatenate([tail, x]).astype(np.complex128)
    k = np.arange(len(x_ext), dtype=np.int64) - n1
    words = (np.int64(theta0) + k * np.int64(dtheta)) % (1 << 32)
    mixed = x_ext * np.exp(-2j * np.pi * words / float(1 << 32))
    first = M - 1
    T = len(x) // M
    idx = first + np.arange(T)[:, None] * M + np.arange(n)[None, :]
    return mixed[idx] @ np.asarray(taps, np.complex128)


def _snr_db(ref, got):
    err = np.sum(np.abs(np.asarray(got) - ref) ** 2)
    return 10 * np.log10(np.sum(np.abs(ref) ** 2) / max(err, 1e-300))


def _planes(x):
    return jnp.asarray(np.stack([x.real, x.imag]).astype(np.float32))


def _body(taps, dtheta, tail, theta0, x, M, precision):
    re, im, tail2, theta_end = ddc_ops.ddc_apply_planar(
        taps, dtheta, _planes(tail), jnp.uint32(theta0), _planes(x), M,
        precision=precision, rot_mode="exact")
    return (np.asarray(re) + 1j * np.asarray(im), np.asarray(tail2),
            int(theta_end))


def _signal(L, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(L) + 1j * rng.standard_normal(L)) * 0.5


GEOMETRIES = [
    # (n_taps, M, L): frames + stragglers, exact frames, one short block,
    # a tap count longer than one frame
    (64, 4, (2 * 128 + 8) * 64 * 4 + 5 * 4),
    (33, 2, (2 * 128 + 8) * 64 * 2 + 5 * 2),
    (64, 1, (2 * 128 + 8) * 64 + 5),
    (128, 4, (2 * 128 + 8) * 64 * 4 + 5 * 4),
    (64, 4, (128 + 8) * 64 * 4),
    (64, 4, 4096),
    (64, 4, 64),
    (200, 1, 70000),
]


@pytest.mark.parametrize("n_taps,M,L", GEOMETRIES)
@pytest.mark.parametrize("precision", ["highest", "x3"])
def test_ddc_body_matches_float64_reference(n_taps, M, L, precision):
    rng = np.random.default_rng(n_taps + M)
    taps = rng.standard_normal(n_taps) * 0.1
    x = _signal(L, 1)
    tail = _signal(n_taps - 1, 2)
    dtheta, theta0 = 0x2345_6789, 0xDEAD_BEEF
    got, tail2, theta_end = _body(taps, dtheta, tail, theta0, x, M,
                                  precision)
    ref = _ref_ddc(taps, dtheta, tail, theta0, x, M)
    assert got.shape == ref.shape
    assert _snr_db(ref, got) > 100
    # carried state: the raw tail and the wrapped phase word
    np.testing.assert_array_equal(tail2, _planes(x[L - (n_taps - 1):]))
    assert theta_end == (theta0 + L * dtheta) % (1 << 32)


@pytest.mark.parametrize("n_taps,M", [(64, 4), (33, 2), (128, 4)])
def test_ddc_body_block_boundary_continuity(n_taps, M):
    """Two blocks with the carried tail and phase == one double block."""
    rng = np.random.default_rng(3)
    taps = rng.standard_normal(n_taps) * 0.1
    L = (128 + 8) * 64 * M
    x = _signal(2 * L, 4)
    tail0 = np.zeros(n_taps - 1, np.complex128)
    dtheta = 0x0ABC_DEF0
    a, tail_a, th_a = _body(taps, dtheta, tail0, 0, x[:L], M, "highest")
    b, _, _ = _body(taps, dtheta, tail_a[0] + 1j * tail_a[1], th_a, x[L:],
                    M, "highest")
    whole, _, _ = _body(taps, dtheta, tail0, 0, x, M, "highest")
    assert _snr_db(whole, np.concatenate([a, b])) > 100
