"""Collapsed decimated-rate epilogue parity.

The rotate -> AGC-scale -> demod pipeline collapses for rotation/gain-
invariant demods (ops/ddc.py epilogue helpers).  These tests gate every
collapsed path against the reference-shaped rotated chain
(epilogue="rotate"), multi-block so seams and carried state are exercised.

Reference seeds: the rotated staging mirrors the reference chain order
(nco mix_down -> fir decim -> AGC execute_block -> demod), main.rs:25-46,
auto_gain_control/mod.rs:214-246.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from solid_dsp_tpu.models.rx_chain import RxChainConfig, make_rx_chain


def _run_chain(cfg_kw, L, n_blocks=3, seed=7):
    rng = np.random.default_rng(seed)
    cfg = RxChainConfig(dtype=jnp.complex64, **cfg_kw)
    init, apply = make_rx_chain(cfg)
    st = init()
    outs = []
    for b in range(n_blocks):
        x = (rng.standard_normal(L) + 1j * rng.standard_normal(L)).astype(
            np.complex64)
        x = (0.1 * x + 0.5 * np.exp(
            1j * (0.2 * np.arange(b * L, (b + 1) * L) + 0.3))
        ).astype(np.complex64)
        if cfg.input_format == "planar":
            xin = jnp.asarray(np.stack([x.real, x.imag]).astype(np.float32))
        else:
            xin = jnp.asarray(x)
        out, st = apply(st, xin)
        outs.append(np.asarray(out))
    return np.concatenate(outs), jax.tree_util.tree_map(np.asarray, st)


def _snr_db(got, ref):
    err = float(np.sum((got - ref) ** 2))
    pwr = float(np.sum(ref ** 2))
    return 10.0 * np.log10(pwr / max(err, 1e-300))


def _state_maxdiff(sta, stb):
    la, _ = jax.tree_util.tree_flatten(sta)
    lb, _ = jax.tree_util.tree_flatten(stb)
    diffs = [np.max(np.abs(np.asarray(p, np.complex128)
                           - np.asarray(q, np.complex128)))
             for p, q in zip(la, lb) if p.size]
    return float(max(diffs))


@pytest.mark.parametrize("demod", ["fm", "am"])
@pytest.mark.parametrize("fmt", ["planar", "cf32"])
def test_collapsed_epilogue_matches_rotated(demod, fmt):
    """Pieces epilogue == rotated staging (small blocks)."""
    L = 4096
    a, sta = _run_chain(dict(demod=demod, input_format=fmt,
                             epilogue="auto"), L)
    b, stb = _run_chain(dict(demod=demod, input_format=fmt,
                             epilogue="rotate"), L)
    assert a.shape == b.shape
    assert _snr_db(a, b) > 90.0
    assert _state_maxdiff(sta, stb) < 1e-5


@pytest.mark.parametrize("demod", ["fm", "am"])
@pytest.mark.parametrize("prec", ["highest", "x3"])
def test_collapsed_epilogue_large_block(demod, prec):
    """Pieces epilogue on blocks of many Toeplitz frames, planar input,
    against the rotated staging at full precision."""
    L = 65536 * 2
    a, sta = _run_chain(dict(demod=demod, input_format="planar",
                             epilogue="auto", fir_precision=prec), L,
                        n_blocks=2)
    b, stb = _run_chain(dict(demod=demod, input_format="planar",
                             epilogue="rotate", fir_precision="highest"), L,
                        n_blocks=2)
    assert a.shape == b.shape
    assert _snr_db(a, b) > 90.0
    assert _state_maxdiff(sta, stb) < 1e-4


@pytest.mark.parametrize("L", [5000, 4097 * 4, 12 * 1000])
def test_fm_fused_geometry_fallback(L):
    """Block lengths that leave a straggler piece after the last full
    Toeplitz frame still match the rotated staging."""
    a, _ = _run_chain(dict(demod="fm", input_format="planar",
                           epilogue="auto"), L)
    b, _ = _run_chain(dict(demod="fm", input_format="planar",
                           epilogue="rotate"), L)
    assert _snr_db(a, b) > 90.0


def test_epilogue_first_sample_exact():
    """Output 0 of every block uses the carried fm_prev exactly — drive a
    pure tone and check no glitch at block boundaries (the discriminator
    of a clean tone is constant)."""
    L = 65536 * 2
    cfg = RxChainConfig(dtype=jnp.complex64, demod="fm",
                        input_format="planar", epilogue="auto",
                        fir_precision="x3")
    init, apply = make_rx_chain(cfg)
    st = init()
    outs = []
    f = 0.2 / (2 * np.pi) + 0.001
    for b in range(3):
        k = np.arange(b * L, (b + 1) * L)
        x = (0.5 * np.exp(2j * np.pi * f * k)).astype(np.complex64)
        xin = jnp.asarray(np.stack([x.real, x.imag]).astype(np.float32))
        out, st = apply(st, xin)
        outs.append(np.asarray(out))
    audio = np.concatenate(outs)
    settled = audio[200:]   # past filter/AGC settling
    assert np.max(np.abs(settled - np.median(settled))) < 1e-3
