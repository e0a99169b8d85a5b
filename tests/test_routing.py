"""Backend routing (solid_dsp_tpu.routing) with the backend name mocked.

The suite runs on the CPU; each test sets ``jax.default_backend`` to the
name a GPU run reports and checks the choice every routed call site makes.
Nothing here is jitted while the name is mocked, so no trace made under
the fake backend lands in a jit cache that later tests would reuse.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from solid_dsp_tpu import routing
from solid_dsp_tpu.ops import fft as fft_ops
from solid_dsp_tpu.ops import fir as fir_ops
from solid_dsp_tpu.ops import nco as nco_ops


@pytest.fixture
def backend(monkeypatch):
    def set_name(name):
        monkeypatch.setattr(jax, "default_backend", lambda: name)
    return set_name


@pytest.mark.parametrize("name,gpu", [("gpu", True), ("cpu", False),
                                      ("tpu", False), ("METAL", False)])
def test_on_gpu_names_the_backend(backend, name, gpu):
    backend(name)
    assert routing.on_gpu() is gpu
    assert routing.fir_uses_toeplitz() is gpu
    assert routing.nco_reads_lut_table() is (not gpu)


@pytest.mark.parametrize("name,want", [
    ("gpu", jax.lax.DotAlgorithmPreset.TF32_TF32_F32_X3),
    ("cpu", jax.lax.Precision.HIGHEST),
    ("tpu", jax.lax.Precision.HIGHEST),
])
def test_x3_mapping(backend, name, want):
    backend(name)
    assert routing.x3_precision() == want
    assert fir_ops._resolve_precision("x3") == want


@pytest.mark.parametrize("name", ["gpu", "cpu"])
def test_precision_names_other_than_x3_ignore_the_backend(backend, name):
    backend(name)
    assert fir_ops._resolve_precision("highest") == jax.lax.Precision.HIGHEST
    assert fir_ops._resolve_precision(None) == jax.lax.Precision.HIGHEST
    assert fir_ops._resolve_precision("default") == jax.lax.Precision.DEFAULT
    preset = jax.lax.DotAlgorithmPreset.BF16_BF16_F32_X3
    assert fir_ops._resolve_precision(preset) is preset


@pytest.mark.parametrize("name,route", [("gpu", "toeplitz"),
                                        ("cpu", "conv")])
def test_conv1d_routes_by_backend(backend, monkeypatch, name, route):
    backend(name)
    called = []
    monkeypatch.setattr(fir_ops, "fir_toeplitz",
                        lambda *a, **k: called.append("toeplitz") or "t")
    monkeypatch.setattr(fir_ops, "fir_conv",
                        lambda *a, **k: called.append("conv") or "c")
    x = jnp.zeros(256, jnp.complex64)
    fir_ops.conv1d_mxu(x, jnp.ones(8, jnp.complex64), stride=2)
    assert called == [route]


def test_conv1d_falls_back_to_conv_when_signal_is_shorter_than_taps(
        backend, monkeypatch):
    backend("gpu")
    called = []
    monkeypatch.setattr(fir_ops, "fir_conv",
                        lambda *a, **k: called.append("conv") or "c")
    fir_ops.conv1d_mxu(jnp.zeros(4), jnp.ones(8))
    assert called == ["conv"]


@pytest.mark.parametrize("name", ["gpu", "cpu"])
@pytest.mark.parametrize("ntaps,block", [(8, 1024), (64, 1 << 20),
                                         (400, 4096), (1000, 1 << 16)])
def test_fir_method_choice_ignores_the_backend(backend, name, ntaps, block):
    backend(name)
    want = "fft" if ntaps > 2 * int(np.log2(block)) + 8 else "matmul"
    assert fir_ops._pick_method("auto", ntaps, block) == want
    assert fir_ops._pick_method("measure", ntaps, block) == "measure"


@pytest.mark.parametrize("name", ["gpu", "cpu"])
@pytest.mark.parametrize("n", [1000, 4096, 257])
def test_fft_auto_is_jnp_fft_for_any_size(backend, name, n):
    backend(name)
    rng = np.random.default_rng(n)
    x = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    got = np.asarray(fft_ops.fft(jnp.asarray(x)))
    np.testing.assert_allclose(got, np.fft.fft(x), atol=1e-9 * n)
    back = np.asarray(fft_ops.ifft(jnp.asarray(np.fft.fft(x))))
    np.testing.assert_allclose(back, x * n, atol=1e-9 * n)


@pytest.mark.parametrize("name,table", [("gpu", False), ("cpu", True)])
def test_nco_lut_mode_routes_table_or_angle(backend, name, table):
    backend(name)
    lut = nco_ops.make_sine_lut(np.float32)
    theta0, dtheta = np.uint32(12345), np.uint32(0x0123_4567)
    s, c = nco_ops.nco_sincos(theta0, dtheta, 2048, lut=lut, mode="lut")
    want = (nco_ops._sincos_table(theta0, dtheta, 2048, lut) if table
            else nco_ops._sincos_angle(theta0, dtheta, 2048))
    np.testing.assert_array_equal(np.asarray(s), np.asarray(want[0]))
    np.testing.assert_array_equal(np.asarray(c), np.asarray(want[1]))
    # the two routes agree to the table's rounding either way
    t_s, _ = nco_ops._sincos_table(theta0, dtheta, 2048, lut)
    assert np.max(np.abs(np.asarray(s) - np.asarray(t_s))) <= 6e-7


def test_nco_custom_table_is_read_on_the_gpu_too(backend):
    backend("gpu")
    lut = np.cos(np.linspace(0, 2 * np.pi, 1024, endpoint=False))
    theta0, dtheta = np.uint32(0), np.uint32(0x0100_0000)
    s, _ = nco_ops.nco_sincos(theta0, dtheta, 64, lut=lut, mode="lut")
    want, _ = nco_ops._sincos_table(theta0, dtheta, 64, lut)
    np.testing.assert_array_equal(np.asarray(s), np.asarray(want))
