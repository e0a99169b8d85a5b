"""chip_smoke.py: its phases at a tiny size on the CPU, and its contract.

The phases run here through the same functions the card runs, at the
TINY sizes of ``--rehearse``; the result line is printed only by a GPU
run, which ``test_smoke_on_card`` (marked ``on_chip``) drives where a
card is present.
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

import chip_smoke as cs
from solid_dsp_tpu.utils import compile_cache

ROOT = Path(cs.__file__).resolve().parent


def _smoke():
    return cs.Smoke(cs.TINY, rehearse=True)


@pytest.mark.parametrize("name", [n for n, _ in cs.SINGLE])
def test_single_card_phase_passes_at_tiny_size(name, capsys):
    smoke = _smoke()
    smoke.run(name, dict(cs.SINGLE)[name])
    out = capsys.readouterr().out
    assert smoke.failures == [], out[-3000:]
    assert f"PHASE {name} status=done" in out


@pytest.mark.parametrize("name", [n for n, _ in cs.FOUR if n != "device"])
def test_four_card_phase_passes_on_virtual_devices(name, capsys):
    smoke = _smoke()
    smoke.run(name, dict(cs.FOUR)[name])
    out = capsys.readouterr().out
    assert smoke.failures == [], out[-3000:]
    assert "passed=True" in out


def test_gates_fail_the_run(capsys):
    smoke = _smoke()
    smoke.check("rx_fm", "x", 89.9, 90.0)
    smoke.run("boom", lambda s: 1 / 0)
    assert len(smoke.failures) == 2
    assert "passed=False" in capsys.readouterr().out


def test_no_gpu_means_no_result_line(capsys):
    """The suite runs on the CPU: a plain run refuses without a result."""
    assert cs.main([]) == 2
    out = capsys.readouterr().out
    assert '"ok"' not in out


def test_rehearsal_prints_no_ok_result(capsys):
    assert cs.main(["--rehearse"]) == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    row = json.loads(last)
    assert row == {"rehearsal": "passed", "phases": len(cs.SINGLE)}


def test_alone_in_a_directory_fails_without_result(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_references_match_numpy_definitions():
    import numpy as np

    rng = np.random.default_rng(0)
    x = rng.standard_normal(64) + 1j * rng.standard_normal(64)
    assert cs.snr_db(x, x) > 2000
    assert abs(cs.snr_db(x, 1.1 * x) - 20.0) < 1e-9
    # M=1, K=1: the bank is the identity
    Y, tail = cs.ref_channelizer(np.ones(1), x, 1, 1)
    np.testing.assert_allclose(Y[:, 0], x)
    assert tail.shape == (0,)
    ci16, cf = cs.fm_signal(256, 2, seed=1)
    assert ci16.shape == (512, 2) and ci16.dtype == np.int16
    np.testing.assert_array_equal(
        cf, (ci16[:, 0].astype(np.float32) * np.float32(1 / 32767.0))
        + 1j * (ci16[:, 1].astype(np.float32) * np.float32(1 / 32767.0)))


@pytest.mark.on_chip
def test_smoke_on_card(on_chip, capsys):
    assert cs.main([]) == 0
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["ok"] is True and last["device"]["platform"] == "gpu"


def test_bench_needs_a_gpu_and_prints_no_number(capsys):
    import bench

    assert bench.main() == 2
    out = capsys.readouterr()
    assert out.out == ""
    assert "needs a GPU" in out.err


# ------------------------------------------------------- compile cache

def test_cache_dir_from_environment_sets_nothing(monkeypatch, tmp_path):
    import jax

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_cache_dir_defaults_to_fixed_path_in_checkout(monkeypatch):
    import jax

    import solid_dsp_tpu

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    want = Path(solid_dsp_tpu.__file__).resolve().parents[1] / ".jax_cache"
    assert compile_cache.default_cache_dir() == want
    before = jax.config.jax_compilation_cache_dir
    try:
        assert compile_cache.enable_compile_cache() == str(want)
        assert jax.config.jax_compilation_cache_dir == str(want)
        # same answer on every call: the path is part of the cache key
        assert compile_cache.enable_compile_cache() == str(want)
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_cache_dir_is_gitignored():
    lines = (ROOT / ".gitignore").read_text().split()
    assert ".jax_cache/" in lines


def test_cli_enables_the_cache_when_run_as_a_program(monkeypatch, capsys):
    from solid_dsp_tpu.__main__ import main

    calls = []
    monkeypatch.setattr(compile_cache, "enable_compile_cache",
                        lambda: calls.append(1) or "x")
    assert main(["demo", "--samples", "16"]) == 0
    assert calls == []            # called from Python: config untouched
    monkeypatch.setattr(sys, "argv", ["solid_dsp_tpu", "demo",
                                      "--samples", "16"])
    assert main() == 0
    assert calls == [1]
