"""Packaging structural tests (slow; full-suite only)."""

import os
import subprocess
import sys
import zipfile

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.slow
def test_wheel_builds_and_installed_copy_self_builds(tmp_path):
    """pip wheel -> install to a target dir -> import the INSTALLED copy:
    the native runtime must self-build from the shipped source."""
    wheel_dir = tmp_path / "wheels"
    r = subprocess.run(
        [sys.executable, "-m", "pip", "wheel", REPO, "--no-deps",
         "--no-build-isolation", "-q", "-w", str(wheel_dir)],
        capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    wheels = list(wheel_dir.glob("*.whl"))
    assert len(wheels) == 1
    names = zipfile.ZipFile(wheels[0]).namelist()
    assert any("native_src/solid_runtime.cc" in n for n in names)

    target = tmp_path / "site"
    r = subprocess.run(
        [sys.executable, "-m", "pip", "install", str(wheels[0]),
         "--no-deps", "-q", "--target", str(target)],
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import solid_dsp_tpu\n"
        "assert %r in solid_dsp_tpu.__file__\n"
        "from solid_dsp_tpu.runtime import CircularBuffer\n"
        "cb = CircularBuffer(16); cb.push(complex(1, 2))\n"
        "assert len(cb) == 1 and cb.pop() == complex(1, 2)\n"
        "print('INSTALLED_OK')\n" % (str(target), str(target)))
    r = subprocess.run([sys.executable, "-c", code],
                       capture_output=True, text=True, timeout=300)
    assert "INSTALLED_OK" in r.stdout, (r.stdout[-500:], r.stderr[-2000:])
