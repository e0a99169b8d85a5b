"""Multi-host (multi-process) sharded-chain test.

Spawns 2 worker processes that form one global 8-device mesh over
jax.distributed (collectives between processes ride gRPC — the DCN analog)
and run the sharded RxChain with channels spanning hosts.  SURVEY.md §5's
"distributed communication backend" requirement, validated without multi-host
hardware.
"""

import os
import socket
import subprocess
import sys

import pytest


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.slow
@pytest.mark.parametrize("layout", ["channel_across_hosts",
                                    "time_across_hosts"])
def test_two_process_sharded_rx_chain(layout):
    worker = os.path.join(os.path.dirname(__file__), "multihost_rx_chain.py")
    port = str(_free_port())
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    procs = [
        subprocess.Popen([sys.executable, worker, str(pid), port, layout],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True, env=env, cwd=os.path.dirname(
                             os.path.dirname(os.path.abspath(worker))))
        for pid in (0, 1)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        outs.append(out)

    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {pid} failed:\n{out[-2000:]}"
        assert "PASS" in out, f"process {pid} did not PASS:\n{out[-2000:]}"
