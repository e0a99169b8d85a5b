"""Resilient production receiver: stream-scan chain + supervised recovery.

Demonstrates the serving stack end to end:

* ``make_rx_chain_stream`` — one dispatch processes the whole stream
  (lax.scan over blocks) with the exact-semantics Newton AGC,
* ``CheckpointManager`` — atomic rotating checkpoints of the ChainState,
* ``run_supervised`` — a worker gang that survives a simulated mid-stream
  crash and resumes bit-identically from the checkpoint.

    python examples/resilient_receiver.py
"""

import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, REPO)

WORKER = r"""
import os, sys
sys.path.insert(0, "@REPO@")
os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=1")
import jax

jax.config.update("jax_platforms", "cpu")  # demo targets the host CPU
import jax.numpy as jnp
import numpy as np
from solid_dsp_tpu.models.fm import fm_modulate
from solid_dsp_tpu.models.rx_chain import RxChainConfig, make_rx_chain_stream
from solid_dsp_tpu.parallel.fault import CheckpointManager

out_dir, crash_flag = sys.argv[1], sys.argv[2]
NCHUNKS, B = 6, 4096          # 6 checkpointed chunks of 4 blocks each
cfg = RxChainConfig(agc_mode="parallel", demod="fm", dtype=jnp.complex64)
init, stream = make_rx_chain_stream(cfg, block_size=1024)
cm = CheckpointManager(os.path.join(out_dir, "ckpts"))

state, start = cm.latest(like=init())
if state is None:
    state = init()
    print("cold start")
else:
    print(f"resumed from checkpoint at chunk {start}")

msg = np.sin(2 * np.pi * 0.002 * np.arange(NCHUNKS * B))
iq, _ = fm_modulate(jnp.asarray(msg, jnp.float32), cfg.fm_kf)
x = (np.asarray(iq) * 0.5
     * np.exp(1j * cfg.carrier_freq * np.arange(NCHUNKS * B))
     ).astype(np.complex64)

for i in range(start, NCHUNKS):
    if i == 3 and os.path.exists(crash_flag):
        os.remove(crash_flag)
        print("simulated power loss at chunk 3", flush=True)
        os._exit(9)
    out, state = stream(state, jnp.asarray(x[i * B:(i + 1) * B]))
    np.save(os.path.join(out_dir, f"audio_{i}.npy"), np.asarray(out))
    cm.save(state, i)
print("stream complete")
"""


def main() -> int:
    from solid_dsp_tpu.parallel.fault import run_supervised

    with tempfile.TemporaryDirectory() as d:
        worker_py = os.path.join(d, "worker.py")
        with open(worker_py, "w") as f:
            f.write(WORKER.replace("@REPO@", REPO))
        crash_flag = os.path.join(d, "crash_once")
        open(crash_flag, "w").close()

        def spawn(worker_id, attempt):
            print(f"[supervisor] launching worker (attempt {attempt})")
            return subprocess.Popen([sys.executable, worker_py, d, crash_flag])

        codes = run_supervised(spawn, num_workers=1, max_restarts=2,
                               timeout=300.0)
        print(f"[supervisor] final exit codes: {codes}")

        import numpy as np

        chunks = [np.load(os.path.join(d, f"audio_{i}.npy"))
                  for i in range(6)]
        audio = np.concatenate(chunks)
        print(f"demodulated {audio.size} audio samples "
              f"(rms {np.sqrt(np.mean(audio.real ** 2)):.4f}) across one "
              "simulated crash — no samples lost")
    return 0


if __name__ == "__main__":
    sys.exit(main())
