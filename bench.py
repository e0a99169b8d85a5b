"""Headline benchmark: rx-chain throughput on one GPU.

BASELINE.json config 4: NCO downconvert -> 64-tap decimate-by-4 FIR ->
block AGC -> FM demod, planar float32 input, fir_precision "x3", blocks
of 2^24 samples with the chain state carried from block to block.

One process, one card.  The time of each block is the host clock around
the call and its ``block_until_ready``; the reported rate is the median
over the timed blocks, after one warm-up block that pays for compilation.
Without a GPU the script exits non-zero and prints no result.

    python bench.py

Prints the card (``nvidia-smi`` name and power limit) and then one JSON
line: {"metric", "value", "unit", "device": {platform, kind, count}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

BLOCK = 1 << 24
TIMED_BLOCKS = 20


def main() -> int:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from solid_dsp_tpu.models.rx_chain import RxChainConfig, make_rx_chain
    from solid_dsp_tpu.utils.compile_cache import enable_compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py needs a GPU; JAX found {dev.platform!r}",
              file=sys.stderr)
        return 2
    enable_compile_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().replace("\n", " | ")
    print(f"card: {card}", flush=True)

    cfg = RxChainConfig(carrier_freq=0.2, decimation=4, fir_taps=64,
                        agc_mode="block", demod="fm", nco_mode="exact",
                        input_format="planar", fused_ddc="on",
                        fir_precision="x3", dtype=jnp.complex64)
    init, apply = make_rx_chain(cfg)
    k = np.arange(BLOCK)
    sig = 0.1 * np.exp(2j * np.pi * (0.2 / (2 * np.pi) + 0.001) * k)
    x = jax.device_put(np.stack([sig.real, sig.imag]).astype(np.float32))
    state = init()
    out, state = jax.block_until_ready(apply(state, x))     # compile
    times = []
    for _ in range(TIMED_BLOCKS):
        t0 = time.perf_counter()
        out, state = jax.block_until_ready(apply(state, x))
        times.append(time.perf_counter() - t0)
    sps = BLOCK / float(np.median(times))
    print(json.dumps({
        "metric": "rx_chain_throughput",
        "value": sps / 1e6,
        "unit": "Msamples/s",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
