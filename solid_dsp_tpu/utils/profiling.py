"""Timers, throughput benchmarking and roofline counters.

The reference has no tracing/profiling at all (SURVEY.md §5); this module is
the framework's observability layer: wall-clock timing with device sync,
samples/s + GFLOP/s reporting, and optional jax.profiler trace capture.
"""

from __future__ import annotations

import contextlib
import json
import time
from dataclasses import dataclass, field

import jax

__all__ = ["Timer", "benchmark", "trace", "Roofline", "roofline",
           "fir_workload", "fft_workload", "CHIP_PEAKS", "chip_peaks"]


@dataclass
class Timer:
    """Accumulating wall-clock timer with device synchronization."""

    name: str = "timer"
    total: float = 0.0
    count: int = 0
    _t0: float = field(default=0.0, repr=False)

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.total += time.perf_counter() - self._t0
        self.count += 1

    @property
    def mean(self) -> float:
        return self.total / max(self.count, 1)


def _block(x):
    return jax.block_until_ready(x)


def benchmark(fn, *args, warmup: int = 2, iters: int = 10, samples: int | None = None):
    """Time a jitted function; returns dict with seconds and samples/s.

    ``samples``: number of stream samples processed per call, for throughput.
    """
    for _ in range(warmup):
        _block(fn(*args))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    _block(out)
    dt = (time.perf_counter() - t0) / iters
    res = {"seconds_per_call": dt}
    if samples is not None:
        res["samples_per_second"] = samples / dt
        res["msamples_per_second"] = samples / dt / 1e6
    return res


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a jax.profiler trace around a block of work."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def emit_metric(metric: str, value: float, unit: str, vs_baseline: float):
    """Print the single-line JSON metric format the bench driver expects."""
    print(
        json.dumps(
            {
                "metric": metric,
                "value": value,
                "unit": unit,
                "vs_baseline": vs_baseline,
            }
        )
    )


# --------------------------------------------------------------------------
# roofline analysis (SURVEY §5: per-kernel roofline counters)
# --------------------------------------------------------------------------

# Published peaks per accelerator, keyed by ``jax.Device.device_kind``.
# NVIDIA H100 SXM data sheet (700 W part, dense rates without sparsity):
# 3.35 TB/s HBM3, 989 TFLOP/s bf16, 495 TFLOP/s TF32, 67 TFLOP/s float32
# outside the tensor cores.  A card set below 700 W cannot hold these.
CHIP_PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "gbps_hbm": 3_350.0,
        "gflops_bf16": 989_000.0,
        "gflops_tf32": 495_000.0,
        "gflops_f32": 67_000.0,
    },
}


def chip_peaks(device_kind: str | None = None) -> dict:
    """Peak table row for ``device_kind`` (default: the first JAX device).

    A device missing from :data:`CHIP_PEAKS` is an error, never a default:
    a roofline share against another chip's peak is meaningless.
    """
    if device_kind is None:
        device_kind = jax.devices()[0].device_kind
    try:
        return CHIP_PEAKS[device_kind]
    except KeyError:
        raise KeyError(f"no published peaks for device {device_kind!r}; "
                       f"known: {sorted(CHIP_PEAKS)}") from None


@dataclass
class Roofline:
    """Achieved-vs-peak classification for one measured workload."""

    name: str
    achieved_gflops: float
    achieved_gbps: float
    frac_compute: float
    frac_memory: float
    bound: str  # "compute" | "memory"
    arithmetic_intensity: float  # flops per byte

    def __repr__(self) -> str:
        return (
            f"Roofline[{self.name}] {self.bound}-bound: "
            f"{self.achieved_gflops:.1f} GFLOP/s "
            f"({100 * self.frac_compute:.0f}% of peak), "
            f"{self.achieved_gbps:.1f} GB/s "
            f"({100 * self.frac_memory:.0f}% of HBM), "
            f"AI={self.arithmetic_intensity:.2f} flop/B"
        )


def roofline(name: str, seconds: float, flops: float, bytes_moved: float,
             device_kind: str | None = None,
             compute: str = "f32") -> Roofline:
    """Classify a measured run against the device's roofline.

    flops / bytes_moved are the workload totals; ``compute`` names the
    peak the flops run at ("f32", "tf32" or "bf16"); ``bound`` is
    whichever resource the run used the larger fraction of — at the
    roofline the bound fraction approaches 1.0.
    """
    peaks = chip_peaks(device_kind)
    gflops = flops / seconds / 1e9
    gbps = bytes_moved / seconds / 1e9
    fc = gflops / peaks[f"gflops_{compute}"]
    fm = gbps / peaks["gbps_hbm"]
    return Roofline(
        name=name,
        achieved_gflops=gflops,
        achieved_gbps=gbps,
        frac_compute=fc,
        frac_memory=fm,
        bound="compute" if fc >= fm else "memory",
        arithmetic_intensity=flops / max(bytes_moved, 1.0),
    )


def fir_workload(n_samples: int, ntaps: int, complex_data: bool = True):
    """(flops, bytes) for a block FIR — 8 flops per complex MAC, in+out."""
    mac = 8.0 if complex_data else 2.0
    sample_bytes = 8.0 if complex_data else 4.0
    return (mac * n_samples * ntaps, 2.0 * sample_bytes * n_samples)


def fft_workload(batch: int, nfft: int, complex_data: bool = True):
    """(flops, bytes) for batched FFTs — the 5 N log2 N convention."""
    import numpy as _np

    flops = 5.0 * batch * nfft * _np.log2(max(nfft, 2))
    return (flops, 2.0 * 8.0 * batch * nfft)
