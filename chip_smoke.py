"""On-card smoke test: the main path on one NVIDIA GPU, every phase checked.

    python chip_smoke.py               # one card: all single-card phases
    python chip_smoke.py --four-cards  # sharded rx chain + channelizer on
                                       # four cards vs one card, nothing else
    python chip_smoke.py --rehearse [--four-cards]
                                       # CPU, tiny sizes (never on a GPU)

Phases (one process, one JAX client):

* device       — the default backend is a GPU; prints the card's name and
                 power limit and the JAX version.
* rx_fm, rx_qpsk, rx_ingest — BASELINE config 4 (NCO -> 64-tap decimate-
                 by-4 FIR -> block AGC -> demod) through ``make_rx_chain``
                 at 2^24 samples per block, 3 blocks with carried state,
                 each against the unfused chain in complex128 on the CPU
                 device (the repo's plain reference).  Gates: >= 100 dB
                 at "highest", >= 90 dB at "x3", >= 60 dB at "default".
* cli_fm       — ``tx`` then ``rx --demod fm --wav`` in-process through
                 ``solid_dsp_tpu.__main__.main``; checks the WAV.
* fir          — config 1 (64 taps, 2^24 samples): banded-Toeplitz GEMMs
                 and ``conv_general_dilated``, timed, vs float64.
* channelizer  — config 5: PolyphaseChannelizer(256, 8), 3 blocks of 2^22
                 samples, vs a float64 numpy polyphase bank (>= 90 dB).
* wfft         — config 2: windowed_fft on 4096 frames of 4096 points,
                 Hamming, vs numpy.fft in float64 (>= 90 dB).
* channel_bank — the IIR biquad bank at M=256, S=2, T=65536 vs
                 scipy.signal.sosfilt per channel in float64 (>= 90 dB).

Each phase prints ``PHASE <name> key=value ...`` lines: compile time,
``memory_analysis()``, the host-clock time around ``block_until_ready``,
SNR, the process's peak device bytes, and for the plain paths that
replaced hand kernels the top three device ops of a short profiler trace.
A failed phase makes the script exit 1 without a result line.  The last
line of a passing run is exactly

    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": N}}
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys
import time
import traceback
import wave
from dataclasses import dataclass
from pathlib import Path

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "chip_smoke"      # gitignored scratch files

GATES = {"highest": 100.0, "x3": 90.0, "default": 60.0}


@dataclass(frozen=True)
class Sizes:
    """Widths of every phase.  FULL is what the card runs; TINY is the
    CPU rehearsal (``--rehearse``), reached only with that flag."""

    rx_block: int
    rx_blocks: int
    cli_samples: int          # tx message samples (x4 interpolation)
    cli_block: int
    chan_m: int
    chan_k: int
    chan_block: int
    chan_blocks: int
    wfft_frames: int
    wfft_n: int
    bank_m: int
    bank_t: int
    fir_len: int
    four_rx_per_card: int
    four_chan_block: int


FULL = Sizes(rx_block=1 << 24, rx_blocks=3, cli_samples=1 << 20,
             cli_block=1 << 20, chan_m=256, chan_k=8, chan_block=1 << 22,
             chan_blocks=3, wfft_frames=4096, wfft_n=4096, bank_m=256,
             bank_t=65536, fir_len=1 << 24, four_rx_per_card=1 << 24,
             four_chan_block=1 << 24)
TINY = Sizes(rx_block=1 << 12, rx_blocks=3, cli_samples=1 << 12,
             cli_block=1 << 12, chan_m=16, chan_k=8, chan_block=1 << 10,
             chan_blocks=3, wfft_frames=8, wfft_n=256, bank_m=8,
             bank_t=512, fir_len=1 << 12, four_rx_per_card=1 << 12,
             four_chan_block=1 << 12)


# --------------------------------------------------------------------------
# references and measures (float64, independent of the code under test)
# --------------------------------------------------------------------------

def snr_db(ref, got) -> float:
    """10 log10(sum |ref|^2 / sum |got - ref|^2), in float64."""
    import numpy as np

    ref = np.asarray(ref, np.complex128)
    err = np.asarray(got, np.complex128) - ref
    e = float(np.sum(np.abs(err) ** 2))
    return float(10 * np.log10(float(np.sum(np.abs(ref) ** 2))
                               / max(e, 1e-300)))


def ref_channelizer(taps, x, M, K, tail=None):
    """float64 M-channel polyphase analysis bank, from the definition in
    models/channelizer.py:

        z[t, r] = sum_k h[k M + r] x[(t - k) M - r]
        Y[t, m] = sum_r z[t, r] e^{+2 pi i m r / M}

    with x[-1], x[-2], ... the carried tail.  Returns (Y, new_tail)."""
    import numpy as np

    base = K * M - 1
    if tail is None:
        tail = np.zeros(base, np.complex128)
    x_ext = np.concatenate([tail, x]).astype(np.complex128)
    T = len(x) // M
    h = np.asarray(taps, np.float64)[: K * M].reshape(K, M)
    r = np.arange(M)
    z = np.zeros((T, M), np.complex128)
    for k in range(K):
        idx = base + (np.arange(T)[:, None] - k) * M - r[None, :]
        z += h[k][None, :] * x_ext[idx]
    W = np.exp(2j * np.pi * np.outer(r, r) / M)
    return z @ W, x_ext[len(x_ext) - base:]


def fm_signal(L, n_blocks, seed, carrier=0.2):
    """ci16 FM capture at the chain's carrier: (int16 (n, 2), cf32 values).

    A 5e-5 cycles/sample tone at 0.0314 rad/sample peak deviation plus
    white noise; the cf32 values are the ci16 counts scaled exactly as
    the chain's on-device ci16 conversion does."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n = L * n_blocks
    k = np.arange(n, dtype=np.float64)
    phase = carrier * k + 100.0 * np.sin(2 * np.pi * 5e-5 * k)
    x = 0.5 * np.exp(1j * phase) + 0.01 * (rng.standard_normal(n)
                                           + 1j * rng.standard_normal(n))
    return _quantize(x)


def qpsk_signal(L, n_blocks, seed, carrier=0.2, sps=16):
    """ci16 QPSK capture: rectangular symbols of ``sps`` samples centred
    on the chain's carrier, phase offset 0.3 rad, white noise."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n = L * n_blocks
    sym = np.exp(1j * (np.pi / 4 + np.pi / 2 * rng.integers(0, 4,
                                                            -(-n // sps))))
    k = np.arange(n, dtype=np.float64)
    x = (0.5 * np.repeat(sym, sps)[:n] * np.exp(1j * (carrier * k + 0.3))
         + 0.01 * (rng.standard_normal(n) + 1j * rng.standard_normal(n)))
    return _quantize(x)


def _quantize(x):
    import numpy as np

    iq = np.stack([x.real, x.imag], axis=-1) * 32767.0
    ci16 = np.clip(np.round(iq), -32767, 32767).astype(np.int16)
    f = ci16.astype(np.float32) * np.float32(1.0 / 32767.0)
    return ci16, (f[:, 0] + 1j * f[:, 1]).astype(np.complex64)


# --------------------------------------------------------------------------
# reporting
# --------------------------------------------------------------------------

class Smoke:
    """Runs phases, prints their lines, and remembers failures."""

    def __init__(self, sizes: Sizes, rehearse: bool):
        self.sizes = sizes
        self.rehearse = rehearse
        self.failures: list[str] = []
        self._fm_case = None

    def fm_case(self):
        """The FM capture's ci16 blocks and their reference output, made
        once and shared by rx_fm and rx_ingest."""
        if self._fm_case is None:
            s = self.sizes
            ci16, _ = fm_signal(s.rx_block, s.rx_blocks, seed=1)
            blocks = _split(ci16, s.rx_blocks)
            self._fm_case = (blocks, _reference_chain(self, "fm", blocks))
        return self._fm_case

    def line(self, phase: str, **kv):
        parts = [f"PHASE {phase}"]
        for k, v in kv.items():
            if isinstance(v, float):
                v = repr(v)
            elif not isinstance(v, (int, str)):
                v = json.dumps(v, default=str)
            parts.append(f"{k}={v}")
        print(" ".join(parts), flush=True)

    def check(self, phase: str, name: str, value: float, gate: float):
        ok = value >= gate
        self.line(phase, check=name, snr_db=value, gate_db=gate,
                  passed=ok)
        if not ok:
            self.failures.append(f"{phase}/{name}: {value:.2f} dB < "
                                 f"{gate} dB")

    def run(self, phase: str, fn):
        t0 = time.perf_counter()
        try:
            fn(self)
        except Exception:                      # noqa: BLE001 (reported)
            traceback.print_exc()
            self.failures.append(f"{phase}: raised")
            self.line(phase, status="FAILED")
            return
        self.line(phase, status="done", wall_s=time.perf_counter() - t0,
                  peak_bytes=peak_bytes())


def peak_bytes():
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use", "not reported")


def compile_jit(fn, *args):
    """AOT-compile ``fn`` for ``args``: (compiled, seconds, memory)."""
    t0 = time.perf_counter()
    compiled = fn.lower(*args).compile()
    dt = time.perf_counter() - t0
    mem = compiled.memory_analysis()
    keys = ("argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "generated_code_size_in_bytes")
    memd = ({k: int(getattr(mem, k)) for k in keys if hasattr(mem, k)}
            if mem is not None else "not reported")
    return compiled, dt, memd


def timed(fn, *args, repeat=3):
    """Best host-clock seconds of ``fn(*args)`` ending in
    ``block_until_ready`` (already compiled)."""
    import jax

    best = float("inf")
    out = None
    for _ in range(repeat):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best, out


def top_device_ops(smoke: Smoke, label: str, fn, *args, k=3):
    """Trace a few calls of ``fn`` and print the ``k`` device ops with the
    largest summed duration (XLA op names from the device planes)."""
    import jax
    from jax.profiler import ProfileData

    d = WORK / f"trace_{label}"
    jax.block_until_ready(fn(*args))
    jax.profiler.start_trace(str(d))
    try:
        for _ in range(2):
            jax.block_until_ready(fn(*args))
    finally:
        jax.profiler.stop_trace()
    paths = sorted(glob.glob(str(d / "**" / "*.xplane.pb"), recursive=True),
                   key=os.path.getmtime)
    if not paths:
        raise RuntimeError(f"no trace written under {d}")
    pd = ProfileData.from_file(paths[-1])
    totals: dict = {}
    lines_seen = []
    for plane in pd.planes:
        dev = plane.name.startswith("/device:")
        host_cpu = smoke.rehearse and plane.name == "/host:CPU"
        if not (dev or host_cpu):
            continue
        lines = list(plane.lines)
        lines_seen += [f"{plane.name}:{ln.name}" for ln in lines]
        if dev:
            pick = [ln for ln in lines if ln.name == "XLA Ops"] or \
                [ln for ln in lines if ln.name.startswith("Stream")]
        else:
            pick = [ln for ln in lines if ln.name.startswith("tf_XLA")]
        for ln in pick:
            for ev in ln.events:
                if ev.name.startswith(("end:", "ThreadpoolListener")):
                    continue
                totals[ev.name] = totals.get(ev.name, 0.0) + ev.duration_ns
    if not totals:
        raise RuntimeError(f"no device ops in trace; lines: {lines_seen}")
    busy = sum(totals.values())
    top = sorted(totals.items(), key=lambda kv: -kv[1])[:k]
    smoke.line(label, trace_calls=2, device_op_ns_total=busy,
               top_ops=[[n, round(t / 2 / 1e3, 3), round(t / busy, 4)]
                        for n, t in top])


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------

def phase_device(smoke: Smoke):
    import jax

    dev = jax.devices()[0]
    smoke.line("device", platform=dev.platform, kind=dev.device_kind,
               count=len(jax.devices()), jax=jax.__version__,
               python=sys.version.split()[0])


def _chain_outputs(cfg, blocks, fmt, device=None):
    """Run ``make_rx_chain(cfg)`` over ``blocks`` (ci16 (n, 2) arrays)
    in ``fmt``; returns (concatenated output, compile s, memory,
    seconds per block)."""
    import jax
    import numpy as np

    from solid_dsp_tpu.models.rx_chain import make_rx_chain

    init, apply = make_rx_chain(cfg)
    state = init()
    ins = [_ingest(b, fmt, device) for b in blocks]
    compiled, c_s, mem = compile_jit(apply, state, ins[0])
    jax.block_until_ready(compiled(state, ins[0]))    # first-run set-up
    outs = []
    t_total = 0.0
    for x in ins:
        t0 = time.perf_counter()
        y, state = jax.block_until_ready(compiled(state, x))
        t_total += time.perf_counter() - t0
        outs.append(np.asarray(y))
    return np.concatenate(outs), c_s, mem, t_total / len(ins), compiled, \
        ins


def _ingest(ci16, fmt, device):
    import jax
    import numpy as np

    f = ci16.astype(np.float32) * np.float32(1.0 / 32767.0)
    if fmt == "ci16":
        host = ci16
    elif fmt == "planar":
        host = np.ascontiguousarray(f.T)
    elif fmt == "cf32":
        host = (f[:, 0] + 1j * f[:, 1]).astype(np.complex64)
    else:   # "c128": the reference's input, same values in float64
        host = (f[:, 0].astype(np.float64)
                + 1j * f[:, 1].astype(np.float64))
    return jax.device_put(host, device)


def _reference_chain(smoke: Smoke, demod, blocks):
    """The unfused chain in complex128 on the process's CPU device."""
    import jax
    import jax.numpy as jnp

    from solid_dsp_tpu.models.rx_chain import RxChainConfig

    cpu = jax.devices("cpu")[0]
    cfg = RxChainConfig(demod=demod, nco_mode="exact", agc_mode="block",
                        fused_ddc="off", fir_precision="highest",
                        input_format="cf32", dtype=jnp.complex128)
    t0 = time.perf_counter()
    with jax.enable_x64(True), jax.default_device(cpu):
        ref, *_ = _chain_outputs(cfg, blocks, "c128", cpu)
    smoke.line(f"rx_{demod}", reference="unfused complex128 on cpu",
               reference_s=time.perf_counter() - t0)
    return ref


def _rx_variant(smoke, phase, demod, fmt, prec, blocks, ref, trace=False):
    import jax.numpy as jnp

    from solid_dsp_tpu.models.rx_chain import RxChainConfig

    cfg = RxChainConfig(demod=demod, nco_mode="exact", agc_mode="block",
                        fused_ddc="on", fir_precision=prec,
                        input_format=fmt, dtype=jnp.complex64)
    got, c_s, mem, t_blk, compiled, ins = _chain_outputs(cfg, blocks, fmt)
    L = smoke.sizes.rx_block
    smoke.line(phase, demod=demod, input_format=fmt, fir_precision=prec,
               compile_s=c_s, memory=mem, block_samples=L,
               seconds_per_block=t_blk, msamples_per_s=L / t_blk / 1e6,
               out_shape=list(got.shape))
    if got.shape != ref.shape:
        raise AssertionError(f"shape {got.shape} != reference {ref.shape}")
    smoke.check(phase, f"{demod}/{fmt}/{prec}", snr_db(ref, got),
                GATES[prec])
    if trace:
        from solid_dsp_tpu.models.rx_chain import rx_chain_init

        top_device_ops(smoke, phase + "_trace", compiled,
                       rx_chain_init(cfg), ins[0])


def phase_rx_fm(smoke: Smoke):
    blocks, ref = smoke.fm_case()
    for prec in ("highest", "x3", "default"):
        _rx_variant(smoke, "rx_fm", "fm", "cf32", prec, blocks, ref)


def phase_rx_qpsk(smoke: Smoke):
    s = smoke.sizes
    ci16, _ = qpsk_signal(s.rx_block, s.rx_blocks, seed=2)
    blocks = _split(ci16, s.rx_blocks)
    ref = _reference_chain(smoke, "qpsk", blocks)
    for prec in ("highest", "x3", "default"):
        _rx_variant(smoke, "rx_qpsk", "qpsk", "cf32", prec, blocks, ref)


def phase_rx_ingest(smoke: Smoke):
    """planar and ci16 ingest of the rx_fm capture (cf32 ran in rx_fm).
    planar/x3 is the former fused DDC+FM kernel's configuration: its
    trace names the plain path's top device ops."""
    blocks, ref = smoke.fm_case()
    for fmt in ("planar", "ci16"):
        for prec in ("highest", "x3"):
            _rx_variant(smoke, "rx_ingest", "fm", fmt, prec, blocks, ref,
                        trace=(fmt == "planar" and prec == "x3"))


def _split(ci16, n):
    import numpy as np

    return [np.ascontiguousarray(b) for b in np.split(ci16, n)]


def phase_cli_fm(smoke: Smoke):
    import numpy as np

    from solid_dsp_tpu.__main__ import main as cli

    s = smoke.sizes
    WORK.mkdir(parents=True, exist_ok=True)
    rec, wav_path = WORK / "tx.ci16", WORK / "rx.wav"
    for p in (rec, wav_path):
        if p.exists():
            p.unlink()
    t0 = time.perf_counter()
    rc = cli(["tx", str(rec), "--mod", "fm", "--samples",
              str(s.cli_samples), "--format", "ci16"])
    t_tx = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"tx exited {rc}")
    n_iq = rec.stat().st_size // 4
    t0 = time.perf_counter()
    rc = cli(["rx", str(rec), "--format", "ci16", "--demod", "fm",
              "--wav", str(wav_path), "--rate", "1000000",
              "--block", str(s.cli_block)])
    t_rx = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"rx exited {rc}")
    with wave.open(str(wav_path), "rb") as w:
        frames, rate, ch = w.getnframes(), w.getframerate(), w.getnchannels()
        pcm = np.frombuffer(w.readframes(frames), "<i2")
    demod = (n_iq // s.cli_block) * (s.cli_block // 4) + \
        (n_iq % s.cli_block) // 4
    want = round(demod * 48000 / (1_000_000 / 4))
    smoke.line("cli_fm", iq_samples=n_iq, blocks=-(-n_iq // s.cli_block),
               tx_s=t_tx, rx_s=t_rx, wav_frames=frames,
               expected_frames=want, wav_rate=rate, channels=ch)
    # flush() appends the audio resampler's delay line: at most 64 more
    if not (rate == 48000 and ch == 1 and want <= frames <= want + 64
            and np.all(np.isfinite(pcm.astype(np.float64)))
            and np.any(pcm != 0)):
        raise AssertionError("WAV check failed")


def phase_fir(smoke: Smoke):
    """Config 1 width: the two FIR routes timed side by side."""
    import jax
    import numpy as np
    from scipy import signal

    from solid_dsp_tpu.ops import fir as fir_ops

    s = smoke.sizes
    rng = np.random.default_rng(3)
    taps = (rng.standard_normal(64) * 0.1).astype(np.float32)
    x = ((rng.standard_normal(s.fir_len) + 1j * rng.standard_normal(
        s.fir_len)) * 0.5).astype(np.complex64)
    ref = signal.fftconvolve(x.astype(np.complex128),
                             taps[::-1].astype(np.float64), mode="valid")
    xd = jax.device_put(x)
    bf16x3 = jax.lax.DotAlgorithmPreset.BF16_BF16_F32_X3
    variants = (("toeplitz", fir_ops.fir_toeplitz, "highest"),
                ("conv_general_dilated", fir_ops.fir_conv, "highest"),
                ("toeplitz", fir_ops.fir_toeplitz, "x3"),
                ("toeplitz", fir_ops.fir_toeplitz, bf16x3),
                ("toeplitz", fir_ops.fir_toeplitz, "default"))
    for name, fn, prec in variants:
        f = jax.jit(lambda v, fn=fn, p=prec: fn(v, taps, precision=p))
        compiled, c_s, mem = compile_jit(f, xd)
        t, y = timed(compiled, xd)
        label = prec if isinstance(prec, str) else prec.name
        smoke.line("fir", route=name, precision=label, taps=64,
                   samples=s.fir_len, compile_s=c_s, memory=mem, seconds=t,
                   msamples_per_s=s.fir_len / t / 1e6)
        got_db = snr_db(ref, np.asarray(y))
        if prec == "highest":
            smoke.check("fir", f"{name}/{label}", got_db, 100.0)
        else:
            smoke.line("fir", route=name, precision=label, snr_db=got_db)


def phase_channelizer(smoke: Smoke):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from solid_dsp_tpu.models.channelizer import (PolyphaseChannelizer,
                                                  channelizer_apply,
                                                  channelizer_taps)

    s = smoke.sizes
    M, K, L = s.chan_m, s.chan_k, s.chan_block
    rng = np.random.default_rng(4)
    x = ((rng.standard_normal(L * s.chan_blocks) + 1j * rng.standard_normal(
        L * s.chan_blocks)) * 0.5).astype(np.complex64)
    ch = PolyphaseChannelizer(M, K)
    taps = channelizer_taps(M, K)
    f = jax.jit(lambda t, v: channelizer_apply(jnp.asarray(ch.taps), t, v,
                                               M))
    xs = [jax.device_put(b) for b in np.split(x, s.chan_blocks)]
    compiled, c_s, mem = compile_jit(f, ch._tail, xs[0])
    t_blk, _ = timed(compiled, ch._tail, xs[0])
    outs = []
    tail_ref = None
    worst = float("inf")
    for i, xb in enumerate(xs):
        Y = ch.execute_block(xb)
        ref, tail_ref = ref_channelizer(taps, np.asarray(x[i * L:(i + 1) * L],
                                                         np.complex128),
                                        M, K, tail_ref)
        worst = min(worst, snr_db(ref, np.asarray(Y)))
        outs.append(Y.shape)
    smoke.line("channelizer", M=M, K=K, block_samples=L,
               blocks=s.chan_blocks, compile_s=c_s, memory=mem,
               seconds_per_block=t_blk, msamples_per_s=L / t_blk / 1e6,
               out_shape=list(outs[0]))
    smoke.check("channelizer", "worst block", worst, 90.0)
    top_device_ops(smoke, "channelizer_trace", compiled, ch._tail, xs[0])


def phase_wfft(smoke: Smoke):
    import jax
    import numpy as np

    from solid_dsp_tpu.ops.fft import windowed_fft

    s = smoke.sizes
    F, n = s.wfft_frames, s.wfft_n
    rng = np.random.default_rng(5)
    x = ((rng.standard_normal((F, n)) + 1j * rng.standard_normal((F, n)))
         * 0.5).astype(np.complex64)
    xd = jax.device_put(x)
    f = jax.jit(lambda v: windowed_fft(v, "hamming"))
    compiled, c_s, mem = compile_jit(f, xd)
    t, Y = timed(compiled, xd)
    # the framework's Hamming (the reference library's 0.53836/0.46164)
    w = 0.53836 - 0.46164 * np.cos(2 * np.pi * np.arange(n) / (n - 1))
    ref = np.fft.fft(x.astype(np.complex128) * w, axis=-1)
    smoke.line("wfft", frames=F, nfft=n, window="hamming", compile_s=c_s,
               memory=mem, seconds=t, msamples_per_s=F * n / t / 1e6)
    smoke.check("wfft", "vs numpy float64", snr_db(ref, np.asarray(Y)),
                90.0)
    top_device_ops(smoke, "wfft_trace", compiled, xd)


def phase_channel_bank(smoke: Smoke):
    import jax
    import numpy as np
    from scipy import signal

    from solid_dsp_tpu.models.channel_bank import design_channel_sos
    from solid_dsp_tpu.ops.iir import iir_bank_apply, iir_bank_init

    s = smoke.sizes
    M, T = s.bank_m, s.bank_t
    sos = design_channel_sos()                    # (2, 5) Butterworth
    rng = np.random.default_rng(6)
    x = ((rng.standard_normal((T, M)) + 1j * rng.standard_normal((T, M)))
         * 0.5).astype(np.complex64)
    xd = jax.device_put(x)
    st = iir_bank_init(sos.shape[0], M)
    sosd = jax.device_put(sos)
    compiled, c_s, mem = compile_jit(iir_bank_apply, sosd, st, xd)
    t, (y, _) = timed(compiled, sosd, st, xd)
    sos6 = np.concatenate([sos[:, :3], np.ones((2, 1)), sos[:, 3:]],
                          axis=1).astype(np.float64)
    ref = signal.sosfilt(sos6, x.astype(np.complex128), axis=0)
    smoke.line("channel_bank", channels=M, sections=sos.shape[0],
               time_steps=T, compile_s=c_s, memory=mem, seconds=t,
               mchannel_samples_per_s=M * T / t / 1e6)
    smoke.check("channel_bank", "vs sosfilt float64",
                snr_db(ref, np.asarray(y)), 90.0)
    top_device_ops(smoke, "channel_bank_trace", compiled, sosd, st, xd)


def phase_replaced(smoke: Smoke):
    """Where each removed hand kernel's replacement is measured."""
    smoke.line("replaced", kernels={
        "fused DDC+FM (Mosaic)": "rx_ingest planar/x3 + rx_ingest_trace",
        "fused channelizer (Mosaic)": "channelizer + channelizer_trace",
        "PFB front end (Mosaic)": "channelizer + channelizer_trace",
        "IIR biquad bank (Mosaic)": "channel_bank + channel_bank_trace",
        "4-step windowed FFT (Mosaic)": "wfft + wfft_trace",
        "Farrow resampler (Mosaic)": "ops/gridresample, off the main "
                                     "path: no phase",
        "remote-DMA halo (Mosaic)": "lax.ppermute: --four-cards"})


# --------------------------------------------------------------------------
# four cards: the sharded paths and their single-card comparison
# --------------------------------------------------------------------------

def phase_four_rx_time(smoke: Smoke):
    """1 x 4 time-split mesh: one wideband stream, 2 carried blocks."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from solid_dsp_tpu.models.rx_chain import RxChainConfig, make_rx_chain
    from solid_dsp_tpu.parallel import make_mesh, make_sharded_rx_chain
    from jax.sharding import NamedSharding, PartitionSpec as P

    s = smoke.sizes
    L = 4 * s.four_rx_per_card
    cfg = RxChainConfig(demod="fm", nco_mode="exact", agc_mode="block",
                        fused_ddc="on", fir_precision="x3",
                        input_format="planar", dtype=jnp.complex64)
    ci16, _ = fm_signal(L, 2, seed=7)
    planes = [np.ascontiguousarray(
        (b.astype(np.float32) * np.float32(1 / 32767.0)).T)
        for b in np.split(ci16, 2)]
    mesh = make_mesh(channel=1, time=4)
    init_s, apply_s = make_sharded_rx_chain(cfg, mesh)
    sh = NamedSharding(mesh, P(None, "time"))
    xs = [jax.device_put(p, sh) for p in planes]
    st = init_s()
    compiled, c_s, mem = compile_jit(apply_s, st, xs[0])
    jax.block_until_ready(compiled(st, xs[0]))         # first-run set-up
    outs, t_total = [], 0.0
    for x in xs:
        t0 = time.perf_counter()
        y, st = jax.block_until_ready(compiled(st, x))
        t_total += time.perf_counter() - t0
        outs.append(np.asarray(y))
    got = np.concatenate(outs)
    init1, apply1 = make_rx_chain(cfg)
    st1 = init1()
    ref = []
    for p in planes:
        y, st1 = apply1(st1, jax.device_put(p, jax.devices()[0]))
        ref.append(np.asarray(y))
    ref = np.concatenate(ref)
    smoke.line("four_rx_time", mesh="1x4", block_samples=L,
               samples_per_card=L // 4, compile_s=c_s, memory=mem,
               seconds_per_block=t_total / 2,
               msamples_per_s=2 * L / t_total / 1e6)
    smoke.check("four_rx_time", "sharded vs single card", snr_db(ref, got),
                100.0)


def phase_four_rx_streams(smoke: Smoke):
    """2 x 2 mesh: 4 streams (channel axis) x 2 time shards."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from solid_dsp_tpu.models.rx_chain import RxChainConfig, make_rx_chain
    from solid_dsp_tpu.parallel import make_mesh, make_sharded_rx_chain
    from jax.sharding import NamedSharding, PartitionSpec as P

    s = smoke.sizes
    L = s.four_rx_per_card                 # per stream; 2 streams x L/2
    cfg = RxChainConfig(demod="fm", nco_mode="exact", agc_mode="block",
                        fused_ddc="on", fir_precision="x3",
                        input_format="cf32", dtype=jnp.complex64)
    streams = [fm_signal(L, 2, seed=10 + c)[1] for c in range(4)]
    xs = [np.stack([st[b * L:(b + 1) * L] for st in streams])
          for b in range(2)]                                   # (4, L)
    mesh = make_mesh(channel=2, time=2)
    init_s, apply_s = make_sharded_rx_chain(cfg, mesh)
    sh = NamedSharding(mesh, P("channel", "time"))
    xd = [jax.device_put(x, sh) for x in xs]
    st = init_s(4)
    compiled, c_s, mem = compile_jit(apply_s, st, xd[0])
    jax.block_until_ready(compiled(st, xd[0]))         # first-run set-up
    outs, t_total = [], 0.0
    for x in xd:
        t0 = time.perf_counter()
        y, st = jax.block_until_ready(compiled(st, x))
        t_total += time.perf_counter() - t0
        outs.append(np.asarray(y))
    got = np.concatenate(outs, axis=1)                         # (4, 2T)
    init1, apply1 = make_rx_chain(cfg)
    worst = float("inf")
    for c in range(4):
        st1 = init1()
        ref = []
        for b in range(2):
            y, st1 = apply1(st1, jax.device_put(xs[b][c], jax.devices()[0]))
            ref.append(np.asarray(y))
        worst = min(worst, snr_db(np.concatenate(ref), got[c]))
    smoke.line("four_rx_streams", mesh="2x2", streams=4,
               samples_per_stream_block=L, compile_s=c_s, memory=mem,
               seconds_per_block=t_total / 2,
               msamples_per_s=2 * 4 * L / t_total / 1e6)
    smoke.check("four_rx_streams", "worst stream vs single card", worst,
                100.0)


def phase_four_channelizer(smoke: Smoke):
    """Channel-split mesh (4 x 1): tap- and channel-parallel bank."""
    import jax
    import numpy as np

    from solid_dsp_tpu.models.channelizer import PolyphaseChannelizer
    from solid_dsp_tpu.parallel import make_mesh, make_sharded_channelizer
    from jax.sharding import NamedSharding, PartitionSpec as P

    s = smoke.sizes
    M, K, L = s.chan_m, s.chan_k, s.four_chan_block
    rng = np.random.default_rng(8)
    x = ((rng.standard_normal(2 * L) + 1j * rng.standard_normal(2 * L))
         * 0.5).astype(np.complex64)
    mesh = make_mesh(channel=4, time=1)
    init_s, apply_s = make_sharded_channelizer(M, K, mesh=mesh)
    sh = NamedSharding(mesh, P("time"))
    xd = [jax.device_put(b, sh) for b in np.split(x, 2)]
    tail = init_s()
    compiled, c_s, mem = compile_jit(apply_s, tail, xd[0])
    jax.block_until_ready(compiled(tail, xd[0]))       # first-run set-up
    outs, t_total = [], 0.0
    for xb in xd:
        t0 = time.perf_counter()
        Y, tail = jax.block_until_ready(compiled(tail, xb))
        t_total += time.perf_counter() - t0
        outs.append(np.asarray(Y))
    ch = PolyphaseChannelizer(M, K)
    ref = np.concatenate([np.asarray(ch.execute_block(
        jax.device_put(b, jax.devices()[0]))) for b in np.split(x, 2)])
    got = np.concatenate(outs)
    smoke.line("four_channelizer", mesh="4x1 (channel split)", M=M, K=K,
               block_samples=L, compile_s=c_s, memory=mem,
               seconds_per_block=t_total / 2,
               msamples_per_s=2 * L / t_total / 1e6)
    smoke.check("four_channelizer", "sharded vs single card",
                snr_db(ref, got), 100.0)
    top_device_ops(smoke, "four_channelizer_trace", compiled, tail, xd[0])


SINGLE = (("device", phase_device), ("rx_fm", phase_rx_fm),
          ("rx_qpsk", phase_rx_qpsk), ("rx_ingest", phase_rx_ingest),
          ("cli_fm", phase_cli_fm), ("fir", phase_fir),
          ("channelizer", phase_channelizer), ("wfft", phase_wfft),
          ("channel_bank", phase_channel_bank),
          ("replaced", phase_replaced))
FOUR = (("device", phase_device), ("four_rx_time", phase_four_rx_time),
        ("four_rx_streams", phase_four_rx_streams),
        ("four_channelizer", phase_four_channelizer))


# --------------------------------------------------------------------------
# entry point
# --------------------------------------------------------------------------

def card_line() -> str:
    """``nvidia-smi`` name and power limit of the card(s)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().replace("\n", " | ")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded paths on four cards")
    ap.add_argument("--rehearse", action="store_true",
                    help="CPU rehearsal at tiny sizes (never a GPU run)")
    args = ap.parse_args(argv)
    n_cards = 4 if args.four_cards else 1
    if args.rehearse:
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                                   " --xla_force_host_platform_device_count"
                                   f"={n_cards}").strip()
    import jax

    if args.rehearse:
        jax.config.update("jax_platforms", "cpu")
    try:
        import solid_dsp_tpu  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the solid_dsp_tpu package is missing ({e})",
              file=sys.stderr)
        return 2
    from solid_dsp_tpu.utils.compile_cache import enable_compile_cache

    devs = jax.devices()
    platform = devs[0].platform
    if args.rehearse:
        if platform != "cpu":
            print("chip_smoke: --rehearse runs on the CPU only",
                  file=sys.stderr)
            return 2
    elif platform != "gpu":
        print(f"chip_smoke: needs a GPU; JAX found {platform!r}",
              file=sys.stderr)
        return 2
    if len(devs) < n_cards:
        print(f"chip_smoke: needs {n_cards} devices, JAX found "
              f"{len(devs)}", file=sys.stderr)
        return 2
    if not args.rehearse:
        print(f"compile cache: {enable_compile_cache()}", flush=True)
        print(f"card: {card_line()}", flush=True)
    WORK.mkdir(parents=True, exist_ok=True)
    smoke = Smoke(TINY if args.rehearse else FULL, args.rehearse)
    for name, fn in (FOUR if args.four_cards else SINGLE):
        smoke.run(name, fn)
    if smoke.failures:
        print("chip_smoke FAILED: " + "; ".join(smoke.failures),
              file=sys.stderr)
        return 1
    if args.rehearse:
        print(json.dumps({"rehearsal": "passed", "phases": len(
            FOUR if args.four_cards else SINGLE)}))
        return 0
    print(json.dumps({"ok": True, "device": {
        "platform": platform, "kind": devs[0].device_kind,
        "count": n_cards if args.four_cards else 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
