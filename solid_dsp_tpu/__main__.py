"""Command-line interface: ``python -m solid_dsp_tpu <command>``.

The reference ships one demo binary (src/main.rs:25-46: 102,400-sample NCO
tone through a PLL active-lag IIR filter); ``demo`` reproduces exactly that
chain.  The other subcommands expose the framework as a usable SDR tool:

* ``demo``     — reference main.rs parity run (prints head of the output)
* ``rx``       — demodulate an IQ recording through the flagship RxChain
               (``--wav [--stereo]`` writes broadcast audio)
* ``resample`` — rate-convert an IQ recording by any real factor
* ``monitor``  — channel-occupancy events over a wideband recording
* ``packets``  — decode framed packet bursts (single-carrier or OFDM)
* ``convert``  — convert IQ recording formats (incl. rtl_sdr cu8)
* ``spectrum`` — windowed-FFT spectral analysis of a recording (config 2)
* ``bench``    — the headline throughput benchmark (same as bench.py)
* ``tx``       — synthesize an IQ recording with the transmit chain
* ``adsb``     — decode ADS-B / Mode S frames from a recording
* ``ais``      — decode AIS bursts from a GMSK baseband recording
"""

from __future__ import annotations

import argparse
import json
import sys
import time

def _fetch(x):
    from .utils.transfer import fetch

    return fetch(x)


def _put(x):
    from .utils.transfer import put_array

    return put_array(x)


def _cmd_demo(args) -> int:
    import jax.numpy as jnp
    import numpy as np

    from .design import iirdes
    from .ops.iir import IIRFilter, IIRFilterType
    from .ops.nco import NCO

    n = args.samples
    nco = NCO()
    nco.set_frequency(0.1)
    tone = np.empty(n, dtype=np.complex128)
    s, c = nco.sincos_block(n)
    tone.real, tone.imag = np.asarray(c), np.asarray(s)

    num, den = iirdes.pll_active_lag(0.02, 1.0 / np.sqrt(2.0), 1000.0)
    filt = IIRFilter(num, den, iirtype=IIRFilterType.SECOND_ORDER,
                     dtype=jnp.complex128)
    t0 = time.perf_counter()
    from .utils.transfer import fetch, put_array

    out = filt.execute_block(put_array(tone))
    dt = time.perf_counter() - t0
    out = fetch(out)
    print(f"filtered {n} samples in {dt * 1e3:.2f} ms")
    for i in range(min(5, len(out))):
        print(f"  out[{i}] = {out[i]:.12f}")
    return 0


def _cmd_rx(args) -> int:
    import jax.numpy as jnp
    import numpy as np

    from .models.rx_chain import RxChain
    from .runtime import StreamPump, write_iq

    chain = RxChain(
        carrier_freq=args.carrier, decimation=args.decimation,
        fir_taps=args.taps, demod=args.demod, nco_mode="exact",
        agc_mode="block", dtype=jnp.complex64,
    )
    outs = []
    t0 = time.perf_counter()
    nsamp = 0
    # '-' composes with SDR tools: rtl_sdr - | python -m solid_dsp_tpu rx -
    path = "/dev/stdin" if args.input == "-" else args.input
    with StreamPump(path, fmt=args.format, block=args.block) as pump:
        for blk in pump:
            if len(blk) % args.decimation:
                blk = blk[: len(blk) - len(blk) % args.decimation]
            if not len(blk):
                break
            outs.append(_fetch(chain.execute_block(blk)))
            nsamp += len(blk)
    dt = time.perf_counter() - t0
    y = np.concatenate(outs) if outs else np.zeros(0, np.float32)
    print(f"processed {nsamp} samples in {dt:.3f}s "
          f"({nsamp / max(dt, 1e-9) / 1e6:.1f} Msps)", file=sys.stderr)
    if args.output:
        if args.demod in ("fm", "am"):
            write_iq(args.output, y.astype(np.complex64), "cf32")
        else:
            write_iq(args.output, y, "cf32")
        print(f"wrote {len(y)} output samples -> {args.output}",
              file=sys.stderr)
    if args.stereo and not args.wav:
        print("--stereo needs --wav (it selects the WAV decode path)",
              file=sys.stderr)
        return 1
    if args.wav:
        if args.demod not in ("fm", "am"):
            print("--wav needs an audio demod (fm/am)", file=sys.stderr)
            return 1
        if not args.rate:
            print("--wav needs --rate (input sample rate in Hz)",
                  file=sys.stderr)
            return 1
        demod_rate = args.rate / args.decimation
        if args.stereo:
            if args.demod != "fm":
                print("--stereo needs --demod fm", file=sys.stderr)
                return 1
            from .models.fm import fm_stereo_decode

            L, R, pilot = fm_stereo_decode(
                jnp.asarray(y.real.astype(np.float32)), demod_rate,
                deemphasis_tau=75e-6)
            audio = np.stack([np.asarray(L), np.asarray(R)])
            print(f"stereo pilot amplitude {float(pilot):.3f}",
                  file=sys.stderr)
            n = _write_audio_wav(args.wav, audio, demod_rate,
                                 args.audio_rate, deemphasis=False)
        else:
            n = _write_audio_wav(args.wav, y.real.astype(np.float32),
                                 demod_rate, args.audio_rate,
                                 deemphasis=(args.demod == "fm"))
        print(f"wrote {n} audio samples -> {args.wav} "
              f"({args.audio_rate} Hz s16 "
              f"{'stereo' if args.stereo else 'mono'})", file=sys.stderr)
    return 0


def _write_audio_wav(path: str, audio, rate_in: float, rate_out: int,
                     deemphasis: bool) -> int:
    """Demod output at rate_in Hz -> 16-bit PCM WAV at rate_out.

    audio: (N,) mono or (C, N) multichannel (each channel resampled
    through its own streaming chain and peak-normalized jointly).
    """
    import wave

    import jax.numpy as jnp
    import numpy as np

    from .ops.resample import ArbitraryResampler

    audio = np.atleast_2d(np.asarray(audio))
    chans = []
    for ch in audio:
        r = ArbitraryResampler(rate_out / rate_in, dtype=jnp.complex64)
        a = _fetch(r.execute_block(
            _put(ch.astype(np.complex64))))
        a = np.concatenate([a, _fetch(r.flush())]).real
        chans.append(a)
    n = min(len(a) for a in chans)
    a = np.stack([c[:n] for c in chans])          # (C, N)
    if deemphasis and a.size:
        # 75 us broadcast-FM de-emphasis: single-pole IIR at audio rate
        tau = 75e-6
        alpha = float(np.exp(-1.0 / (tau * rate_out)))
        from .ops.iir import iir_apply, iir_init

        rows = []
        for ch in a:                     # <= 2 channels: loop is fine
            y, _ = iir_apply(_put(np.asarray([1.0 - alpha], np.complex64)),
                             _put(np.asarray([-alpha], np.complex64)),
                             iir_init(1), _put(np.asarray(ch, np.complex64)))
            rows.append(_fetch(y).real)
        a = np.stack(rows)
    peak = float(np.max(np.abs(a))) if a.size else 1.0
    pcm = np.clip(a / (peak or 1.0) * 0.95 * 32767,
                  -32768, 32767).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(a.shape[0])
        w.setsampwidth(2)
        w.setframerate(int(rate_out))
        w.writeframes(pcm.T.copy(order="C").tobytes())  # interleaved
    return pcm.shape[-1]


def _cmd_spectrum(args) -> int:
    import numpy as np

    from .ops.fft import windowed_fft
    from .runtime import read_iq

    x = read_iq(args.input, args.format, count=args.nfft)
    if len(x) < args.nfft:
        print(f"recording shorter than nfft ({len(x)} < {args.nfft})",
              file=sys.stderr)
        return 1
    X = _fetch(windowed_fft(x, window=args.window, nfft=args.nfft))
    psd = 20.0 * np.log10(np.abs(np.fft.fftshift(X)) + 1e-20)
    peak = float(psd.max())
    k = int(psd.argmax())
    freq = (k - args.nfft // 2) / args.nfft
    print(json.dumps({
        "nfft": args.nfft, "window": args.window,
        "peak_db": round(peak, 2), "peak_freq": round(freq, 6),
        "noise_floor_db": round(float(np.median(psd)), 2),
    }))
    return 0


def _cmd_bench(args) -> int:
    # bench.py lives at the repo root, not in the package: resolve it
    # relative to the package so `python -m solid_dsp_tpu bench` works from
    # any CWD (and fail with a clear message on bench-less installs).
    import importlib
    import os
    import sys

    try:
        bench = importlib.import_module("bench")
    except ModuleNotFoundError:
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        if not os.path.exists(os.path.join(root, "bench.py")):
            print("bench.py not found (source checkout required)",
                  file=sys.stderr)
            return 1
        sys.path.insert(0, root)
        bench = importlib.import_module("bench")

    return bench.main()


def _cmd_tx(args) -> int:
    """Synthesize an IQ recording with the transmit chain."""
    import numpy as np

    from .models.tx_chain import TxChain, TxChainConfig
    from .runtime import write_iq

    n = args.samples
    if args.mod == "fm":
        msg = np.sin(2 * np.pi * args.tone * np.arange(n))
    elif args.mod in ("psk", "qam"):
        rng = np.random.default_rng(args.seed)
        k = max(1, int(np.log2(args.order)))
        n -= n % k  # whole symbols only
        msg = rng.integers(0, 2, n)
    else:  # none: a complex test tone
        msg = np.exp(2j * np.pi * args.tone * np.arange(n))
    tx = TxChain(TxChainConfig(modulation=args.mod, order=args.order,
                               carrier_freq=args.carrier,
                               interpolation=args.interp))
    iq = _fetch(tx.execute_block(_put(msg))).astype(np.complex64)
    write_iq(args.output, iq, args.format)
    print(json.dumps({"output": args.output, "samples": int(len(iq)),
                      "format": args.format, "mod": args.mod,
                      "carrier": args.carrier}))
    return 0


def _cmd_convert(args) -> int:
    import numpy as np

    from .runtime import StreamPump, write_iq

    # chunked: constant memory for arbitrarily large captures
    path = "/dev/stdin" if args.input == "-" else args.input
    total = 0
    first = True
    with StreamPump(path, fmt=args.format, block=args.block) as pump:
        for blk in pump:
            if not len(blk):
                break
            write_iq(args.output, _fetch(blk), args.out_format,
                     append=not first)
            first = False
            total += len(blk)
    if first:                                   # empty input: valid file
        write_iq(args.output, np.zeros(0, np.complex64),
                 args.out_format)
    print(f"converted {total} samples {args.format} -> "
          f"{args.out_format}", file=sys.stderr)
    return 0


def _cmd_packets(args) -> int:
    from .runtime import read_iq

    x = read_iq(args.input, args.format)
    try:
        if args.phy == "ofdm":
            from .models.ofdm_link import OFDMModem

            modem = OFDMModem(payload_bytes=args.payload_bytes,
                              m=args.order, scheme=args.scheme,
                              fec_scheme=args.fec)
        else:
            from .models.packet import PacketModem

            modem = PacketModem(payload_bytes=args.payload_bytes,
                                m=args.order, scheme=args.scheme,
                                fec_scheme=args.fec)
    except ValueError as e:
        print(str(e), file=sys.stderr)
        return 1
    try:
        results = modem.receive_stream(x, max_bursts=args.max_bursts)
    except ValueError as e:
        # e.g. a capture truncated mid-burst: report instead of crashing
        print(json.dumps({"bursts": 0, "crc_ok": 0,
                          "error": str(e)[:160]}))
        return 0
    n_ok = 0
    for data, info in results:
        row = {"offset": int(info["offset"]),
               "crc_ok": bool(info["crc_ok"])}
        if info["crc_ok"]:
            row["payload_hex"] = data.hex()
            n_ok += 1
        print(json.dumps(row))
    print(json.dumps({"bursts": len(results), "crc_ok": n_ok}))
    return 0


def _cmd_monitor(args) -> int:
    import numpy as np

    from .models.monitor import SpectrumMonitor
    from .runtime import StreamPump

    mon = SpectrumMonitor(args.channels, high_db=args.high,
                          low_db=args.low)
    path = "/dev/stdin" if args.input == "-" else args.input
    emitted = 0
    rem = np.zeros(0, np.complex64)     # channelizer alignment carry
    with StreamPump(path, fmt=args.format, block=args.block) as pump:
        for blk in pump:
            blk = np.concatenate([rem, _fetch(blk)])
            keep = len(blk) - len(blk) % args.channels
            rem = blk[keep:]
            blk = blk[:keep]
            if not len(blk):
                continue
            mon.execute_block(blk)
            while emitted < len(mon.events):
                print(json.dumps(mon.events[emitted]))
                emitted += 1
    print(json.dumps(mon.summary()))
    return 0


def _cmd_resample(args) -> int:
    import numpy as np

    from .ops.resample import ArbitraryResampler
    from .runtime import StreamPump, write_iq

    if args.rate <= 0:
        print("rate must be positive", file=sys.stderr)
        return 1
    r = ArbitraryResampler(args.rate, fpass=args.fpass,
                           stop_band_attenuation=args.attenuation)
    outs = []
    nsamp = 0
    t0 = time.perf_counter()
    path = "/dev/stdin" if args.input == "-" else args.input
    with StreamPump(path, fmt=args.format, block=args.block) as pump:
        for blk in pump:
            if not len(blk):
                break
            y = _fetch(r.execute_block(blk))
            if len(y):
                outs.append(y)
            nsamp += len(blk)
    # drain the cascade's group delay + alignment remainder, then cap at
    # the canonical converted length (a one-shot file conversion must
    # not silently drop the tail of the recording)
    tail = _fetch(r.flush())
    if len(tail):
        outs.append(tail)
    dt = time.perf_counter() - t0
    y = (np.concatenate(outs) if outs
         else np.zeros(0, np.complex64))
    y = y[: int(round(nsamp * args.rate))]
    print(f"resampled {nsamp} -> {len(y)} samples (rate {args.rate:g}) "
          f"in {dt:.3f}s ({nsamp / max(dt, 1e-9) / 1e6:.1f} Msps in)",
          file=sys.stderr)
    write_iq(args.output, y.astype(np.complex64), args.out_format)
    return 0


def _cmd_adsb(args) -> int:
    import numpy as np

    from .models import adsb
    from .runtime import read_iq

    x = read_iq(args.input, fmt=args.format)
    frames = adsb.decode(np.asarray(x), sps=args.sps,
                         threshold=args.threshold)
    for fr in frames:
        if fr["crc_ok"] or args.all:
            print(json.dumps({
                "start": fr["start"], "df": fr["df"],
                "icao": f"{fr['icao']:06X}", "crc_ok": fr["crc_ok"],
                "confidence": round(fr["confidence"], 3)}))
    print(json.dumps({"frames": len(frames),
                      "crc_ok": sum(f["crc_ok"] for f in frames)}),
          file=sys.stderr)
    return 0


def _cmd_ais(args) -> int:
    import numpy as np

    from .models import ais
    from .runtime import read_iq

    x = read_iq(args.input, fmt=args.format)
    frames = ais.ais_receive(np.asarray(x), sps=args.sps)
    n_ok = 0
    for payload, ok in frames:
        if not ok and not args.all:
            continue
        n_ok += bool(ok)
        row = {"crc_ok": bool(ok), "bits": int(len(payload))}
        if len(payload) >= 168:
            try:
                row.update(ais.parse_type123(payload[:168]))
            except Exception:
                pass
        print(json.dumps(row))
    print(json.dumps({"frames": len(frames), "crc_ok": n_ok}),
          file=sys.stderr)
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="solid_dsp_tpu")
    sub = p.add_subparsers(dest="cmd", required=True)

    d = sub.add_parser("demo", help="reference main.rs demo chain")
    d.add_argument("--samples", type=int, default=102_400)
    d.set_defaults(fn=_cmd_demo)

    r = sub.add_parser("rx", help="demodulate an IQ recording")
    r.add_argument("input")
    r.add_argument("-o", "--output", default=None)
    r.add_argument("--format", default="cf32",
                   choices=["cf32", "ci16", "ci8", "cf64", "cu8"])
    r.add_argument("--carrier", type=float, default=0.2)
    r.add_argument("--decimation", type=int, default=4)
    r.add_argument("--taps", type=int, default=64)
    r.add_argument("--demod", default="fm", choices=["fm", "am", "qpsk",
                                                     "none"])
    r.add_argument("--block", type=int, default=1 << 20)
    r.add_argument("--wav", default=None,
                   help="also write demodulated audio as 16-bit mono WAV")
    r.add_argument("--rate", type=float, default=None,
                   help="input sample rate in Hz (required with --wav)")
    r.add_argument("--audio-rate", type=int, default=48000)
    r.add_argument("--stereo", action="store_true",
                   help="decode the broadcast stereo MPX (fm only)")
    r.set_defaults(fn=_cmd_rx)

    s = sub.add_parser("spectrum", help="windowed-FFT analysis")
    s.add_argument("input")
    s.add_argument("--format", default="cf32",
                   choices=["cf32", "ci16", "ci8", "cf64", "cu8"])
    s.add_argument("--nfft", type=int, default=4096)
    s.add_argument("--window", default="hamming")
    s.set_defaults(fn=_cmd_spectrum)

    b = sub.add_parser("bench", help="headline throughput benchmark")
    b.set_defaults(fn=_cmd_bench)

    t = sub.add_parser("tx", help="synthesize an IQ recording (TxChain)")
    t.add_argument("output")
    t.add_argument("--mod", default="fm", choices=["fm", "psk", "qam",
                                                   "none"])
    t.add_argument("--order", type=int, default=4)
    t.add_argument("--samples", type=int, default=1 << 16,
                   help="message samples (fm/none) or bits (psk/qam)")
    t.add_argument("--carrier", type=float, default=0.2)
    t.add_argument("--interp", type=int, default=4)
    t.add_argument("--tone", type=float, default=0.002)
    t.add_argument("--format", default="cf32",
                   choices=["cf32", "ci16", "ci8", "cf64", "cu8"])
    t.add_argument("--seed", type=int, default=0)
    t.set_defaults(fn=_cmd_tx)

    cv = sub.add_parser("convert", help="convert IQ recording formats")
    cv.add_argument("input")
    cv.add_argument("output")
    cv.add_argument("--format", default="cf32",
                    choices=["cf32", "ci16", "ci8", "cf64", "cu8"])
    cv.add_argument("--out-format", default="cf32",
                    choices=["cf32", "ci16", "ci8", "cf64", "cu8"])
    cv.add_argument("--block", type=int, default=1 << 20)
    cv.set_defaults(fn=_cmd_convert)

    pk = sub.add_parser("packets",
                        help="decode framed packet bursts (JSON lines)")
    pk.add_argument("input")
    pk.add_argument("--phy", default="psk", choices=["psk", "ofdm"])
    pk.add_argument("--format", default="cf32",
                    choices=["cf32", "ci16", "ci8", "cf64", "cu8"])
    pk.add_argument("--payload-bytes", type=int, default=64)
    pk.add_argument("--order", type=int, default=4)
    pk.add_argument("--scheme", default="psk",
                    choices=["psk", "qam", "apsk"])
    pk.add_argument("--fec", default="conv",
                    choices=["conv", "ldpc", "polar", "turbo"])
    pk.add_argument("--max-bursts", type=int, default=256)
    pk.set_defaults(fn=_cmd_packets)

    mo = sub.add_parser("monitor",
                        help="channel-occupancy events over a recording")
    mo.add_argument("input")
    mo.add_argument("--format", default="cf32",
                    choices=["cf32", "ci16", "ci8", "cf64", "cu8"])
    mo.add_argument("--channels", type=int, default=64)
    mo.add_argument("--high", type=float, default=10.0)
    mo.add_argument("--low", type=float, default=6.0)
    mo.add_argument("--block", type=int, default=1 << 18)
    mo.set_defaults(fn=_cmd_monitor)

    rs = sub.add_parser("resample",
                        help="rate-convert an IQ recording by any factor")
    rs.add_argument("input")
    rs.add_argument("output")
    rs.add_argument("--rate", type=float, required=True,
                    help="f_out / f_in (e.g. 0.5 halves the rate)")
    rs.add_argument("--format", default="cf32",
                    choices=["cf32", "ci16", "ci8", "cf64", "cu8"])
    rs.add_argument("--out-format", default="cf32",
                    choices=["cf32", "ci16", "ci8", "cf64", "cu8"])
    rs.add_argument("--fpass", type=float, default=0.4)
    rs.add_argument("--attenuation", type=float, default=60.0)
    rs.add_argument("--block", type=int, default=1 << 20)
    rs.set_defaults(fn=_cmd_resample)

    for name, fn, help_ in (("adsb", _cmd_adsb,
                             "decode ADS-B / Mode S frames (power or IQ)"),
                            ("ais", _cmd_ais,
                             "decode AIS bursts (GMSK baseband IQ)")):
        a = sub.add_parser(name, help=help_)
        a.add_argument("input")
        a.add_argument("--format", default="cf32",
                       choices=["cf32", "ci16", "ci8", "cf64", "cu8"])
        a.add_argument("--sps", type=int, default=2 if name == "adsb" else 8)
        if name == "adsb":
            a.add_argument("--threshold", type=float, default=0.7)
        a.add_argument("--all", action="store_true",
                       help="also print CRC-failed frames")
        a.set_defaults(fn=fn)

    args = p.parse_args(argv)
    if argv is None:
        # run as a program (python -m / the console script), not called
        # from Python: keep compiled programs across runs
        from .utils.compile_cache import enable_compile_cache

        enable_compile_cache()
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
