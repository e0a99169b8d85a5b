"""DTMF (touch-tone) generator and decoder.

The telephony classic, built directly on the framework's matmul Goertzel
bank (analysis/spectral.py): each analysis frame projects onto the 8
DTMF probe tones in ONE (F, N) @ (N, 8) matmul, then a tiny host state
machine validates the 2-of-8 structure (one row + one column tone
dominant, twist within limits) and debounces digits across frames.

ITU-T Q.23/Q.24-shaped acceptance: both tones within the frame, each
>= ``threshold`` of full scale, forward/reverse twist bounded, a digit
registered after ``min_frames`` consecutive detections and re-armed
only after a silent/invalid frame.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..analysis.spectral import goertzel_bank

__all__ = ["DTMF_ROWS", "DTMF_COLS", "dtmf_generate", "dtmf_decode"]

DTMF_ROWS = (697.0, 770.0, 852.0, 941.0)
DTMF_COLS = (1209.0, 1336.0, 1477.0, 1633.0)
_KEYS = ["123A", "456B", "789C", "*0#D"]


def _key(r: int, c: int) -> str:
    return _KEYS[r][c]


def dtmf_generate(digits: str, fs: float = 8000.0,
                  tone_ms: float = 80.0, gap_ms: float = 80.0,
                  amp: float = 0.5) -> np.ndarray:
    """Key a DTMF sequence (real samples at fs)."""
    n_on = int(round(tone_ms * 1e-3 * fs))
    n_off = int(round(gap_ms * 1e-3 * fs))
    out = [np.zeros(n_off)]
    for d in digits:
        hit = [(r, c) for r in range(4) for c in range(4)
               if _key(r, c) == d.upper()]
        if not hit:
            raise ValueError(f"not a DTMF symbol: {d!r}")
        r, c = hit[0]
        t = np.arange(n_on) / fs
        tone = amp * (np.sin(2 * np.pi * DTMF_ROWS[r] * t)
                      + np.sin(2 * np.pi * DTMF_COLS[c] * t))
        out += [tone, np.zeros(n_off)]
    return np.concatenate(out).astype(np.float32)


def dtmf_decode(x, fs: float = 8000.0, frame_len: int = 160,
                threshold: float = 0.1, max_twist_db: float = 8.0,
                min_frames: int = 2) -> str:
    """Decode a DTMF sequence from real (or complex) samples at fs.

    frame_len: analysis frame (160 = 20 ms at 8 kHz).  threshold:
    minimum per-tone amplitude (of the generator's unit scale).
    """
    x = np.asarray(x)
    if x.shape[-1] < frame_len:
        return ""                              # shorter than one frame
    freqs = tuple(f / fs for f in DTMF_ROWS + DTMF_COLS)
    A = np.abs(np.asarray(goertzel_bank(jnp.asarray(x), freqs,
                                        frame_len)))      # (F, 8)
    rows, cols = A[:, :4], A[:, 4:]
    out = []
    run_key, run_len, armed = None, 0, True
    for f in range(A.shape[0]):
        r = int(np.argmax(rows[f]))
        c = int(np.argmax(cols[f]))
        pr, pc = rows[f, r], cols[f, c]
        ok = pr > threshold and pc > threshold
        if ok:
            # 2-of-8 purity: each winner clearly beats its group
            others_r = np.partition(rows[f], 2)[2]
            others_c = np.partition(cols[f], 2)[2]
            ok = pr > 2.0 * others_r and pc > 2.0 * others_c
        if ok:
            twist = 20.0 * np.log10(max(pr, pc) / max(min(pr, pc), 1e-12))
            ok = twist <= max_twist_db
        if ok:
            key = _key(r, c)
            if key != run_key:
                run_len = 1
                armed = True                  # a key CHANGE is a new digit
            else:
                run_len += 1
            run_key = key
            if armed and run_len >= min_frames:
                out.append(key)
                armed = False
        else:
            run_key, run_len, armed = None, 0, True
    return "".join(out)
