"""CW (Morse code) keyer and decoder.

The oldest digital mode, still everywhere on HF — and a nice stress of
the detection stack: the decoder is envelope detection + an adaptive
threshold + run-length classification, with the dit period estimated
blindly from the mark-duration statistics (no WPM prior).

Formulation: the per-sample work (envelope, smoothing, threshold)
is batched device math; the run-length/ symbol logic operates on the
tiny sequence of on/off segments host-side.  Decoding is tolerant to
+-30% timing jitter per element (hand keying) via ratio thresholds.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..ops.fir import conv1d_mxu

__all__ = ["MORSE", "cw_keyer", "cw_decode", "text_to_morse"]

MORSE = {
    "A": ".-", "B": "-...", "C": "-.-.", "D": "-..", "E": ".",
    "F": "..-.", "G": "--.", "H": "....", "I": "..", "J": ".---",
    "K": "-.-", "L": ".-..", "M": "--", "N": "-.", "O": "---",
    "P": ".--.", "Q": "--.-", "R": ".-.", "S": "...", "T": "-",
    "U": "..-", "V": "...-", "W": ".--", "X": "-..-", "Y": "-.--",
    "Z": "--..",
    "0": "-----", "1": ".----", "2": "..---", "3": "...--", "4": "....-",
    "5": ".....", "6": "-....", "7": "--...", "8": "---..", "9": "----.",
    ".": ".-.-.-", ",": "--..--", "?": "..--..", "/": "-..-.",
    "=": "-...-", "+": ".-.-.",
}
_INV = {v: k for k, v in MORSE.items()}


def text_to_morse(text: str) -> str:
    """Text -> dot/dash string with ' ' between letters, ' / ' words."""
    words = text.upper().split()
    return " / ".join(" ".join(MORSE[c] for c in w if c in MORSE)
                      for w in words)


def cw_keyer(text: str, dit_samples: int = 64, freq: float = 0.1,
             amp: float = 1.0) -> jnp.ndarray:
    """Key a CW waveform: standard 1/3/7-dit spacing, complex tone.

    Element timing: dit = 1 unit on, dah = 3 on; 1 off between elements,
    3 off between letters, 7 off between words.
    """
    if dit_samples < 4:
        raise ValueError("dit_samples must be >= 4")
    on = []
    for word in text.upper().split():
        for letter in word:
            code = MORSE.get(letter)
            if code is None:
                continue
            for sym in code:
                on += [1] * ((1 if sym == "." else 3) * dit_samples)
                on += [0] * dit_samples
            on += [0] * (2 * dit_samples)        # 1 + 2 = 3 dits
        on += [0] * (4 * dit_samples)            # 3 + 4 = 7 dits
    gate = np.asarray(on[:-4 * dit_samples] if on else on, np.float32)
    n = len(gate)
    tone = np.exp(2j * np.pi * freq * np.arange(n)).astype(np.complex64)
    return jnp.asarray(amp * gate * tone)


def cw_decode(x, dit_samples: int | None = None,
              smooth: int = 9) -> str:
    """Decode a CW waveform (complex baseband or real audio) to text.

    Envelope -> moving-average smoothing -> adaptive threshold (midpoint
    of the on/off envelope levels) -> run lengths -> blind dit-period
    estimate (smallest duration cluster over marks AND inter-mark gaps,
    robust to dot-free text like "TOM" and to isolated noise spikes) ->
    ratio classification.  ``dit_samples`` overrides the blind estimate
    (and its noise squelch) when the speed is known.

    For REAL audio input, set ``smooth`` to at least one carrier period
    (e.g. fs/f samples): |real tone| ripples at 2f and a too-short
    moving average chops each mark into fragments.  Complex baseband
    has a flat envelope and works with the default.
    """
    x = jnp.asarray(x)
    env = jnp.abs(x).astype(jnp.float32)
    if smooth > 1:
        k = jnp.ones(smooth, jnp.float32) / smooth
        env = conv1d_mxu(jnp.concatenate(
            [env, jnp.zeros(smooth - 1, jnp.float32)]), k)
    e = np.asarray(env)
    if not e.size or float(e.max()) <= 0.0:
        return ""
    hi = float(np.percentile(e, 95))
    lo = float(np.percentile(e, 5))
    if hi - lo < 0.25 * hi:                   # no keying present
        return ""
    # bimodality gate: keyed CW has duty < ~55%, so the 35th-percentile
    # level sits on the OFF floor, far below the on level; a noise-only
    # envelope is unimodal (ratio ~1.3 after smoothing) and is squelched
    if hi < 2.0 * float(np.percentile(e, 35)):
        return ""
    thr = 0.5 * (hi + lo)
    gate = e > thr
    # run-length extraction
    edges = np.flatnonzero(np.diff(gate.astype(np.int8)))
    bounds = np.r_[0, edges + 1, len(gate)]
    runs = [(bool(gate[a]), b - a) for a, b in zip(bounds, bounds[1:])]
    marks = np.asarray([r for on, r in runs if on])
    if len(marks) == 0:
        return ""
    if dit_samples:
        dit = float(dit_samples)
    else:
        # duration pool: marks plus INTERIOR gaps — inter-element gaps
        # are exactly 1 dit in every message (even dot-free ones like
        # "TOM", whose shortest mark is a 3-dit dah).  Runs at or below
        # the smoothing span are noise crossings, not keying: drop them
        # so one impulse cannot poison the minimum, and require at least
        # one surviving MARK (gaps alone = nothing was keyed).
        floor = 2.0 * smooth + 4.0
        good_marks = [r for on_, r in runs if on_ and r > floor]
        if not good_marks:
            return ""                         # squelch: nothing keyed
        gaps = [r for i, (on_, r) in enumerate(runs)
                if not on_ and 0 < i < len(runs) - 1 and r > floor]
        durs = np.asarray(good_marks + gaps, float)
        dit = float(np.median(durs[durs <= 2.0 * durs.min()]))
    out = []
    letter = ""
    for i, (on, r) in enumerate(runs):
        u = r / dit
        if on:
            letter += "." if u < 2.0 else "-"
        else:
            if i == 0 or i == len(runs) - 1:
                continue                       # leading/trailing silence
            if u >= 4.5:                       # word gap (7 dits, -30%)
                out.append(_INV.get(letter, "?"))
                out.append(" ")
                letter = ""
            elif u >= 2.0:                     # letter gap (3 dits)
                out.append(_INV.get(letter, "?"))
                letter = ""
    if letter:
        out.append(_INV.get(letter, "?"))
    return "".join(out).strip()
