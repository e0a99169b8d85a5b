"""Scalar special functions used by filter design.

Parity: reference ``src/math/mod.rs`` — sinc (:12-27), besseli/lnbesseli
(:41-100), besselj (:102-145), gamma/lngamma (:155-184), csqrt (:186-224).

The reference evaluates these with fixed-length series (64 terms for I_nu,
128 for J_nu) and a recursive small-argument lnGamma; filter-design golden
values (BASELINE.md §B) depend on those exact formulas, so we reproduce the
same series in float64 NumPy here.  These are design-time (host) functions;
vectorized over NumPy arrays.  Device compute paths never call them per-sample.
"""

from __future__ import annotations

import numpy as np

__all__ = ["sinc", "besseli", "lnbesseli", "besselj", "gamma", "lngamma", "csqrt"]

_BESSEL_ITERATIONS = 64
_BESSEL_J_ITERATIONS = 128


def sinc(x):
    """sin(pi x)/(pi x), with the reference's small-|x| cosine-product form.

    Parity: ref math/mod.rs:18-27 — for |x| < 0.01 returns
    cos(pi x/2) cos(pi x/4) cos(pi x/8).
    """
    x = np.asarray(x, dtype=np.float64)
    small = np.abs(x) < 0.01
    approx = (
        np.cos(np.pi * x / 2.0) * np.cos(np.pi * x / 4.0) * np.cos(np.pi * x / 8.0)
    )
    with np.errstate(divide="ignore", invalid="ignore"):
        exact = np.sin(np.pi * x) / (np.pi * x)
    out = np.where(small, approx, exact)
    return out if out.ndim else float(out)


def lngamma(x):
    """log Gamma(x) for x >= 0 via the reference's recursion/asymptotic form.

    Parity: ref math/mod.rs:171-184 — for x < 10, lngamma(x) =
    lngamma(x+1) - ln(x) applied repeatedly; for x >= 10 a Stirling-like
    expression g = 0.5(ln 2pi - ln x) + x(ln(x + 1/(12x - 0.1/x)) - 1).
    For x < 0 the reference returns 0.0 (undefined); we do the same.
    """
    x = np.asarray(x, dtype=np.float64)
    scalar = x.ndim == 0
    x = np.atleast_1d(x).astype(np.float64).copy()
    out = np.zeros_like(x)
    neg = x < 0.0
    # lift every element to >= 10 while accumulating -ln terms
    acc = np.zeros_like(x)
    xx = np.where(neg, 10.0, x)  # placeholder for negatives
    while True:
        small = xx < 10.0
        if not small.any():
            break
        acc = np.where(small, acc - np.log(np.where(small, xx, 1.0)), acc)
        xx = np.where(small, xx + 1.0, xx)
    g = 0.5 * (np.log(2.0 * np.pi) - np.log(xx))
    g = g + xx * (np.log(xx + (1.0 / (12.0 * xx - 0.1 / xx))) - 1.0)
    out = acc + g
    out = np.where(neg, 0.0, out)
    return float(out[0]) if scalar else out


def gamma(x):
    """Gamma(x); reflection formula for x < 0.  Parity: ref math/mod.rs:156-169."""
    x = np.asarray(x, dtype=np.float64)
    scalar = x.ndim == 0
    x = np.atleast_1d(x)
    out = np.empty_like(x)
    neg = x < 0.0
    if neg.any():
        t0 = gamma(1.0 - x[neg])
        t1 = np.sin(np.pi * x[neg])
        out[neg] = np.pi / (t0 * t1)
    pos = ~neg
    out[pos] = np.exp(lngamma(x[pos]))
    return float(out[0]) if scalar else out


def lnbesseli(z, nu: float = 0.0):
    """log I_nu(z) via the reference's 64-term log-domain series.

    Parity: ref math/mod.rs:65-100.
    """
    z = np.asarray(z, dtype=np.float64)
    scalar = z.ndim == 0
    z = np.atleast_1d(z)
    out = np.empty_like(z)

    zero = z == 0.0
    out[zero] = 0.0 if nu == 0.0 else -np.finfo(np.float64).max

    rest = ~zero
    zr = z[rest]
    if zr.size:
        if nu == 0.5:
            out[rest] = 0.5 * np.log(2.0 / (np.pi * zr)) + np.log(np.sinh(zr))
        else:
            low = zr < 0.001 * np.sqrt(nu + 1.0)
            res = np.empty_like(zr)
            if low.any():
                res[low] = -gamma(nu + 1.0) + nu * np.log(0.5 * zr[low])
            hi = ~low
            if hi.any():
                zh = zr[hi]
                t0 = nu * np.log(0.5 * zh)
                y = np.zeros_like(zh)
                for k in range(_BESSEL_ITERATIONS):
                    t1 = 2.0 * k * np.log(0.5 * zh)
                    t2 = lngamma(k + 1.0)
                    t3 = lngamma(nu + k + 1.0)
                    y += np.exp(t1 - t2 - t3)
                res[hi] = t0 + np.log(y)
            out[rest] = res
    return float(out[0]) if scalar else out


def besseli(z, nu: float = 0.0):
    """Modified Bessel function of the first kind I_nu(z).

    Parity: ref math/mod.rs:41-63 (special cases for z==0, nu==1/2, small z;
    otherwise exp(lnbesseli)).
    """
    z = np.asarray(z, dtype=np.float64)
    scalar = z.ndim == 0
    z = np.atleast_1d(z)
    out = np.empty_like(z)

    zero = z == 0.0
    out[zero] = 1.0 if nu == 0.0 else 0.0

    rest = ~zero
    zr = z[rest]
    if zr.size:
        if nu == 0.5:
            out[rest] = np.sqrt(2.0 / (np.pi * zr)) * np.sinh(zr)
        else:
            low = zr < 0.001 * np.sqrt(nu + 1.0)
            res = np.empty_like(zr)
            if low.any():
                res[low] = (0.5 * zr[low]) ** nu / gamma(nu + 1.0)
            hi = ~low
            if hi.any():
                res[hi] = np.exp(lnbesseli(zr[hi], nu))
            out[rest] = res
    return float(out[0]) if scalar else out


def besselj(z, nu: float = 0.0):
    """Bessel function of the first kind J_nu(z), 128-term alternating series.

    Parity: ref math/mod.rs:102-145.
    """
    z = np.asarray(z, dtype=np.float64)
    scalar = z.ndim == 0
    z = np.atleast_1d(z)
    out = np.empty_like(z)

    zero = z == 0.0
    out[zero] = 1.0 if nu == 0.0 else 0.0

    rest = ~zero
    zr = z[rest]
    if zr.size:
        low = zr < 0.001 * np.sqrt(nu + 1.0)
        res = np.empty_like(zr)
        if low.any():
            res[low] = (0.5 * zr[low]) ** nu / gamma(nu + 1.0)
        hi = ~low
        if hi.any():
            zh = zr[hi]
            abs_nu = abs(nu)
            J = np.zeros_like(zh)
            ln_z = np.log(zh)
            ln2 = np.log(2.0)
            for i in range(_BESSEL_J_ITERATIONS):
                t0 = 2.0 * i + abs_nu
                term = np.exp(
                    t0 * ln_z - t0 * ln2 - lngamma(i + 1.0) - lngamma(abs_nu + i + 1.0)
                )
                J += term if i % 2 == 0 else -term
            res[hi] = J
        out[rest] = res
    return float(out[0]) if scalar else out


def csqrt(a: float) -> complex:
    """Complex square root of a *real* number.

    Parity: ref math/mod.rs:191-224 (csqrtf-style branch structure with b=0).
    """
    a = float(a)
    b = 0.0
    if a == 0.0:
        return complex(a, b)
    if np.isnan(a):
        return complex(a, np.nan)
    if np.isinf(a):
        if a < 0.0:
            return complex(0.0, np.copysign(a, b))
        return complex(a, np.copysign(0.0, b))
    if a >= 0.0:
        t = np.sqrt((a + np.hypot(a, b)) * 0.5)
        return complex(t, b / (2.0 * t))
    # Note: the reference (math/mod.rs:220) computes sqrt((a - hypot)/2) here,
    # which is sqrt of a negative number -> NaN for every a < 0.  That NaN
    # would poison Bairstow's complex-conjugate root pairs, so we use the
    # correct musl-csqrt branch sqrt((-a + hypot)/2); all reference doctest
    # values are unaffected (they only exercise real roots).
    t = np.sqrt((-a + np.hypot(a, b)) * 0.5)
    return complex(abs(b) / (2.0 * t), np.copysign(t, b))
