"""Direction-finding example: two emitters impinge on an 8-element ULA;
estimate bearings with MUSIC, then extract one emitter with an MVDR
beamformer while nulling the other.

    python examples/direction_finder.py
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

if not _os.environ.get("SOLID_DSP_EXAMPLES_ACCEL"):
    import jax as _jax

    _jax.config.update("jax_platforms", "cpu")


import jax.numpy as jnp
import numpy as np

from solid_dsp_tpu.models.array_proc import (
    beamform, esprit_doa, music_doa, mvdr_weights, root_music_doa,
    spatial_covariance, ula_steering)


def main() -> None:
    rng = np.random.default_rng(0)
    n_ant, T = 8, 8192
    bearings = [-12.0, 27.0]          # degrees from broadside
    powers = [1.0, 4.0]
    noise_pow = 0.1

    k = np.arange(n_ant)[:, None]
    X = np.zeros((n_ant, T), np.complex128)
    sigs = []
    for th, p in zip(bearings, powers):
        a = np.exp(2j * np.pi * 0.5 * np.sin(np.deg2rad(th)) * k)
        s = np.sqrt(p / 2) * (rng.standard_normal(T)
                              + 1j * rng.standard_normal(T))
        sigs.append(s)
        X += a * s[None, :]
    X += np.sqrt(noise_pow / 2) * (rng.standard_normal((n_ant, T))
                                   + 1j * rng.standard_normal((n_ant, T)))
    X = X.astype(np.complex64)

    R = spatial_covariance(jnp.asarray(X))
    doa = np.rad2deg(music_doa(R, n_sources=2))
    print(f"true bearings: {bearings} deg")
    print(f"MUSIC estimates: {np.round(doa, 2).tolist()} deg")
    assert np.allclose(np.sort(doa), np.sort(bearings), atol=0.5)
    doa_e = np.rad2deg(esprit_doa(R, 2))
    doa_r = np.rad2deg(root_music_doa(R, 2))
    print(f"ESPRIT (gridless): {np.round(doa_e, 2).tolist()} deg")
    print(f"root-MUSIC       : {np.round(doa_r, 2).tolist()} deg")
    assert np.allclose(np.sort(doa_e), np.sort(bearings), atol=0.5)
    assert np.allclose(np.sort(doa_r), np.sort(bearings), atol=0.5)

    # steer at the weak emitter, null the strong one
    a1 = ula_steering(n_ant, np.deg2rad(bearings[0]))
    w = mvdr_weights(R, a1)
    y = np.asarray(beamform(jnp.asarray(X), w))
    s1 = sigs[0]
    g = np.vdot(s1, y) / np.vdot(s1, s1)
    err = y - g * s1
    sinr = float(np.abs(g) ** 2 * np.vdot(s1, s1).real
                 / np.vdot(err, err).real)
    in_sinr = powers[0] / (powers[1] + noise_pow)
    print(f"MVDR toward {bearings[0]} deg: output SINR "
          f"{10 * np.log10(sinr):.1f} dB (input {10 * np.log10(in_sinr):.1f} dB)")
    assert 10 * np.log10(sinr) > 10.0
    print("direction finder OK")


if __name__ == "__main__":
    main()
