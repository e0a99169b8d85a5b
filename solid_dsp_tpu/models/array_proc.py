"""Array processing: beamforming, diversity combining, DoA estimation.

Multi-antenna capability absent from the reference (single-stream
library).  Everything here is dense linear algebra over an (N_antennas, T)
snapshot matrix — covariance outer products, eigendecompositions, steering
projections — i.e., exactly matmul-shaped work, and the antenna axis is a
natural shard axis for large arrays.

Conventions: narrowband model  x(t) = sum_s a(theta_s) s_s(t) + n(t) with
a(theta) the steering vector of a uniform linear array (ULA) of spacing
``d`` wavelengths: a_k = exp(+2 pi i k d sin(theta)).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["ula_steering", "spatial_covariance", "mrc_weights",
           "mvdr_weights", "beamform", "music_spectrum", "music_doa",
           "bartlett_spectrum", "esprit_doa", "root_music_doa"]


def ula_steering(n_antennas: int, theta, spacing: float = 0.5):
    """Steering vector(s) for a ULA; theta in radians from broadside.

    Returns (..., N) complex for scalar or vector theta.
    """
    k = np.arange(n_antennas)
    theta = jnp.asarray(theta)
    phase = 2j * np.pi * spacing * jnp.sin(theta)[..., None] * k
    return jnp.exp(phase.astype(jnp.complex64))


@jax.jit
def spatial_covariance(X: jnp.ndarray) -> jnp.ndarray:
    """R = X X^H / T for an (N, T) snapshot block — one matmul."""
    T = X.shape[-1]
    return (X @ jnp.conj(X).T) / T


@jax.jit
def mrc_weights(h: jnp.ndarray) -> jnp.ndarray:
    """Maximum-ratio combining for a known channel vector h: w = h/||h||²
    (matched filter over antennas; post-combining SNR = sum of branch SNRs).
    """
    return h / jnp.maximum(jnp.real(jnp.vdot(h, h)), 1e-30)


@jax.jit
def mvdr_weights(R: jnp.ndarray, a: jnp.ndarray,
                 loading: float = 1e-3) -> jnp.ndarray:
    """Minimum-variance distortionless response (Capon) beamformer:

        w = R⁻¹ a / (aᴴ R⁻¹ a)

    Unit gain toward ``a``, minimal output power from everything else
    (nulls interferers).  ``loading`` is diagonal loading relative to
    tr(R)/N for robustness at low snapshot counts.
    """
    n = R.shape[-1]
    Rl = R + (loading * jnp.trace(R).real / n) * jnp.eye(n, dtype=R.dtype)
    Ria = jnp.linalg.solve(Rl, a)
    return Ria / jnp.real(jnp.vdot(a, Ria))


@jax.jit
def beamform(X: jnp.ndarray, w: jnp.ndarray) -> jnp.ndarray:
    """y(t) = wᴴ x(t) over an (N, T) block."""
    return jnp.conj(w) @ X


@partial(jax.jit, static_argnames=("n_sources",))
def music_spectrum(R: jnp.ndarray, thetas: jnp.ndarray, n_sources: int,
                   spacing: float = 0.5) -> jnp.ndarray:
    """MUSIC pseudo-spectrum over candidate angles (radians).

    Eigendecompose R (Hermitian), take the noise subspace E_n (N - n_sources
    smallest eigenvectors), return 1 / ||E_nᴴ a(theta)||² — peaks at source
    directions.  The angle scan is one (A, N) @ (N, N-K) matmul.
    """
    n = R.shape[-1]
    _, vecs = jnp.linalg.eigh(R)             # ascending eigenvalues
    En = vecs[:, : n - n_sources]            # noise subspace
    A = ula_steering(n, thetas, spacing)     # (T, N)
    proj = A.conj() @ En                     # (T, N-K)
    denom = jnp.sum(jnp.real(proj * jnp.conj(proj)), axis=-1)
    return 1.0 / jnp.maximum(denom, 1e-30)


def music_doa(R, n_sources: int, spacing: float = 0.5,
              grid: int = 2048) -> np.ndarray:
    """Grid-scan MUSIC DoA estimates (radians), coarse-to-fine refinement.

    Host-side convenience wrapper: scans a dense angle grid, picks the
    ``n_sources`` strongest well-separated peaks, then refines each by a
    local parabolic fit (3-point) on the log-spectrum.
    """
    thetas = np.linspace(-np.pi / 2, np.pi / 2, grid, endpoint=True)
    spec = np.asarray(music_spectrum(R, jnp.asarray(thetas), n_sources,
                                     spacing))
    logp = np.log(spec)
    # local maxima, strongest first (non-peaks pushed to the end: masking
    # by multiplication would mis-rank when peak log-power is negative)
    ismax = np.r_[False, (logp[1:-1] > logp[:-2]) & (logp[1:-1] > logp[2:]),
                  False]
    cand = np.argsort(np.where(ismax, -logp, np.inf))
    picks = []
    for i in cand:
        if not ismax[i]:
            break
        if all(abs(i - j) > grid // 64 for j in picks):
            picks.append(int(i))
        if len(picks) == n_sources:
            break
    out = []
    dth = thetas[1] - thetas[0]
    for i in picks:
        if 0 < i < grid - 1:
            y0, y1, y2 = logp[i - 1], logp[i], logp[i + 1]
            delta = 0.5 * (y0 - y2) / (y0 - 2 * y1 + y2 + 1e-30)
            out.append(thetas[i] + np.clip(delta, -1, 1) * dth)
        else:
            out.append(thetas[i])
    return np.sort(np.asarray(out))


@jax.jit
def bartlett_spectrum(R: jnp.ndarray, thetas: jnp.ndarray,
                      spacing: float = 0.5) -> jnp.ndarray:
    """Conventional (delay-and-sum) spatial spectrum aᴴ R a / N²."""
    n = R.shape[-1]
    A = ula_steering(n, thetas, spacing)     # (T, N)
    return jnp.real(jnp.sum((A.conj() @ R) * A, axis=-1)) / (n * n)


@partial(jax.jit, static_argnames=("n_sources",))
def _signal_subspace(R: jnp.ndarray, n_sources: int) -> jnp.ndarray:
    """K strongest eigenvectors of Hermitian R — the device-side half of
    the gridless DoA estimators (the N x N eigh is the heavy part)."""
    _, vecs = jnp.linalg.eigh(R)             # ascending
    return vecs[:, R.shape[-1] - n_sources:]


def esprit_doa(R, n_sources: int, spacing: float = 0.5) -> np.ndarray:
    """TLS-ESPRIT DoA estimates (radians) — gridless, no angle scan.

    Exploits the ULA shift invariance: the signal subspaces of the
    first/last N-1 antennas differ by a rotation Psi whose eigenvalues
    are e^{2 pi i d sin(theta_k)}.  Total-least-squares solve via the
    eigendecomposition of [Es1 Es2]^H [Es1 Es2].  The N x N eigh runs
    on device; the K x K rotation eigenvalues (non-Hermitian — CPU-only
    in jax) are numpy host-side, matching music_doa's host-wrapper
    pattern.
    """
    Es = np.asarray(_signal_subspace(jnp.asarray(R), n_sources))
    n = Es.shape[0]
    if n_sources >= n:
        raise ValueError("need n_sources < n_antennas")
    E1, E2 = Es[:-1], Es[1:]
    C = np.concatenate([E1, E2], axis=1)     # (N-1, 2K)
    _, V = np.linalg.eigh(C.conj().T @ C)    # ascending
    Vn = V[:, :n_sources]                    # 2K x K smallest
    V12, V22 = Vn[:n_sources], Vn[n_sources:]
    psi = -V12 @ np.linalg.inv(V22)
    phases = np.angle(np.linalg.eigvals(psi))
    s = np.clip(phases / (2 * np.pi * spacing), -1.0, 1.0)
    return np.sort(np.arcsin(s))


def root_music_doa(R, n_sources: int, spacing: float = 0.5) -> np.ndarray:
    """Root-MUSIC DoA estimates (radians) — gridless MUSIC.

    The MUSIC null-spectrum along the unit circle is the polynomial
    p(z) = sum_l c_l z^l with c_l the sum of the l-th diagonal of
    E_n E_n^H; sources are the K roots nearest (and inside) the unit
    circle.  Device eigh + host np.roots on the tiny 2(N-1)-degree
    polynomial.
    """
    R = jnp.asarray(R)
    n = R.shape[-1]
    if n_sources >= n:
        raise ValueError("need n_sources < n_antennas")
    _, vecs = jnp.linalg.eigh(R)
    En = np.asarray(vecs[:, : n - n_sources])
    G = En @ En.conj().T                     # noise projector (N, N)
    # c[l] = sum of l-th diagonal, l = -(N-1) .. (N-1)
    coeffs = np.array([np.trace(G, offset=l) for l in range(n - 1, -n, -1)])
    roots = np.roots(coeffs)
    roots = roots[np.abs(roots) < 1.0]       # keep the inside partner
    # K roots closest to the unit circle
    keep = roots[np.argsort(1.0 - np.abs(roots))[:n_sources]]
    s = np.clip(np.angle(keep) / (2 * np.pi * spacing), -1.0, 1.0)
    return np.sort(np.arcsin(s))
