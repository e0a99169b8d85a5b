"""Pilot-aided OFDM: comb pilots, LS channel estimation, CPE tracking.

802.11/DVB-style machinery on top of models.ofdm (the reference has no
modem layer at all; rounds out the roadmap's pilot item).  accelerator-first
formulations:

* pilot insertion/extraction uses static index sets (host-side numpy) —
  scatter/gather with compile-time indices lowers to cheap slices,
* LS-at-pilots -> all-carrier interpolation is ONE precomputed sparse
  interpolation matrix applied as a (T, P) @ (P, K) matmul,
  not a per-carrier interp loop,
* common-phase-error (residual CFO/phase-noise) tracking is a per-symbol
  pilot correlation — a batched reduction, no sequential scan.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "active_carrier_coords",
    "comb_pilot_indices",
    "pilot_values",
    "insert_pilots",
    "interp_matrix",
    "ls_channel_estimate",
    "common_phase_error",
    "equalize_mmse",
    "ofdm_pilot_receive",
]


def active_carrier_coords(nfft: int, n_active: int) -> np.ndarray:
    """Signed carrier frequencies aligned to models.ofdm's active vector.

    The active vector is ordered (+1..+half, -half..-1) — NOT monotone in
    frequency — so channel interpolation must happen in this coordinate
    space, never in vector-index space (a linear interp across the
    mid-vector +half -> -half wrap would bridge the two band edges).
    """
    from .ofdm import active_carrier_indices

    idx = active_carrier_indices(nfft, n_active).astype(np.int64)
    return np.where(idx <= nfft // 2, idx, idx - nfft)


def comb_pilot_indices(n_active: int, spacing: int, offset: int = 0,
                       coords: np.ndarray | None = None
                       ) -> tuple[np.ndarray, np.ndarray]:
    """(pilot_idx, data_idx) positions within the active-carrier vector.

    Comb pattern: every ``spacing``-th carrier in FREQUENCY order
    (``coords`` from active_carrier_coords; vector order if None),
    starting at ``offset``, with both band edges always pinned as pilots
    so interpolation never extrapolates.
    """
    if not 0 <= offset < spacing:
        raise ValueError("offset must be in [0, spacing)")
    if spacing < 2 or spacing >= n_active:
        raise ValueError("spacing must be in [2, n_active)")
    order = (np.argsort(np.asarray(coords)) if coords is not None
             else np.arange(n_active))
    sel = np.zeros(n_active, bool)
    sel[np.arange(offset, n_active, spacing)] = True
    sel[0] = sel[n_active - 1] = True
    pil = np.sort(order[sel])
    data = np.setdiff1d(np.arange(n_active), pil)
    return pil.astype(np.int32), data.astype(np.int32)


def pilot_values(n_pilots: int, seed: int = 11) -> np.ndarray:
    """Deterministic unit-modulus QPSK pilot sequence (known at both ends)."""
    rng = np.random.default_rng(seed)
    return np.exp(1j * 0.5 * np.pi * rng.integers(0, 4, n_pilots)
                  ).astype(np.complex64)


@partial(jax.jit, static_argnames=("n_active",))
def insert_pilots(data_syms, pilots, pilot_idx, data_idx, n_active: int):
    """Data (..., T, D) + pilots (P,) -> active-carrier grid (..., T, K)."""
    shape = (*data_syms.shape[:-1], n_active)
    X = jnp.zeros(shape, data_syms.dtype)
    X = X.at[..., data_idx].set(data_syms)
    return X.at[..., pilot_idx].set(jnp.broadcast_to(
        pilots, (*shape[:-1], pilots.shape[-1])))


def interp_matrix(pilot_idx: np.ndarray, n_active: int,
                  coords: np.ndarray | None = None) -> np.ndarray:
    """(n_active, P) linear-interpolation matrix W: H_full = H_pilots @ W.T.

    Interpolation runs along ``coords`` (signed frequencies from
    active_carrier_coords; vector index if None): each carrier between
    two bracketing pilots gets the two-point weights, rows at pilot
    positions are one-hot, and positions outside the pilot span clamp to
    the nearest pilot.  Host-side numpy — the product with per-symbol
    pilot estimates is the matmul.
    """
    pil = np.asarray(pilot_idx, np.int64)
    P = pil.size
    c = (np.asarray(coords, np.float64) if coords is not None
         else np.arange(n_active, dtype=np.float64))
    order = np.argsort(c[pil])
    pil_sorted = pil[order]
    pc = c[pil_sorted]
    W = np.zeros((n_active, P), np.float32)
    seg = np.clip(np.searchsorted(pc, c, side="right") - 1, 0, P - 2)
    lo, hi = pc[seg], pc[seg + 1]
    t = np.clip((c - lo) / np.maximum(hi - lo, 1e-12), 0.0, 1.0)
    W[np.arange(n_active), order[seg]] = 1.0 - t
    # += so a clamped edge (t==0 or 1 at a pilot) still sums to one-hot
    np.add.at(W, (np.arange(n_active), order[seg + 1]), t)
    return W


@jax.jit
def ls_channel_estimate(rx_grid, pilots, pilot_idx, W):
    """LS estimate at pilots -> linear interpolation to all carriers.

    rx_grid (..., T, K); returns H (..., T, K) complex.
    """
    Hp = rx_grid[..., pilot_idx] / pilots
    cdt = Hp.dtype
    return Hp @ W.T.astype(cdt)


@jax.jit
def common_phase_error(rx_grid, H, pilots, pilot_idx):
    """Per-symbol residual common phase from the pilots.

    Returns phase (..., T) radians: angle of sum_p conj(H_p * a_p) * y_p —
    the ML single-parameter phase estimate given the channel estimate.
    """
    y = rx_grid[..., pilot_idx]
    ref = H[..., pilot_idx] * pilots
    return jnp.angle(jnp.sum(y * jnp.conj(ref), axis=-1))


@jax.jit
def equalize_mmse(symbols, H, snr_linear):
    """One-tap MMSE: conj(H)/(|H|^2 + 1/snr) — falls back to ZF as snr->inf."""
    H2 = jnp.real(H * jnp.conj(H))
    return symbols * jnp.conj(H) / (H2 + 1.0 / snr_linear).astype(H.dtype)


def ofdm_pilot_receive(rx_grid, pilots, pilot_idx, data_idx, W,
                       snr_linear: float = 1e4, cpe_track: bool = True):
    """Full pilot-aided receive: LS+interp channel, optional CPE removal,
    MMSE equalization.  Returns (data_syms, H, cpe_phase)."""
    H = ls_channel_estimate(rx_grid, pilots, pilot_idx, W)
    if cpe_track:
        ph = common_phase_error(rx_grid, H, pilots, pilot_idx)
        rx_grid = rx_grid * jnp.exp(-1j * ph)[..., None].astype(rx_grid.dtype)
    else:
        ph = jnp.zeros(rx_grid.shape[:-1], jnp.float32)
    eq = equalize_mmse(rx_grid, H, snr_linear)
    return eq[..., data_idx], H, ph
