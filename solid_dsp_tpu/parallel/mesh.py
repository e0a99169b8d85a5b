"""Device-mesh construction for DSP chains.

Axis conventions (SURVEY.md §2 "Parallelism & distributed-communication"):

``channel``
    Independent streams / channelizer outputs — the DP analog.  No
    communication crosses this axis except optional spectral reductions.
``time``
    Overlap-save time blocks of one stream — the SP/CP analog.  Neighbor
    devices exchange ``ntaps - 1`` halos via ``lax.ppermute``.

The mesh shape follows the algorithm, not the interconnect: the cards of
one host reach each other all to all, so any ``(channel, time)`` split of
them has the same link cost.  ``channel`` can span hosts because it never
communicates per-block; ``time`` exchanges halos every block.
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh

__all__ = ["make_mesh", "mesh_axes"]


def make_mesh(channel: int = 1, time: int = 1, devices=None) -> Mesh:
    """Build a ``(channel, time)`` mesh over ``channel * time`` devices.

    With ``devices=None`` uses ``jax.devices()`` (must have at least
    ``channel * time`` entries; extras are ignored).
    """
    if devices is None:
        devices = jax.devices()
    need = channel * time
    if len(devices) < need:
        raise ValueError(
            f"mesh ({channel} x {time}) needs {need} devices, "
            f"have {len(devices)}"
        )
    arr = np.asarray(devices[:need]).reshape(channel, time)
    return Mesh(arr, axis_names=("channel", "time"))


def mesh_axes(mesh: Mesh) -> tuple[str, ...]:
    return tuple(mesh.axis_names)
