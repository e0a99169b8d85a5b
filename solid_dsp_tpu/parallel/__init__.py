"""Multi-chip execution: meshes, halo exchange, sharded chains.

The reference (juliantos/solid-dsp) is entirely single-threaded
sample-at-a-time Rust (SURVEY.md §2 "Parallelism" — no threads, no SIMD, no
collectives anywhere under src/).  This package supplies the scale-out story
across accelerator cards instead:

* ``mesh``     — device meshes with ``('channel', 'time')`` axes: channels are
  the data-parallel axis (independent streams), time is the sequence-parallel
  axis (overlap-save blocks with halo exchange).
* ``halo``     — ``lax.ppermute`` neighbor exchange of filter tails — the
  structural analog of ring-attention halo passing.
* ``sharded``  — ``shard_map``-ed FIR / rx-chain / channelizer where the
  carried ``ChainState`` doubles as the inter-device halo payload.
"""

from .mesh import make_mesh, mesh_axes  # noqa: F401
from .halo import (  # noqa: F401
    left_halo,
    right_halo,
    from_last_shard,
    time_offset,
)
from .sharded import (  # noqa: F401
    sharded_fir,
    make_sharded_rx_chain,
    make_sharded_channelizer,
)
