"""Window — fixed-capacity shift register (newest sample at index 0).

Parity: reference ``src/window/mod.rs`` (struct :8-14, push :63-71,
to_vec :44-51, reset :54-56) — the live streaming-state container behind
FIR/IIR/PFB/AutoCorrelator in the reference.  Here the jitted
paths carry state as pytree tails instead (streaming.state); this class
exists for API parity and host-side use.

Exact reference semantics, including the quirks:

* the buffer has ``capacity + delay`` slots but ``push`` shifts only the
  first ``capacity`` (mod.rs:64-71 copies ``capacity - 1`` slots), so the
  trailing ``delay`` slots are NEVER written — they stay zero forever;
* ``to_vec`` (and ``as_ptr``) read ``capacity`` slots starting at offset
  ``delay`` (mod.rs:44-51) — i.e. the *delayed* view, whose last
  ``min(delay, capacity)`` entries are the permanent zeros above.

The AutoCorrelator's delayed-window reads (auto_correlator/mod.rs:26-35)
rely on exactly this behavior.
"""

from __future__ import annotations

import numpy as np

__all__ = ["Window"]


class Window:
    """Newest-first shift register with reference-parity delay semantics."""

    def __init__(self, capacity: int, delay: int = 0, dtype=np.complex128):
        if capacity < 1:
            raise ValueError("window capacity must be >= 1")
        if delay < 0:
            raise ValueError("delay must be >= 0")
        self._capacity = int(capacity)
        self._delay = int(delay)
        self._buf = np.zeros(self._capacity + self._delay, dtype=dtype)

    def capacity(self) -> int:
        return self._capacity

    def __len__(self) -> int:
        return self._capacity

    @property
    def delay(self) -> int:
        return self._delay

    def push(self, value) -> None:
        """Shift the first ``capacity`` slots one older; newest at index 0.

        Ref mod.rs:63-71: the delay region (indices >= capacity) is never
        touched.
        """
        self._buf[1: self._capacity] = self._buf[: self._capacity - 1]
        self._buf[0] = value

    def write(self, values) -> None:
        """Push a block, oldest first (ref mod.rs:73-77)."""
        for v in np.asarray(values):
            self.push(v)

    def __getitem__(self, i: int):
        """Raw buffer read: w[i] = the i-th most recent sample (0 = newest);
        indices >= capacity are the permanently-zero delay slots."""
        return self._buf[i]

    def to_vec(self) -> np.ndarray:
        """Copy of capacity slots at offset ``delay`` — the DELAYED view
        (ref to_vec :44-51).  Its last min(delay, capacity) entries are 0."""
        return self._buf[self._delay: self._delay + self._capacity].copy()

    def reset(self) -> None:
        self._buf[:] = 0

    def __repr__(self) -> str:
        return (f"Window<{self._buf.dtype}> [Capacity={self._capacity}] "
                f"[Delay={self._delay}]")
