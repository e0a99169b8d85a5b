"""Block framing / overlap-save bookkeeping.

The reference processes one sample at a time through a shift-register Window
(window/mod.rs:63-71).  The block equivalent frames a stream into fixed-size
blocks, prepends the carried tail (the last ``ntaps - 1`` inputs), and runs
one batched kernel per block.  These helpers hold that bookkeeping in one
place so FIR / resamplers / channelizer all share it.
"""

from __future__ import annotations

import jax.numpy as jnp

__all__ = ["extend_with_tail", "split_tail", "frame_windows"]


def extend_with_tail(tail: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
    """Prepend carried history to a block: [tail | x] along the last axis."""
    return jnp.concatenate([tail, x], axis=-1)


def split_tail(x_ext: jnp.ndarray, tail_len: int) -> jnp.ndarray:
    """New tail = last ``tail_len`` samples of the extended block."""
    if tail_len == 0:
        return x_ext[..., :0]
    return x_ext[..., -tail_len:]


def frame_windows(x_ext: jnp.ndarray, length: int, stride: int = 1) -> jnp.ndarray:
    """im2col framing: windows[t, i] = x_ext[..., t*stride + i].

    Returns shape (..., T, length) with T = (n - length) // stride + 1.
    XLA lowers the gather to efficient strided loads; the result feeds an
    matmul against a tap matrix.
    """
    n = x_ext.shape[-1]
    T = (n - length) // stride + 1
    idx = jnp.arange(T)[:, None] * stride + jnp.arange(length)[None, :]
    return x_ext[..., idx]
