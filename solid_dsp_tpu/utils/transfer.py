"""Host<->device transfer helpers used across the framework.

Thin wrappers over ``jnp.asarray`` / ``np.asarray`` / ``jax.device_put``
with one contract each, so init paths and stateful wrappers move data the
same way everywhere:

- ``put_array(x)`` / ``put_complex(x)`` — host data to the device, with
  the dtype rules of ``jnp.asarray`` (complex128 needs jax_enable_x64).
- ``fetch(x)`` / ``get_complex(x)`` — device data to a host ndarray.
- ``zeros_device`` / ``zeros_like_device`` / ``full_device`` — filled
  device arrays built from host numpy.
- ``astype_device(x, dtype)`` — dtype cast of a device array.
- ``ingest(x)`` — device arrays pass through; host data is transferred.
- ``put_tree(tree)`` — ``jax.device_put`` for a pytree built in numpy.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["put_complex", "get_complex", "fetch", "put_tree", "put_array",
           "zeros_device", "zeros_like_device", "full_device",
           "astype_device", "ingest"]


def put_complex(x, dtype=None):
    """Host complex ndarray -> device complex array.

    Raises when complex128 is requested while jax x64 is disabled: the
    value would otherwise land as complex64 without notice.
    """
    x = np.asarray(x)
    if dtype is None:
        dtype = (jnp.complex128 if (x.dtype == np.complex128
                                    and jax.config.jax_enable_x64)
                 else jnp.complex64)
    elif (np.dtype(dtype) == np.complex128
            and not jax.config.jax_enable_x64):
        raise ValueError(
            "put_complex(dtype=complex128) requires jax_enable_x64; "
            "with x64 disabled the value would land as complex64")
    return jnp.asarray(x.astype(np.dtype(dtype)))


def get_complex(x) -> np.ndarray:
    """Device complex array -> host complex ndarray."""
    return np.asarray(x)


def fetch(x) -> np.ndarray:
    """Device array -> host ndarray."""
    return np.asarray(x)


def put_array(x, dtype=None):
    """Host data -> device array (``dtype`` cast on the host first)."""
    x = np.asarray(x) if dtype is None else np.asarray(x, np.dtype(dtype))
    if np.iscomplexobj(x):
        return put_complex(x)
    return jnp.asarray(x)


def zeros_device(shape, dtype):
    """Zeros of ``shape``/``dtype`` on the device."""
    return put_array(np.zeros(shape, np.dtype(dtype)))


def zeros_like_device(x):
    """Zeros with ``x``'s shape and dtype on the device."""
    return zeros_device(x.shape, x.dtype)


def full_device(shape, value, dtype):
    """``value``-filled array of ``shape``/``dtype`` on the device."""
    return put_array(np.full(shape, value, np.dtype(dtype)))


def astype_device(x, dtype):
    """Cast a device array to ``dtype`` (no-op when it already matches)."""
    dtype = jnp.dtype(dtype)
    if x.dtype == dtype:
        return x
    return x.astype(dtype)


def ingest(x):
    """Input adoption for stateful wrappers: device arrays pass through;
    host data (lists, numpy) transfers via :func:`put_array`."""
    if isinstance(x, jax.Array):
        return x
    return put_array(x)


def put_tree(tree):
    """``jax.device_put`` for a pytree of host (numpy) leaves.

    Complex leaves follow :func:`put_complex`: complex128 stays
    complex128 under x64 and lands as complex64 otherwise, as with
    ``jax.device_put``.
    """
    def _put(leaf):
        leaf = np.asarray(leaf)
        if np.iscomplexobj(leaf):
            return put_complex(leaf)
        return jnp.asarray(leaf)

    return jax.tree_util.tree_map(_put, tree)
