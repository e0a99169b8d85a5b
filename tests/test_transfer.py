"""utils/transfer.py — host<->device transfer helpers.

These must be semantically identical to plain jnp.asarray / np.asarray;
these tests pin that (and 0-d scalar shape preservation).
"""

import jax
import jax.numpy as jnp
import numpy as np

from solid_dsp_tpu.utils.transfer import fetch, get_complex, put_complex, put_tree


def test_put_complex_roundtrip():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(257) + 1j * rng.standard_normal(257)).astype(
        np.complex64)
    d = put_complex(x)
    assert d.dtype == jnp.complex64
    assert d.shape == x.shape
    np.testing.assert_array_equal(get_complex(d), x)


def test_put_complex_scalar_keeps_shape():
    d = put_complex(np.complex64(1 + 2j))
    assert d.shape == ()
    assert complex(get_complex(d)) == 1 + 2j


def test_put_complex_c128():
    x = np.array([1 + 2j, -0.5j], np.complex128)
    d = put_complex(x, dtype=jnp.complex128)
    assert d.dtype == jnp.complex128
    np.testing.assert_array_equal(get_complex(d), x)


def test_fetch_dispatch():
    z = jnp.asarray([1 + 1j], jnp.complex64)
    r = jnp.asarray([2.0], jnp.float32)
    assert fetch(z).dtype.kind == "c"
    assert fetch(r).dtype == np.float32


def test_put_tree_matches_device_put():
    tree = {
        "theta": np.uint32(7),
        "tail": np.zeros((5,), np.complex64),
        "prev": np.ones((), np.complex64),
        "gain": np.float32(1.5),
        "flag": np.bool_(True),
    }
    out = put_tree(tree)
    ref = jax.device_put(tree)
    for k in tree:
        assert out[k].shape == ref[k].shape, k
        assert out[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(np.asarray(out[k]), np.asarray(ref[k]))
