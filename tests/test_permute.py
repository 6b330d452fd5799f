"""Static column permutation (kernels/permute.py)."""

import numpy as np
import pytest

import jax.numpy as jnp

from tpusparse.kernels.permute import apply_permutation, permute_plan


@pytest.mark.parametrize("n,b", [(4096, 1), (640, 1), (512, 3), (384, 2),
                                 (129, 1)])
def test_matches_numpy_take(n, b):
    rng = np.random.default_rng(n + b)
    perm_src = rng.permutation(n)
    p = permute_plan(perm_src)
    y = rng.uniform(-1, 1, (b, p["np_"])).astype(np.float32)
    out = np.asarray(apply_permutation(
        jnp.asarray(y), (jnp.asarray(p["oidx"]), jnp.asarray(p["oh"])), n))
    np.testing.assert_array_equal(out, y[:, perm_src])


def test_identity_permutation():
    p = permute_plan(np.arange(256))
    y = np.arange(256, dtype=np.float32)[None, :]
    out = np.asarray(apply_permutation(
        jnp.asarray(y), (jnp.asarray(p["oidx"]), jnp.asarray(p["oh"])), 256))
    np.testing.assert_array_equal(out, y)
