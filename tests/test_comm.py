"""Collective wrappers (parallel/comm.py) under shard_map on the CPU mesh."""

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from tpusparse.parallel import make_mesh
from jax import shard_map as compat_shard_map
from tpusparse.parallel.comm import (
    all_gather_x, psum_y, reduce_scatter_y, ring_shift)

_D = 4


def _mesh():
    return make_mesh({"n": _D}, jax.devices()[:_D])


def test_all_gather_x():
    mesh = _mesh()
    x = np.arange(_D * 8, dtype=np.float32)

    def f(x_loc):
        return all_gather_x(x_loc, "n")

    y = compat_shard_map(f, mesh=mesh, in_specs=P("n"), out_specs=P(None),
                  check_vma=False)(x)
    np.testing.assert_array_equal(np.asarray(y), x)


def test_reduce_scatter_y():
    mesh = _mesh()
    y_partial = np.tile(np.arange(_D * 8, dtype=np.float32), (_D, 1))

    def f(yp):
        return reduce_scatter_y(yp[0], "n")

    out = compat_shard_map(f, mesh=mesh, in_specs=P("n", None),
                    out_specs=P("n"))(y_partial)
    np.testing.assert_array_equal(np.asarray(out),
                                  _D * np.arange(_D * 8, dtype=np.float32))


def test_psum_y():
    mesh = _mesh()
    y = np.ones((_D, 8), np.float32)

    def f(yp):
        return psum_y(yp[0], "n")

    out = compat_shard_map(f, mesh=mesh, in_specs=P("n", None), out_specs=P(),
                    check_vma=False)(y)
    np.testing.assert_array_equal(np.asarray(out), np.full(8, _D, np.float32))


def test_ring_shift_full_cycle():
    mesh = _mesh()
    x = np.arange(_D * 4, dtype=np.float32)

    def f(x_loc):
        y = x_loc
        for _ in range(_D):              # D shifts = identity
            y = ring_shift(y, "n")
        return y

    y = compat_shard_map(f, mesh=mesh, in_specs=P("n"), out_specs=P("n"))(x)
    np.testing.assert_array_equal(np.asarray(y), x)


def test_ring_shift_once_moves_shard():
    mesh = _mesh()
    x = np.repeat(np.arange(_D, dtype=np.float32), 4)   # shard i holds i

    def f(x_loc):
        return ring_shift(x_loc, "n", shift=1)

    y = compat_shard_map(f, mesh=mesh, in_specs=P("n"), out_specs=P("n"))(x)
    got = np.asarray(y).reshape(_D, 4)[:, 0]
    np.testing.assert_array_equal(got, (np.arange(_D) - 1) % _D)
