"""Partitioned multi-chip SpMV/SpMM over a device mesh.

Row-partition the matrix across chips, exchange dense-vector segments
between them, overlap with local compute. Three strategies
(all dense-A v1; sparse formats plug in via the same local-kernel hook):

- ``n``    — shard the output dim: each chip owns an A column-slab and its Y
  slice; X replicated. No inter-chip traffic in steady state.
- ``m``    — shard the contraction dim: each chip owns an A row-slab and its
  X shard; partial Y's summed with ``psum``. The chip-level lift of
  the reference's split-M-across-warps + smem-reduce pattern (asp.cu:13-40).
- ``ring`` — shard both: X shards rotate around the ring via ``ppermute``
  while each chip consumes the matching row-slab of its local column-slab —
  halo exchange overlapped with compute (the ring-attention analog,
  SURVEY.md §5). Peak memory per chip: A/D + X/D, vs ``n``'s A/D + X.
"""

from __future__ import annotations

import enum
import functools
from typing import Any

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from jax import shard_map as _shard_map

from tpusparse.parallel import comm
from tpusparse.parallel.mesh import default_mesh


class Partition(str, enum.Enum):
    N = "n"
    M = "m"
    RING = "ring"


def _local_matvec(a_loc: jax.Array, x: jax.Array) -> jax.Array:
    # local kernel hook — dense for now; formats swap in their spmv here
    return jnp.dot(x, a_loc, preferred_element_type=jnp.float32,
                   precision=jax.lax.Precision.HIGHEST).astype(a_loc.dtype)


def _n_shard(mesh: Mesh, a, x):
    def f(a_loc, x_full):
        return _local_matvec(a_loc, x_full)

    return _shard_map(f, mesh=mesh, in_specs=(P(None, "n"), P()),
                      out_specs=P("n"))(a, x)


def _m_shard(mesh: Mesh, a, x):
    def f(a_loc, x_loc):
        return comm.psum_y(_local_matvec(a_loc, x_loc), "n")

    # note: the mesh axis is named "n" but here it carries M-shards
    return _shard_map(f, mesh=mesh, in_specs=(P("n", None), P("n")),
                      out_specs=P())(a, x)


def _ring(mesh: Mesh, a, x):
    d = mesh.shape["n"]

    def f(a_loc, x_loc):
        # a_loc: (M, N/D) column slab; x_loc: (M/D,) — chunk my_idx of X.
        my = lax.axis_index("n")
        chunk = x_loc.shape[0]

        def consume(s, xc):
            # xc is X chunk ((my + s) % D) — consume the matching row band
            row0 = ((my + s) % d) * chunk
            a_band = lax.dynamic_slice_in_dim(a_loc, row0, chunk, axis=0)
            return _local_matvec(a_band, xc)

        def step(s, carry):
            y, xc = carry
            # pass the chunk to the left neighbor; receive the next band's
            return (y + consume(s, xc), comm.ring_shift(xc, "n", shift=-1))

        y0 = jnp.zeros((a_loc.shape[1],), a_loc.dtype)
        # the carry becomes device-varying after the first ppermute; mark the
        # zero init as varying over the axis so scan carry types line up
        y0 = lax.pcast(y0, "n", to="varying")
        # D-1 sends only: the last band is consumed without the ring shift
        # whose result nobody would read (bench/commmodel.py counts exactly
        # (D-1) chunk transfers per chip)
        y, xc = lax.fori_loop(0, d - 1, step, (y0, x_loc))
        return y + consume(d - 1, xc)

    return _shard_map(f, mesh=mesh, in_specs=(P(None, "n"), P("n")),
                      out_specs=P("n"))(a, x)


@functools.partial(jax.jit, static_argnames=("mesh", "partition"))
def _spmv_sharded_jit(a, x, mesh: Mesh, partition: str):
    if partition == Partition.N:
        return _n_shard(mesh, a, x)
    if partition == Partition.M:
        return _m_shard(mesh, a, x)
    if partition == Partition.RING:
        return _ring(mesh, a, x)
    raise ValueError(f"unknown partition {partition!r}")


def spmv_sharded(a: Any, x: Any, mesh: Mesh | None = None,
                 partition: str | Partition = Partition.N) -> jax.Array:
    """Multi-chip y = x @ a for dense ``a``.

    Sparse formats have their own sharded entry points with the same
    partition names: ``parallel.sparse.sell_spmm_sharded`` (n/m/ring/2d),
    ``awsp_spmm_sharded``, ``bsr_spmm_sharded``.
    """
    mesh = mesh or default_mesh()
    partition = Partition(partition)
    a = jnp.asarray(a)
    x = jnp.asarray(x)
    d = mesh.shape["n"]
    n_orig = a.shape[1]
    # non-divisible dims are zero-padded automatically (padded rows multiply
    # zero X entries; padded output columns are sliced off below)
    if partition in (Partition.M, Partition.RING) and a.shape[0] % d:
        pad = -a.shape[0] % d
        a = jnp.pad(a, ((0, pad), (0, 0)))
        x = jnp.pad(x, (0, pad))
    if partition in (Partition.N, Partition.RING) and a.shape[1] % d:
        a = jnp.pad(a, ((0, 0), (0, -a.shape[1] % d)))
    y = _spmv_sharded_jit(a, x, mesh, partition)
    return y[:n_orig] if y.shape[0] != n_orig else y
