"""Thin collective wrappers so kernels stay topology-agnostic.

SURVEY.md §5 "distributed communication backend": the reference has no comm
layer at all (only cudaMemcpy, e.g. csr_naive.cu:49-52); here it is XLA
collectives (NCCL on the GPU). These wrappers are used inside
``shard_map``-ped functions.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax


def all_gather_x(x: jax.Array, axis: str) -> jax.Array:
    """Gather X shards along a mesh axis into the full vector (halo fill)."""
    return lax.all_gather(x, axis, axis=0, tiled=True)


def reduce_scatter_y(y_partial: jax.Array, axis: str) -> jax.Array:
    """Sum partial Y's across the axis, leaving each device its own slice."""
    return lax.psum_scatter(y_partial, axis, scatter_dimension=0, tiled=True)


def psum_y(y_partial: jax.Array, axis: str) -> jax.Array:
    return lax.psum(y_partial, axis)


def ring_shift(x: jax.Array, axis: str, shift: int = 1) -> jax.Array:
    """Pass a buffer one step around the ring (double-buffered halo walk)."""
    n = lax.axis_size(axis)
    perm = [(i, (i + shift) % n) for i in range(n)]
    return lax.ppermute(x, axis, perm)
