"""Ragged SELL as a stream of 8-slot chunks, in plain XLA.

SELL (kernels/sell_spmv.py) pays one GLOBAL width W for every (window,
column-group) tile; binned SELL recovers some of that with 2-3 bucket
widths. RSELL removes the shape constraint: the converter emits, per kept
tile, ceil(tile_demand / 8) chunks of (8 slots x 128 lanes), each tagged
with its output group ``cj`` and contraction window ``ct``. Consequences:

- per-TILE padding only (to 8 slots): strictly fewer bytes than SELL's
  global W or binned's bucket widths on skewed matrices;
- all-zero tiles emit no chunks at all (block skip for free);
- chunk counts are DATA, not shapes: shards of different raggedness run one
  uniform program — per-shard loads are balanced by assignment and padded
  with zero chunks (idx=0, val=0 gathers add 0.0).

The product gathers ``x[ct*128 + idx]`` per slot, sums each chunk's 8 slots
and adds the chunk sums into their output groups with one ``segment_sum``
by ``cj`` (pad chunks point at group 0 with zero values, so the list is not
sorted).

Ancestry: per-warp ragged padding + per-warp base offsets of the
reference's AWSPRefMatrix (awsp_ref.cpp:25-40) — the chunk stream is the
chip-level generalization where every tile gets its own "warp max".
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from tpusparse.kernels.sell_spmv import gather_reduce, window_src

_LANES = 128


@functools.partial(jax.jit, static_argnames=("n_padded",))
def rsell_spmm_padded(
    cj: jax.Array,       # (nchunk,) int32 — output group per chunk
    ct: jax.Array,       # (nchunk,) int32 — contraction window per chunk
    idx: jax.Array,      # (nchunk, 8, 128) int8 in-window offsets
    vals: jax.Array,     # (nchunk, 8, 128)
    x: jax.Array,        # (B, M_padded)
    *,
    n_padded: int,
) -> jax.Array:          # (B, N_padded)
    part = gather_reduce(window_src(idx, ct), vals, x, axes=(1,))
    y = jax.ops.segment_sum(part, cj, num_segments=n_padded // _LANES)
    return y.reshape(n_padded, -1).T.astype(x.dtype)
