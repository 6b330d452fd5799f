"""Block-skip SELL tiles (the compressed tier of TCSR) in plain XLA.

Carrier of the reference's TCSR intra-block compaction (tcsr.cpp:13-34:
per-32x32-block bitmap + compacted values + block-CSR offsets). Each kept
tile is a (W x 128) SELL-packed slab — int8 in-window indices + values,
bytes ∝ in-block nnz — consumed with the SELL form (kernels/sell_spmv.py):
gather ``x[bi*128 + idx]``, multiply, reduce over W. The per-tile sums land
in their output groups with one ``segment_sum`` over the sorted ``bj`` list;
the block-CSR offset array of the reference becomes that (bi, bj) plan.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from tpusparse.kernels.sell_spmv import gather_reduce, window_src

_LANES = 128


@functools.partial(jax.jit, static_argnames=("n_padded",))
def bsell_spmm_padded(
    bi: jax.Array,       # (nblk,) int32 — contraction window index
    bj: jax.Array,       # (nblk,) int32 — output group index, non-decreasing
    idx: jax.Array,      # (nblk, W, 128) int8 in-window offsets
    vals: jax.Array,     # (nblk, W, 128)
    x: jax.Array,        # (B, M_padded)
    *,
    n_padded: int,
) -> jax.Array:          # (B, N_padded)
    part = gather_reduce(window_src(idx, bi), vals, x, axes=(1,))
    y = jax.ops.segment_sum(part, bj, num_segments=n_padded // _LANES,
                            indices_are_sorted=True)        # (nb, 128, B)
    return y.reshape(n_padded, -1).T.astype(x.dtype)
