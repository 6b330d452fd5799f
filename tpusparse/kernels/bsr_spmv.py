"""BSR block-skip SpMV/SpMM in plain XLA.

Re-design of the reference's TCSR/csr_tiling path (csr_tiling.cu:24-113):
the reference stored a bitmap + compacted values per 32x32 block and
decompressed every block; here blocks are dense (block_m x 128) tiles and
empty blocks are never touched — traffic and FLOPs scale with the number of
stored blocks.

Each kept block multiplies its slice of X in one batched ``dot_general`` at
HIGHEST precision (fp32 operands would otherwise run in TF32), and the
per-block products are summed into their output groups with one
``segment_sum`` over the sorted ``bj`` list.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

_LANES = 128


@functools.partial(jax.jit, static_argnames=("block_m", "n_padded"))
def bsr_spmm_padded(
    bi: jax.Array,       # (nblk,) int32 — contraction block index
    bj: jax.Array,       # (nblk,) int32 — output block index, non-decreasing
    blocks: jax.Array,   # (nblk, TBm, 128)
    x: jax.Array,        # (B, M_padded)
    *,
    block_m: int,
    n_padded: int,
) -> jax.Array:          # (B, N_padded)
    b = x.shape[0]
    xs = jnp.take(x.reshape(b, -1, block_m), bi, axis=1, mode="clip")
    prod = jnp.einsum("bkm,kmn->kbn", xs, blocks,
                      preferred_element_type=jnp.float32,
                      precision=jax.lax.Precision.HIGHEST)  # (nblk, B, 128)
    y = jax.ops.segment_sum(prod, bj, num_segments=n_padded // _LANES,
                            indices_are_sorted=True)        # (nb, B, 128)
    return jnp.moveaxis(y, 1, 0).reshape(b, n_padded).astype(x.dtype)
