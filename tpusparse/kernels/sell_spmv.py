"""SELL SpMV/SpMM in plain XLA: the fast unstructured path.

Layout (formats/sell.py): A (M, N) -> windows t over M (128 each), column
groups j over N (128 each). ``vals[j, t, w, r]`` = w-th nonzero of output
column j*128+r within window t (zero-padded to W); ``idx[j, t, w, r]`` = its
in-window m-offset (int8, 0..127). Pad slots point at offset 0 with value 0.

The product is one gather-multiply-reduce: widen the int8 index, gather
``x[t*128 + idx]``, multiply by the stored value and sum over (t, w). No
matmul (hence no TF32 rounding) is involved. X is gathered in its
transposed (M, B) layout, so the B activations of one slot sit next to
each other and one stored value serves all of them.

On the GPU, XLA does not fuse the gather into this reduction, whose kept
axis (the 128 output lanes) is the minor one. At B=1 a loop fusion writes
the gathered products (4 bytes per slot) and a second kernel reduces
them; at B=8 the products are also transposed so that the reduced axes
become minor, and that transpose takes most of the time (PERF.md §5).
Making the reduction fuse is open work (ROADMAP, Speed 1).

Ancestry in the reference (cited for parity, not copied):
- per-row packing padded to a max nnz = WSP's ELL idea (wsp.cpp:23-39);
- converter-precomputed positions replacing in-kernel popcount ranking is
  SURVEY.md §3.3's prescribed translation of `__popc(word & prev_mask)`;
- slicing M into 128-row windows so indices fit 7 bits mirrors the
  warp-striped AWSP-Ref layout (awsp_ref.cpp:10-24).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_LANES = 128


def window_src(idx: jax.Array, windows: jax.Array) -> jax.Array:
    """Flat m index ``windows[t] * 128 + idx[..., t, w, r]`` of every slot;
    ``windows`` indexes axis -3 of ``idx``."""
    return (windows.astype(jnp.int32)[:, None, None] * _LANES
            + idx.astype(jnp.int32))


def gather_reduce(src: jax.Array, vals: jax.Array, x: jax.Array,
                  axes: tuple[int, ...]) -> jax.Array:
    """``sum over axes of vals * x[:, src]`` with the batch axis LAST:
    ``src``/``vals`` (..., 128) -> (remaining dims..., B), fp32."""
    xg = jnp.take(x.T, src, axis=0, mode="clip")          # (..., 128, B)
    return jnp.sum(vals.astype(jnp.float32)[..., None] * xg, axis=axes)


@jax.jit
def sell_spmm_padded(
    idx: jax.Array,      # (nb, nt, W, 128) int8
    vals: jax.Array,     # (nb, nt, W, 128)
    x: jax.Array,        # (B, M_padded)
    scales: jax.Array | None = None,   # (nb, 128) int8-storage dequant
) -> jax.Array:          # (B, N_padded)
    nb, nt = vals.shape[0], vals.shape[1]
    src = window_src(idx, jnp.arange(nt))
    y = gather_reduce(src, vals, x, axes=(1, 2))          # (nb, 128, B)
    if scales is not None:           # int8 storage: per-column dequant
        y = y * scales[:, :, None]
    return y.reshape(nb * _LANES, -1).T.astype(x.dtype)
