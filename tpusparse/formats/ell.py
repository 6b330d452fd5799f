"""ELL: per-output-column padded gather format (plain XLA path).

Equivalent of the reference's WSP value layout — each output column's
nonzeros packed then zero-padded to the global max column nnz
(wsp.cpp:23-39, ``nz_max_m``) — but with *explicit gather indices* instead of
a bitmap + popcount ranking (wsp.cu:37-39): SURVEY.md §3.3 calls this out as
the translation ("pre-computed gather indices baked by the converter").

This is the simple/portable kernel (the csr_naive.cu:13-22 scalar-gather
analog): one XLA gather + multiply + row-sum. It wins on small or
very sparse problems and is the correctness cross-check for the block
formats. Pad slots point at index 0 with value 0, so they contribute nothing.
"""

from __future__ import annotations

from typing import Any

import numpy as np

import jax
import jax.numpy as jnp

from tpusparse.utils import round_up


@jax.tree_util.register_pytree_node_class
class EllMatrix:
    """idx/val: (n, width); y[r] = sum_w val[r, w] * x[idx[r, w]]."""

    def __init__(self, idx: Any, val: Any, shape: tuple[int, int], nnz: int):
        self.idx = idx
        self.val = val
        self.shape = shape
        self.nnz = nnz

    def tree_flatten(self):
        return (self.idx, self.val), (self.shape, self.nnz)

    @classmethod
    def tree_unflatten(cls, aux, children):
        idx, val = children
        return cls(idx, val, *aux)

    @classmethod
    def from_dense(cls, a: np.ndarray, pad_to: int = 8) -> "EllMatrix":
        a = np.asarray(a)
        m, n = a.shape
        at = a.T
        mask = at != 0
        row_nnz = mask.sum(axis=1)
        width = max(round_up(int(row_nnz.max()), pad_to), pad_to)
        rank = np.cumsum(mask, axis=1) - mask
        idx = np.zeros((n, width), dtype=np.int32)
        val = np.zeros((n, width), dtype=a.dtype)
        rows, cols = np.nonzero(mask)
        idx[rows, rank[mask]] = cols.astype(np.int32)
        val[rows, rank[mask]] = at[rows, cols]
        return cls(idx=idx, val=val, shape=(m, n), nnz=int(row_nnz.sum()))

    def device_bytes(self) -> int:
        return self.idx.size * 4 + self.val.size * self.val.dtype.itemsize

    def to_dense(self) -> np.ndarray:
        m, n = self.shape
        at = np.zeros((n, m), dtype=np.asarray(self.val).dtype)
        idx = np.asarray(self.idx)
        val = np.asarray(self.val)
        np.add.at(at, (np.arange(n)[:, None], idx), val)  # pads add 0 at col 0
        return at.T

    def spmv(self, x: Any) -> jax.Array:
        return _ell_spmv(self.idx, self.val, jnp.asarray(x))

    def spmm(self, x: Any) -> jax.Array:
        return _ell_spmm(self.idx, self.val, jnp.asarray(x))


@jax.jit
def _ell_spmv(idx: jax.Array, val: jax.Array, x: jax.Array) -> jax.Array:
    gathered = jnp.take(x, idx, axis=0)           # (n, width)
    return jnp.sum(val * gathered, axis=1)


@jax.jit
def _ell_spmm(idx: jax.Array, val: jax.Array, x: jax.Array) -> jax.Array:
    gathered = jnp.take(x, idx, axis=1)           # (b, n, width)
    return jnp.sum(val[None] * gathered, axis=2)  # (b, n)
