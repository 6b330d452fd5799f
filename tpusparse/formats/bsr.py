"""BSR: block-sparse rows of dense tiles (see kernels/bsr_spmv.py).

The storage analog of the reference's TCSR (tcsr.cpp:5-62): TCSR kept a
32x32-block bitmap + compacted values + a block-CSR offset array; BSR keeps
(block_m x 128) *dense* tiles plus their (i, j) coordinates — a block is
either multiplied whole or skipped whole. The compressed per-tile tier is
TcsrMatrix's job (formats/tcsr.py).

Also the BSR *ingestion* path mandated by BASELINE.json ("COO/BSR
ingestion"): ``from_blocks`` accepts scipy-style block data directly.
"""

from __future__ import annotations

from typing import Any

import numpy as np

import jax
import jax.numpy as jnp

from tpusparse.utils import round_up

_LANES = 128


def bsr_pack(a: np.ndarray, block_m: int = 128) -> dict[str, Any]:
    a = np.asarray(a)
    m, n = a.shape
    mp, np_ = round_up(m, block_m), round_up(n, _LANES)
    if (mp, np_) != (m, n):
        a = np.pad(a, ((0, mp - m), (0, np_ - n)))
    mb, nb = mp // block_m, np_ // _LANES

    tiles = a.reshape(mb, block_m, nb, _LANES).transpose(0, 2, 1, 3)
    nz = tiles.any(axis=(2, 3))                       # (mb, nb)
    ii, jj = np.nonzero(nz)
    n_real = int(ii.size)
    ii, jj, blocks = _canonicalize_blocks(
        ii, jj, lambda order: tiles[ii[order], jj[order]], nb, block_m,
        tiles.dtype)

    return dict(bi=ii.astype(np.int32), bj=jj.astype(np.int32),
                blocks=np.ascontiguousarray(blocks), shape=(m, n),
                padded=(mp, np_), block_m=block_m,
                nnz=int((a != 0).sum()), n_real=n_real)


def bsr_pack_csr(csr, block_m: int = 128) -> dict[str, Any]:
    """Pack straight from ``CsrMatrix`` (CSR of A.T) — memory touched is
    O(nnz + kept blocks), never the (m, n) dense array. Duplicate positions
    sum, matching ``CsrMatrix.to_dense``."""
    m, n = csr.shape
    mp, np_ = round_up(m, block_m), round_up(n, _LANES)
    nb = np_ // _LANES

    r = np.repeat(np.arange(n, dtype=np.int64), csr.row_nnz)  # output col
    mi = csr.col_idx.astype(np.int64)
    key = (mi // block_m) * nb + (r // _LANES)
    uniq, inv = np.unique(key, return_inverse=True)
    blocks = np.zeros((uniq.size, block_m, _LANES), csr.values.dtype)
    np.add.at(blocks, (inv, mi % block_m, r % _LANES), csr.values)
    nnz = int((blocks != 0).sum())
    n_real = int(uniq.size)
    ii, jj, blocks = _canonicalize_blocks(
        (uniq // nb), uniq % nb, lambda order: blocks[order], nb, block_m,
        blocks.dtype)
    return dict(bi=ii.astype(np.int32), bj=jj.astype(np.int32),
                blocks=np.ascontiguousarray(blocks), shape=(m, n),
                padded=(mp, np_), block_m=block_m, nnz=nnz, n_real=n_real)


def _canonicalize_blocks(bi, bj, get_blocks, nb, block_m, dtype):
    """Establish the block-list invariants both kernels rely on:

    - sorted by (bj, bi): the product's ``segment_sum`` is told the
      output ids are sorted;
    - every output group has at least one block — empty groups get an
      explicit zero block;
    - long lists are padded with zero blocks at the LAST group (bj stays
      non-decreasing) to an alignment multiple — 8 from 64 blocks, 32
      from 512; short lists skip the padding.

    ``get_blocks(order) -> (nblk, TBm, 128)`` fetches the payload in the
    given (bj, bi)-sorted permutation of the input coordinate lists.
    """
    order = np.lexsort((bi, bj))
    blocks = get_blocks(order)
    bi, bj = bi[order], bj[order]
    missing = np.setdiff1d(np.arange(nb), bj)
    if missing.size:
        insert = np.searchsorted(bj, missing)
        bi = np.insert(bi, insert, 0)
        bj = np.insert(bj, insert, missing)
        blocks = np.insert(
            blocks, insert, np.zeros((block_m, _LANES), dtype), axis=0)
    align = 32 if len(bj) >= 512 else 8
    pad = -len(bj) % align if len(bj) >= 64 else 0
    if pad:
        bi = np.concatenate([bi, np.zeros(pad, bi.dtype)])
        bj = np.concatenate([bj, np.full(pad, nb - 1, bj.dtype)])
        blocks = np.concatenate(
            [blocks, np.zeros((pad,) + blocks.shape[1:], dtype)])
    return bi, bj, blocks


@jax.tree_util.register_pytree_node_class
class BsrMatrix:
    def __init__(self, bi: Any, bj: Any, blocks: Any, shape, padded,
                 block_m: int, nnz: int, n_real: int | None = None):
        self.bi = bi
        self.bj = bj
        self.blocks = blocks
        self.shape = shape
        self.padded = padded
        self.block_m = block_m
        self.nnz = nnz
        # stored blocks before zero padding; None (files saved before this
        # field existed) falls back to the padded count
        self.n_real = n_real if n_real is not None else int(blocks.shape[0])

    def tree_flatten(self):
        return ((self.bi, self.bj, self.blocks),
                (self.shape, self.padded, self.block_m, self.nnz,
                 self.n_real))

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, *aux)

    @classmethod
    def _io_rebuild(cls, aux, leaves):
        """Rebuild from npz leaves (formats/io.py hook)."""
        if len(leaves) != 3:
            raise ValueError(f"{len(leaves)} leaves, expected 3")
        return cls.tree_unflatten(aux, tuple(leaves))

    def __repr__(self) -> str:
        return (f"BsrMatrix(shape={self.shape}, nnz={self.nnz}, "
                f"block_m={self.block_m}, blocks={self.n_real}, "
                f"block_density={self.block_density:.2f}, "
                f"{self.device_bytes() / 1e6:.1f} MB)")

    @classmethod
    def from_dense(cls, a: np.ndarray, block_m: int = 128) -> "BsrMatrix":
        return cls(**bsr_pack(a, block_m=block_m))

    @classmethod
    def from_csr(cls, csr, block_m: int = 128) -> "BsrMatrix":
        """Pack from ``CsrMatrix`` without materializing dense A."""
        return cls(**bsr_pack_csr(csr, block_m=block_m))

    @classmethod
    def from_blocks(cls, m: int, n: int, bi: np.ndarray, bj: np.ndarray,
                    blocks: np.ndarray) -> "BsrMatrix":
        """scipy-BSR-style ingestion: block (bi[k], bj[k]) = blocks[k]."""
        bi = np.asarray(bi, dtype=np.int32)
        bj = np.asarray(bj, dtype=np.int32)
        blocks = np.asarray(blocks)
        nblk, block_m, bn = blocks.shape
        if bn != _LANES:
            raise ValueError(f"block width must be {_LANES}, got {bn}")
        mp, np_ = round_up(m, block_m), round_up(n, _LANES)
        nnz = int((blocks != 0).sum())
        n_real = int(bi.size)
        bi, bj, blocks = _canonicalize_blocks(
            bi, bj, lambda order: blocks[order],
            np_ // _LANES, block_m, blocks.dtype)
        return cls(bi=bi.astype(np.int32), bj=bj.astype(np.int32),
                   blocks=np.ascontiguousarray(blocks),
                   shape=(m, n), padded=(mp, np_), block_m=block_m,
                   nnz=nnz, n_real=n_real)

    def device_bytes(self) -> int:
        blocks = self.blocks
        return int(np.prod(blocks.shape)) * blocks.dtype.itemsize + \
            (np.prod(self.bi.shape) + np.prod(self.bj.shape)) * 4

    @property
    def block_density(self) -> float:
        """Fraction of (block_m x 128) tiles actually stored (pre-padding)."""
        mb = self.padded[0] // self.block_m
        nb = self.padded[1] // _LANES
        return self.n_real / (mb * nb)

    def to_dense(self) -> np.ndarray:
        bi = np.asarray(self.bi)
        bj = np.asarray(self.bj)
        blocks = np.asarray(self.blocks)
        mp, np_ = self.padded
        a = np.zeros((mp, np_), dtype=blocks.dtype)
        for k in range(blocks.shape[0]):
            r0, c0 = bi[k] * self.block_m, bj[k] * _LANES
            a[r0:r0 + self.block_m, c0:c0 + _LANES] += blocks[k]
        return a[:self.shape[0], :self.shape[1]]

    def _run(self, x2d: jax.Array) -> jax.Array:
        from tpusparse.kernels.bsr_spmv import bsr_spmm_padded

        mp, np_ = self.padded
        if x2d.shape[1] != mp:
            x2d = jnp.pad(x2d, ((0, 0), (0, mp - x2d.shape[1])))
        y = bsr_spmm_padded(self.bi, self.bj, self.blocks, x2d,
                            block_m=self.block_m, n_padded=np_)
        return y[:, :self.shape[1]]

    def spmv(self, x: Any) -> jax.Array:
        return self._run(jnp.asarray(x)[None, :])[0]

    def spmm(self, x: Any) -> jax.Array:
        return self._run(jnp.asarray(x))
