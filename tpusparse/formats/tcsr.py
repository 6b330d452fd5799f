"""TCSR: block-skip tiles with two-tier dense/SELL intra-block compression.

Parity target: the reference's TCSRMatrix (tcsr.cpp:5-62) — 32x32 blocks,
per-block bitmap, *compacted* values, block-CSR offsets — consumed by
csr_tiling.cu:24-113. BsrMatrix keeps the block skip but stores kept
tiles fully dense, so a 30%-full block streams 3.3x its nnz bytes. This
format closes that: every kept 128x128 tile
is stored in whichever of two tiers the cost model below prices lower:

- **SELL tier** (the compressed one): (W, 128) packed values + int8
  in-window offsets, bytes = 5*W*128 ∝ in-block nnz, consumed by
  kernels/bsell_spmv.py (in-window gather + reduction).
- **dense tier**: the plain BSR tile (65536 bytes, one matrix product) —
  cheaper once W is large, and much earlier for batched SpMM, where the
  SELL tier pays a gather per (slot, batch) element.

The per-tile choice is the byte/gather-cost argmin over candidate widths —
TCSR's "pay only in-block nnz" idea, with the reference's in-kernel
popcount ranking (csr_tiling.cu:74-89) moved to the converter exactly like
formats/sell.py. The block-CSR offset array (tcsr.cpp:13,34) becomes the
(bi, bj) coordinate plan.

The cost constants (gather byte-equivalents per slot-row, the tier-split
charge) were fitted on an earlier accelerator and keep their values until
they are measured again on this one.
"""

from __future__ import annotations

from typing import Any

import numpy as np

import jax
import jax.numpy as jnp

from tpusparse.utils import round_up

_LANES = 128
_SUB = 8

_SELL_BYTES_PER_W = 5 * _LANES             # fp32 vals + int8 idx per slot-row
_GATHER_BYTE_EQ_PER_W = 545                # gather cost, byte-equivalents
_DENSE_TILE_BYTES = _LANES * _LANES * 4
# Running BOTH tiers per call costs a fixed overhead over either single
# tier on the same bytes; charged as byte-equivalents, so a split must save
# at least that much before the model accepts it (a split that saves a few
# hundred KB is not worth a second product).
_TIER_SPLIT_BYTES = 12 << 20


def _tier_cutoff(w_b: np.ndarray, expect_batch: int,
                 tile_bj: np.ndarray | None = None,
                 nb: int | None = None) -> int:
    """Largest SELL-tier width W minimizing total modeled cost when all
    tiles with w_b <= W go SELL (at width W) and the rest go dense. 0 means
    every tile is cheaper dense.

    The cost is the EXACT stored-tile cost, including each tier's
    canonicalization overhead (zero tiles for output groups the tier misses
    — the scan kernels' first-visit-init invariant — plus long-list
    padding), so degenerate splits (a 1-tile tier paying nb-1 zero tiles)
    lose to folding, while real mixes still split."""
    if w_b.size == 0:
        return 0
    if tile_bj is None:
        tile_bj = np.zeros(w_b.size, dtype=np.int64)
        nb = 1
    per_w = max(_SELL_BYTES_PER_W, _GATHER_BYTE_EQ_PER_W * max(expect_batch, 1))

    def stored(sel: np.ndarray) -> int:
        k = int(sel.sum())
        if k == 0:
            return 0
        k += nb - np.unique(tile_bj[sel]).size       # missing-group zeros
        if k >= 64:
            k += -k % _SUB
        return k

    def total(cand: int) -> int:
        sel = w_b <= cand
        split = _TIER_SPLIT_BYTES if (stored(sel) and stored(~sel)) else 0
        return per_w * cand * stored(sel) + \
            _DENSE_TILE_BYTES * stored(~sel) + split

    best_w = 0
    best_cost = total(0)
    for cand in sorted({int(round_up(int(v), _SUB)) for v in w_b}):
        cost = total(cand)
        if cost < best_cost:
            best_w, best_cost = cand, cost
    return best_w


def _canonicalize_sell_tiles(s_bi, s_bj, idx, vals, nb: int, w: int):
    """Tile-list invariants (mirrors bsr._canonicalize_blocks): sorted by
    (bj, bi) — already true from np.unique — every output group present
    (zero tiles inserted), length padded to an alignment multiple (8, or
    64 for long lists) at the last group so bj stays non-decreasing."""
    missing = np.setdiff1d(np.arange(nb), s_bj)
    if missing.size:
        ins = np.searchsorted(s_bj, missing)
        s_bi = np.insert(s_bi, ins, 0)
        s_bj = np.insert(s_bj, ins, missing)
        zero = np.zeros((missing.size, w, _LANES), vals.dtype)
        idx = np.insert(idx, ins, np.zeros_like(zero, np.int8), axis=0)
        vals = np.insert(vals, ins, zero, axis=0)
    # relative padding stays <= 12.5%
    align = 64 if len(s_bj) >= 512 else _SUB
    pad = -len(s_bj) % align if len(s_bj) >= 64 else 0
    if pad:
        s_bi = np.concatenate([s_bi, np.zeros(pad, s_bi.dtype)])
        s_bj = np.concatenate([s_bj, np.full(pad, nb - 1, s_bj.dtype)])
        idx = np.concatenate(
            [idx, np.zeros((pad, w, _LANES), np.int8)])
        vals = np.concatenate(
            [vals, np.zeros((pad, w, _LANES), vals.dtype)])
    return s_bi.astype(np.int32), s_bj.astype(np.int32), idx, vals


def tcsr_pack_csr(csr, expect_batch: int = 1) -> dict[str, Any]:
    """Pack from ``CsrMatrix`` (O(nnz + kept-tile payload) memory).
    Duplicate positions are not supported in the SELL tier (they'd sum,
    like SellMatrix, but tier statistics would double-count) — feed
    deduplicated CSR (``CsrMatrix.from_scipy`` / ``from_dense`` are)."""
    from tpusparse.formats.bsr import BsrMatrix
    from tpusparse.formats.sell import _sorted_rows

    m, n = csr.shape
    mp, np_ = round_up(m, _LANES), round_up(n, _LANES)
    mb, nb = mp // _LANES, np_ // _LANES
    csr = _sorted_rows(csr)      # ranking below needs ascending m per column

    r = np.repeat(np.arange(n, dtype=np.int64), csr.row_nnz)
    mi = csr.col_idx.astype(np.int64)
    bi, bj = mi // _LANES, r // _LANES
    tkey = bj * mb + bi                       # (bj, bi)-sorted tile ids
    tiles, tinv = np.unique(tkey, return_inverse=True)

    # per-(column, window) counts -> per-tile width demand w_b
    if r.size:
        ckey = r * mb + bi
        uk, counts = np.unique(ckey, return_counts=True)
        w_b = np.zeros(tiles.size, dtype=np.int64)
        ck_tile = np.searchsorted(tiles, ((uk // mb) // _LANES) * mb + uk % mb)
        np.maximum.at(w_b, ck_tile, counts)
    else:
        w_b = np.zeros(0, dtype=np.int64)

    w_cut = _tier_cutoff(w_b, expect_batch, tiles // mb, nb)
    sell_tiles = np.nonzero(w_b <= w_cut)[0] if w_cut else np.zeros(0, np.int64)
    dense_tiles = np.setdiff1d(np.arange(tiles.size), sell_tiles)
    is_sell_entry = np.isin(tinv, sell_tiles)

    # ---- SELL tier ---------------------------------------------------
    w = max(w_cut, _SUB) if sell_tiles.size else _SUB
    ns = sell_tiles.size
    idx = np.zeros((ns, w, _LANES), dtype=np.int8)
    vals = np.zeros((ns, w, _LANES), dtype=csr.values.dtype)
    if ns:
        from tpusparse.formats.csr import segment_ranks

        # rank within each (column, window) run — entries sorted by (r, mi)
        rank, _, _ = segment_ranks(r, bi)

        slot_of_tile = np.full(tiles.size, -1, dtype=np.int64)
        slot_of_tile[sell_tiles] = np.arange(ns)
        e = is_sell_entry
        slot = slot_of_tile[tinv[e]]
        idx[slot, rank[e], r[e] % _LANES] = (mi[e] % _LANES).astype(np.int8)
        vals[slot, rank[e], r[e] % _LANES] = csr.values[e]
    s_bi = (tiles[sell_tiles] % mb).astype(np.int32)
    s_bj = (tiles[sell_tiles] // mb).astype(np.int32)
    if ns:          # an empty tier skips its kernel call entirely
        s_bi, s_bj, idx, vals = _canonicalize_sell_tiles(
            s_bi, s_bj, idx, vals, nb, w)

    # ---- dense tier ---------------------------------------------------
    bsr = None
    if dense_tiles.size:
        slot_of_tile = np.full(tiles.size, -1, dtype=np.int64)
        slot_of_tile[dense_tiles] = np.arange(dense_tiles.size)
        blocks = np.zeros((dense_tiles.size, _LANES, _LANES),
                          csr.values.dtype)
        e = ~is_sell_entry
        np.add.at(blocks, (slot_of_tile[tinv[e]], mi[e] % _LANES,
                           r[e] % _LANES), csr.values[e])
        bsr = BsrMatrix.from_blocks(
            m, n, tiles[dense_tiles] % mb, tiles[dense_tiles] // mb, blocks)

    return dict(s_bi=s_bi, s_bj=s_bj, idx=idx, vals=vals, w=w, bsr=bsr,
                shape=(m, n), padded=(mp, np_), nnz=int(csr.nnz),
                n_sell=int(ns), n_dense=int(dense_tiles.size))


@jax.tree_util.register_pytree_node_class
class TcsrMatrix:
    def __init__(self, s_bi, s_bj, idx, vals, w: int, bsr, shape, padded,
                 nnz: int, n_sell: int, n_dense: int):
        self.s_bi = s_bi
        self.s_bj = s_bj
        self.idx = idx
        self.vals = vals
        self.w = w
        self.bsr = bsr                 # BsrMatrix or None (dense tier)
        self.shape = shape
        self.padded = padded
        self.nnz = nnz
        self.n_sell = n_sell
        self.n_dense = n_dense

    def tree_flatten(self):
        return ((self.s_bi, self.s_bj, self.idx, self.vals, self.bsr),
                (self.w, self.shape, self.padded, self.nnz, self.n_sell,
                 self.n_dense))

    @classmethod
    def tree_unflatten(cls, aux, children):
        s_bi, s_bj, idx, vals, bsr = children
        w, shape, padded, nnz, n_sell, n_dense = aux
        return cls(s_bi, s_bj, idx, vals, w, bsr, shape, padded, nnz,
                   n_sell, n_dense)

    def _io_aux(self):
        """Static metadata for formats/io.py: own aux + the nested dense
        tier's aux (or None), so load() can rebuild the BsrMatrix child."""
        bsr_aux = None if self.bsr is None else \
            tuple(self.bsr.tree_flatten()[1])
        return (tuple(self.tree_flatten()[1]), bsr_aux)

    @classmethod
    def _io_rebuild(cls, aux, leaves):
        from tpusparse.formats.bsr import BsrMatrix

        own_aux, bsr_aux = aux
        expected = 4 if bsr_aux is None else 7
        if len(leaves) != expected:
            raise ValueError(f"{len(leaves)} leaves, expected {expected}")
        bsr = None if bsr_aux is None else BsrMatrix.tree_unflatten(
            tuple(bsr_aux), tuple(leaves[4:7]))
        return cls.tree_unflatten(tuple(own_aux), (*leaves[:4], bsr))

    def __repr__(self) -> str:
        return (f"TcsrMatrix(shape={self.shape}, nnz={self.nnz}, w={self.w}, "
                f"sell_tiles={self.n_sell}, dense_tiles={self.n_dense}, "
                f"{self.device_bytes() / 1e6:.1f} MB)")

    @classmethod
    def from_csr(cls, csr, expect_batch: int = 1) -> "TcsrMatrix":
        return cls(**tcsr_pack_csr(csr, expect_batch=expect_batch))

    @classmethod
    def from_dense(cls, a: np.ndarray,
                   expect_batch: int = 1) -> "TcsrMatrix":
        from tpusparse.formats.csr import CsrMatrix

        return cls.from_csr(CsrMatrix.from_dense(np.asarray(a)),
                            expect_batch=expect_batch)

    def device_bytes(self) -> int:
        vals = self.vals
        total = int(np.prod(vals.shape)) * (vals.dtype.itemsize + 1) + \
            (np.prod(self.s_bi.shape) + np.prod(self.s_bj.shape)) * 4
        if self.bsr is not None:
            total += self.bsr.device_bytes()
        return int(total)

    def to_dense(self) -> np.ndarray:
        mp, np_ = self.padded
        idx = np.asarray(self.idx)
        vals = np.asarray(self.vals)
        a = np.zeros((mp, np_), dtype=vals.dtype)
        kk, ww, rr = np.nonzero(vals)
        cc = idx[kk, ww, rr].astype(np.int64)
        s_bi = np.asarray(self.s_bi)
        s_bj = np.asarray(self.s_bj)
        a[s_bi[kk] * _LANES + cc, s_bj[kk] * _LANES + rr] = vals[kk, ww, rr]
        if self.bsr is not None:
            d = self.bsr.to_dense()
            a[:d.shape[0], :d.shape[1]] += d
        return a[:self.shape[0], :self.shape[1]]

    def _run(self, x2d: jax.Array) -> jax.Array:
        from tpusparse.kernels.bsell_spmv import bsell_spmm_padded
        from tpusparse.kernels.bsr_spmv import bsr_spmm_padded

        mp, np_ = self.padded
        b = x2d.shape[0]
        if x2d.shape[1] != mp:
            x2d = jnp.pad(x2d, ((0, 0), (0, mp - x2d.shape[1])))
        y = None
        if int(self.vals.shape[0]):
            y = bsell_spmm_padded(self.s_bi, self.s_bj, self.idx,
                                  self.vals, x2d, n_padded=np_)
        if self.bsr is not None:
            yd = bsr_spmm_padded(self.bsr.bi, self.bsr.bj, self.bsr.blocks,
                                 x2d, block_m=self.bsr.block_m,
                                 n_padded=np_)
            y = yd if y is None else y + yd
        if y is None:
            y = jnp.zeros((b, np_), x2d.dtype)
        return y[:, :self.shape[1]]

    def spmv(self, x: Any) -> jax.Array:
        return self._run(jnp.asarray(x)[None, :])[0]

    def spmm(self, x: Any) -> jax.Array:
        return self._run(jnp.asarray(x))
