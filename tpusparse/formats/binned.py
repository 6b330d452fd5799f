"""Binned SELL: sorted column groups with per-bucket padding widths.

The static row-binning scheduler SURVEY.md §7 prescribes as the
replacement for the reference's *adaptive* padding machinery:

- AWSP-Ref pads each warp stripe to a per-warp max and carries per-warp base
  offsets (awsp_ref.cpp:25-40) so short rows don't pay for long ones;
- WSP pays the global max for everyone (wsp.cpp:31) — catastrophic on skewed
  matrices.

Here: output columns are sorted by nnz (the SELL-sigma trick, sigma = whole
matrix), grouped into 128-column tiles, and each tile assigned to a bucket
whose SELL width is the smallest level covering its own max window nnz. One
SELL product per bucket (a handful of static shapes), then the output
permutation is undone with a single gather. On power-law matrices the
dense head pays W=128 while the long tail pays W=8.
"""

from __future__ import annotations

from typing import Any

import numpy as np

import jax
import jax.numpy as jnp

from tpusparse.formats.sell import sell_pack
from tpusparse.utils import round_up

_LANES = 128


def _pick_levels(group_w: np.ndarray, max_buckets: int = 3) -> list[int]:
    """Adaptive width levels (slots per 128-window) from the distribution of
    per-group demand. Few, large buckets on purpose: each bucket is its own
    product with its own launch, and per-call cost outweighs the padding a
    fine-grained ladder would save."""
    qs = (0.5, 0.85, 1.0)[-max_buckets:]
    levels = sorted({max(round_up(int(np.quantile(group_w, q)), 8), 8)
                     for q in qs})
    if levels[-1] < group_w.max():        # guarantee coverage
        levels[-1] = int(round_up(int(group_w.max()), 8))
    return levels


@jax.tree_util.register_pytree_node_class
class BinnedSellMatrix:
    def __init__(self, buckets: Any, inv_perm: Any, perm_plan: tuple, shape,
                 nnz: int, widths: tuple):
        self.buckets = buckets          # list of dicts with idx/vals leaves
        self.inv_perm = inv_perm        # (n,) int32 — undo column sort
        self.perm_plan = perm_plan      # (oidx, oh) for kernels/permute.py
        self.shape = shape
        self.nnz = nnz
        self.widths = widths            # static: bucket widths, parallel list

    def tree_flatten(self):
        leaves = ([(b["idx"], b["vals"]) for b in self.buckets],
                  self.inv_perm, self.perm_plan)
        return leaves, (self.shape, self.nnz, self.widths)

    @classmethod
    def tree_unflatten(cls, aux, children):
        pairs, inv_perm, perm_plan = children
        buckets = [dict(idx=i, vals=v) for i, v in pairs]
        return cls(buckets, inv_perm, perm_plan, *aux)

    @classmethod
    def _io_rebuild(cls, aux, leaves):
        """Rebuild from npz leaves (formats/io.py hook): 2 leaves per
        width bucket + inv_perm + the (oidx, oh) permute plan."""
        nb = len(aux[-1])                      # widths
        if len(leaves) != 2 * nb + 3:
            raise ValueError(f"{len(leaves)} leaves, expected {2 * nb + 3}")
        pairs = [(leaves[2 * i], leaves[2 * i + 1]) for i in range(nb)]
        return cls.tree_unflatten(
            aux, (pairs, leaves[2 * nb], (leaves[2 * nb + 1],
                                          leaves[2 * nb + 2])))

    def __repr__(self) -> str:
        return (f"BinnedSellMatrix(shape={self.shape}, nnz={self.nnz}, "
                f"widths={self.widths}, {self.device_bytes() / 1e6:.1f} MB)")

    @classmethod
    def from_dense(cls, a: np.ndarray) -> "BinnedSellMatrix":
        a = np.asarray(a)
        m, n = a.shape
        np_ = round_up(n, _LANES)
        if np_ != n:
            a = np.pad(a, ((0, 0), (0, np_ - n)))
        col_nnz = (a != 0).sum(axis=0)
        perm = np.argsort(-col_nnz, kind="stable").astype(np.int32)
        a_sorted = a[:, perm]

        nb = np_ // _LANES
        # width demand per column group = max nnz of any column within any
        # 128-row window of that group
        mp = round_up(m, _LANES)
        ap = np.pad(a_sorted, ((0, mp - m), (0, 0)))
        win = (ap.reshape(mp // _LANES, _LANES, np_) != 0).sum(axis=1)
        group_w = win.reshape(mp // _LANES, nb, _LANES).max(axis=(0, 2))

        lv = _pick_levels(group_w)
        need = np.array(lv).searchsorted(group_w, side="left")
        buckets, widths, order = [], [], []
        for li, level in enumerate(lv):
            groups = np.nonzero(need == li)[0]
            if groups.size == 0:
                continue
            cols = (groups[:, None] * _LANES +
                    np.arange(_LANES)[None, :]).ravel()
            packed = sell_pack(a_sorted[:, cols], w=int(level))
            buckets.append(dict(idx=packed["idx"], vals=packed["vals"]))
            widths.append(int(level))
            order.append(cols)

        order = np.concatenate(order) if order else np.arange(0)
        # y_concat is in (bucket, group) order over sorted columns; undo both
        final_perm = perm[order]                   # output col of y slot k
        inv_perm = np.empty(np_, dtype=np.int32)
        inv_perm[final_perm] = np.arange(np_, dtype=np.int32)
        nnz = int((a != 0).sum())
        from tpusparse.kernels.permute import permute_plan

        pp = permute_plan(inv_perm)
        return cls(buckets, inv_perm[:n], (pp["oidx"], pp["oh"]), (m, n),
                   nnz, tuple(widths))

    @classmethod
    def from_csr(cls, csr) -> "BinnedSellMatrix":
        """Pack from ``CsrMatrix`` without materializing dense A — the same
        sort/bucket/pack pipeline as ``from_dense``, with the column sort
        realized as a CSR row-subset gather (columns of A are this CSR's
        rows) and each bucket packed via ``sell_pack_csr``. O(nnz + packed
        slots) memory."""
        from tpusparse.formats.csr import col_window_widths, csr_rows_subset
        from tpusparse.formats.sell import sell_pack_csr

        m, n = csr.shape
        np_ = round_up(n, _LANES)
        col_nnz = np.zeros(np_, dtype=np.int64)
        col_nnz[:n] = csr.row_nnz
        perm = np.argsort(-col_nnz, kind="stable").astype(np.int32)

        col_w = np.zeros(np_, dtype=np.int64)
        col_w[:n] = col_window_widths(csr)
        nb = np_ // _LANES
        group_w = col_w[perm].reshape(nb, _LANES).max(axis=1)

        lv = _pick_levels(group_w)
        need = np.array(lv).searchsorted(group_w, side="left")
        buckets, widths, order = [], [], []
        for li, level in enumerate(lv):
            groups = np.nonzero(need == li)[0]
            if groups.size == 0:
                continue
            cols = (groups[:, None] * _LANES +
                    np.arange(_LANES)[None, :]).ravel()
            sub = csr_rows_subset(csr, perm[cols])
            packed = sell_pack_csr(sub, w=int(level))
            buckets.append(dict(idx=packed["idx"], vals=packed["vals"]))
            widths.append(int(level))
            order.append(cols)

        order = np.concatenate(order) if order else np.arange(0)
        final_perm = perm[order]
        inv_perm = np.empty(np_, dtype=np.int32)
        inv_perm[final_perm] = np.arange(np_, dtype=np.int32)
        from tpusparse.kernels.permute import permute_plan

        pp = permute_plan(inv_perm)
        return cls(buckets, inv_perm[:n], (pp["oidx"], pp["oh"]), (m, n),
                   int(csr.nnz), tuple(widths))

    def device_bytes(self) -> int:
        total = 0
        for b in self.buckets:
            vals = b["vals"]
            total += int(np.prod(vals.shape)) * (vals.dtype.itemsize + 1)
        return total

    def to_dense(self) -> np.ndarray:
        from tpusparse.formats.sell import SellMatrix

        m, n = self.shape
        cols = []
        for b, w in zip(self.buckets, self.widths):
            idx, vals = np.asarray(b["idx"]), np.asarray(b["vals"])
            nbk = vals.shape[0]
            s = SellMatrix(idx, vals, (m, nbk * _LANES),
                           (vals.shape[1] * _LANES, nbk * _LANES), w, 0)
            cols.append(s.to_dense())
        dense_sorted = np.concatenate(cols, axis=1) if cols else \
            np.zeros((m, 0), np.float32)
        return dense_sorted[:, np.asarray(self.inv_perm)]

    def _run(self, x2d: jax.Array) -> jax.Array:
        from tpusparse.kernels.sell_spmv import sell_spmm_padded

        parts = []
        for b in self.buckets:
            vals = b["vals"]
            mp = vals.shape[1] * _LANES
            xp = x2d
            if xp.shape[1] != mp:
                xp = jnp.pad(xp, ((0, 0), (0, mp - xp.shape[1])))
            parts.append(sell_spmm_padded(b["idx"], vals, xp))
        y_sorted = jnp.concatenate(parts, axis=1)      # (B, np_) sorted
        return jnp.take(y_sorted, jnp.asarray(self.inv_perm), axis=1)

    def spmv(self, x: Any) -> jax.Array:
        return self._run(jnp.asarray(x)[None, :])[0]

    def spmm(self, x: Any) -> jax.Array:
        return self._run(jnp.asarray(x))
