"""RSELL: ragged SELL — per-tile widths via a flat chunk stream.

Format host side for kernels/rsell_spmv.py (see its docstring for the
design). Each kept (window, column-group) tile stores ceil(demand/8) chunks
of (8 slots x 128 lanes); bytes track each tile's OWN max column nnz instead
of SELL's global W (wsp.cpp:31's global max, the reference's known weakness)
or binned's bucket ladder. All-zero tiles store nothing.

``rsell_shard_pack`` is the ragged SHARDING story:
output groups are assigned to shards either balancing per-shard chunk loads
(default) or contiguously after a demand sort (the chip-level analog of
AWSP-Ref's per-warp max padding, awsp_ref.cpp:25-40 — each shard gets its
own effective width); shard chunk lists are padded with zero chunks to one
uniform length, so ANY group count / device count combination runs — no
divisibility requirements.
"""

from __future__ import annotations

from typing import Any

import numpy as np

import jax
import jax.numpy as jnp

from tpusparse.utils import round_up

_LANES = 128
_SUB = 8


def rsell_pack_csr(csr, sort: bool | str = "auto",
                   use_native: bool | None = None) -> dict[str, Any]:
    """CsrMatrix -> flat chunk stream. O(nnz + chunk payload) memory.
    Returns per-tile demands too (the shard packer reuses them).

    ``sort``: order columns by nnz first (the SELL-sigma trick). A tile is
    128 columns wide, so ONE heavy column drags its whole tile's width up;
    clustering heavy columns makes per-tile widths track the local demand
    (measured: powerlaw d=0.15 packs 4.4x smaller sorted). ``auto`` sorts
    exactly when the router's skew test fires (w_global >= 1.5 x typical) —
    block/banded structure packs tighter unsorted (sorting would scatter
    block columns across tiles). Sorted packs carry the inverse column
    permutation for the output unpermute."""
    from tpusparse.formats.csr import col_window_widths, csr_rows_subset
    from tpusparse.formats.sell import _sorted_rows

    m, n_orig = csr.shape
    mp = round_up(m, _LANES)
    np_ = round_up(n_orig, _LANES)
    if sort == "auto":
        cw = col_window_widths(csr)
        med = float(np.median(cw)) if cw.size else 0.0
        sort = med > 0 and int(cw.max()) >= 1.5 * med
    inv_perm = None
    perm_plan = None
    if sort:
        col_nnz = np.zeros(np_, dtype=np.int64)
        col_nnz[:n_orig] = csr.row_nnz
        perm = np.argsort(-col_nnz, kind="stable").astype(np.int32)
        csr = csr_rows_subset(csr, perm)          # (m, np_), sorted columns
        inv_perm = np.empty(np_, dtype=np.int32)
        inv_perm[perm] = np.arange(np_, dtype=np.int32)
        from tpusparse.kernels.permute import permute_plan

        pp = permute_plan(inv_perm)
        perm_plan = (pp["oidx"], pp["oh"])

    n = csr.shape[1]
    nt, nb = mp // _LANES, np_ // _LANES
    csr = _sorted_rows(csr)

    from tpusparse import native

    if use_native is not False and csr.nnz and \
            csr.values.dtype == np.float32 and native.available():
        # C++ fast path (ctypes, OpenMP): demand pass + chunk fill,
        # bit-identical to the numpy path below (asserted in tests)
        demand = native.rsell_demand_csr(csr.row_ptr, csr.col_idx, n, nt)
        flat = demand.ravel()
        tiles = np.flatnonzero(flat).astype(np.int64)
        w_jt = flat[tiles].astype(np.int64)
        tile_chunks = -(-w_jt // _SUB)
        tile_base = np.concatenate([[0], np.cumsum(tile_chunks)])
        nchunk = int(tile_base[-1])
        base_grid = np.zeros(flat.size, np.int64)
        base_grid[tiles] = tile_base[:-1]
        vals, idx = native.rsell_fill_csr(
            csr.row_ptr, csr.col_idx, csr.values, n, nt, base_grid, nchunk)
        cj = (tiles // nt).astype(np.int32).repeat(tile_chunks)
        ct = (tiles % nt).astype(np.int32).repeat(tile_chunks)
        w_max = int(w_jt.max())
        return _finish_pack(cj, ct, idx, vals, nchunk, w_max, m, n_orig,
                            mp, np_, csr.nnz, inv_perm, perm_plan, tiles,
                            tile_chunks, w_jt)

    r = np.repeat(np.arange(n, dtype=np.int64), csr.row_nnz)
    mi = csr.col_idx.astype(np.int64)
    bi, bj = mi // _LANES, r // _LANES

    if r.size:
        from tpusparse.formats.csr import segment_ranks

        # rank within each (column, window) run — entries sorted by (r, mi)
        rank, grp_start, grp_counts = segment_ranks(r, bi)

        tkey = bj * nt + bi                    # tiles sorted by (group, win)
        tiles, tinv = np.unique(tkey, return_inverse=True)
        w_jt = np.zeros(tiles.size, dtype=np.int64)
        run_tile = np.searchsorted(tiles, (r[grp_start] // _LANES) * nt +
                                   bi[grp_start])
        np.maximum.at(w_jt, run_tile, grp_counts)
        tile_chunks = -(-w_jt // _SUB)
        tile_base = np.concatenate([[0], np.cumsum(tile_chunks)])
        nchunk = int(tile_base[-1])

        cj = (tiles // nt).astype(np.int32).repeat(tile_chunks)
        ct = (tiles % nt).astype(np.int32).repeat(tile_chunks)
        idx = np.zeros((nchunk, _SUB, _LANES), dtype=np.int8)
        vals = np.zeros((nchunk, _SUB, _LANES), dtype=csr.values.dtype)
        chunk = tile_base[tinv] + rank // _SUB
        idx[chunk, rank % _SUB, r % _LANES] = (mi % _LANES).astype(np.int8)
        vals[chunk, rank % _SUB, r % _LANES] = csr.values
        w_max = int(w_jt.max())
    else:
        nchunk = 0
        cj = np.zeros(0, np.int32)
        ct = np.zeros(0, np.int32)
        idx = np.zeros((0, _SUB, _LANES), np.int8)
        vals = np.zeros((0, _SUB, _LANES), np.float32)
        tiles = np.zeros(0, np.int64)
        tile_chunks = np.zeros(0, np.int64)
        w_jt = np.zeros(0, np.int64)
        w_max = 0

    return _finish_pack(cj, ct, idx, vals, nchunk, w_max, m, n_orig, mp,
                        np_, csr.nnz, inv_perm, perm_plan, tiles,
                        tile_chunks, w_jt)


_RUN = 8                       # run alignment quantum
# Align only when group padding stays under this fraction of the stream.
_RUN_PAD_FRAC = 0.2


def _run_align(cj, ct, idx, vals):
    """Pad each output group's chunk list to a multiple of _RUN so every
    _RUN-chunk sub-block of the stream shares one cj (the ``run`` field
    records it). Pad chunks carry the GROUP's cj (so even an all-pad run
    targets the right tile) and zero vals (contribute nothing). Requires
    cj sorted ascending (pack order).

    Returns (cj, ct, idx, vals) aligned, or None when the padding would
    exceed _RUN_PAD_FRAC of the stream (small packs with many 1-3 chunk
    groups)."""
    n = len(cj)
    if n == 0:
        return None
    groups, counts = np.unique(cj, return_counts=True)
    aligned = -(-counts // _RUN) * _RUN
    pad_total = int(aligned.sum() - n)
    if pad_total == 0:
        return cj, ct, idx, vals
    if pad_total > _RUN_PAD_FRAC * n:
        return None
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    new_starts = np.concatenate([[0], np.cumsum(aligned)[:-1]])
    # old chunk i of group g maps to new_starts[g] + (i - starts[g])
    ginv = np.repeat(np.arange(groups.size), counts)
    pos = new_starts[ginv] + (np.arange(n) - starts[ginv])
    total = int(aligned.sum())
    cj2 = np.repeat(groups.astype(np.int32), aligned)
    ct2 = np.zeros(total, np.int32)
    idx2 = np.zeros((total, _SUB, _LANES), np.int8)
    vals2 = np.zeros((total, _SUB, _LANES), vals.dtype)
    ct2[pos] = ct
    idx2[pos] = idx
    vals2[pos] = vals
    return cj2, ct2, idx2, vals2


def _finish_pack(cj, ct, idx, vals, nchunk, w_max, m, n_orig, mp, np_, nnz,
                 inv_perm, perm_plan, tiles, tile_chunks, w_jt,
                 run_align: bool | str = "auto"):
    if nchunk == 0:                            # keep >= 1 chunk
        cj = np.zeros(1, np.int32)
        ct = np.zeros(1, np.int32)
        idx = np.zeros((1, _SUB, _LANES), np.int8)
        vals = np.zeros((1, _SUB, _LANES), np.float32)
    run = 1
    if run_align is not False and nchunk:
        out = _run_align(cj, ct, idx, vals)
        if out is not None:
            cj, ct, idx, vals = out
            run = _RUN
        elif run_align is True:
            raise ValueError("run_align=True but group padding exceeds "
                             f"{_RUN_PAD_FRAC:.0%} of the stream")
    # length alignment: long chunk lists align to 128; relative padding
    # <= 12.5%, and zero chunks multiply zeros into group 0 — harmless.
    # 128 is a multiple of _RUN, so tail pads form whole (all-zero) runs.
    align = 128 if len(cj) >= 1024 else _SUB
    pad = -len(cj) % align if len(cj) >= 64 else 0
    if pad:
        cj = np.concatenate([cj, np.zeros(pad, np.int32)])
        ct = np.concatenate([ct, np.zeros(pad, np.int32)])
        idx = np.concatenate([idx, np.zeros((pad, _SUB, _LANES), np.int8)])
        vals = np.concatenate([vals, np.zeros((pad, _SUB, _LANES),
                                              vals.dtype)])
    if run > 1 and len(cj) % _RUN:             # short-list guard (<64)
        extra = -len(cj) % _RUN
        cj = np.concatenate([cj, np.zeros(extra, np.int32)])
        ct = np.concatenate([ct, np.zeros(extra, np.int32)])
        idx = np.concatenate([idx,
                              np.zeros((extra, _SUB, _LANES), np.int8)])
        vals = np.concatenate([vals, np.zeros((extra, _SUB, _LANES),
                                              vals.dtype)])
    return dict(cj=cj, ct=ct, idx=idx, vals=vals, shape=(m, n_orig),
                padded=(mp, np_), nnz=int(nnz), n_real=nchunk,
                w_max=w_max, inv_perm=inv_perm, perm_plan=perm_plan,
                run=run,
                _tiles=tiles, _tile_chunks=tile_chunks, _w_jt=w_jt)


@jax.tree_util.register_pytree_node_class
class RsellMatrix:
    def __init__(self, cj, ct, idx, vals, shape, padded, nnz: int,
                 n_real: int, w_max: int, run: int = 1, inv_perm=None,
                 perm_plan=None, **_ignored):
        self.cj = cj
        self.ct = ct
        self.idx = idx
        self.vals = vals
        self.shape = shape
        self.padded = padded
        self.nnz = nnz
        self.n_real = n_real           # chunks before zero padding
        self.w_max = w_max             # widest tile demand (diagnostic)
        self.run = run                 # pack run alignment (1 = flat)
        self.inv_perm = inv_perm       # None when packed unsorted
        self.perm_plan = perm_plan     # (oidx, oh) unpermute planes

    def tree_flatten(self):
        return ((self.cj, self.ct, self.idx, self.vals, self.inv_perm,
                 self.perm_plan),
                (self.shape, self.padded, self.nnz, self.n_real,
                 self.w_max, self.run))

    @classmethod
    def tree_unflatten(cls, aux, children):
        cj, ct, idx, vals, inv_perm, perm_plan = children
        if len(aux) == 5:              # files saved before the run field
            aux = (*aux, 1)
        return cls(cj, ct, idx, vals, *aux, inv_perm=inv_perm,
                   perm_plan=perm_plan)

    @classmethod
    def _io_rebuild(cls, aux, leaves):
        """Rebuild from npz leaves: unsorted packs drop the permute leaves
        (None children); sorted packs carry inv_perm + (oidx, oh)."""
        if len(leaves) == 4:
            return cls.tree_unflatten(aux, (*leaves, None, None))
        if len(leaves) != 7:
            raise ValueError(f"{len(leaves)} leaves, expected 4 or 7")
        return cls.tree_unflatten(aux, (*leaves[:5], (leaves[5], leaves[6])))

    def __repr__(self) -> str:
        return (f"RsellMatrix(shape={self.shape}, nnz={self.nnz}, "
                f"chunks={self.n_real}, w_max={self.w_max}, "
                f"{self.device_bytes() / 1e6:.1f} MB)")

    @classmethod
    def from_csr(cls, csr) -> "RsellMatrix":
        return cls(**rsell_pack_csr(csr))

    @classmethod
    def from_dense(cls, a: np.ndarray) -> "RsellMatrix":
        from tpusparse.formats.csr import CsrMatrix

        return cls.from_csr(CsrMatrix.from_dense(np.asarray(a)))

    def device_bytes(self) -> int:
        vals = self.vals
        return int(np.prod(vals.shape)) * (vals.dtype.itemsize + 1) + \
            int(np.prod(self.cj.shape)) * 8

    def to_dense(self) -> np.ndarray:
        mp, np_ = self.padded
        idx = np.asarray(self.idx)
        vals = np.asarray(self.vals)
        a = np.zeros((mp, np_), dtype=vals.dtype)
        kk, ss, rr = np.nonzero(vals)
        cc = idx[kk, ss, rr].astype(np.int64)
        cj = np.asarray(self.cj)
        ct = np.asarray(self.ct)
        a[ct[kk] * _LANES + cc, cj[kk] * _LANES + rr] = vals[kk, ss, rr]
        if self.inv_perm is not None:
            a = a[:, np.asarray(self.inv_perm)]
        return a[:self.shape[0], :self.shape[1]]

    def _run(self, x2d: jax.Array) -> jax.Array:
        from tpusparse.kernels.rsell_spmv import rsell_spmm_padded

        mp, np_ = self.padded
        if x2d.shape[1] != mp:
            x2d = jnp.pad(x2d, ((0, 0), (0, mp - x2d.shape[1])))
        y = rsell_spmm_padded(self.cj, self.ct, self.idx, self.vals, x2d,
                              n_padded=np_)
        if self.inv_perm is not None:              # undo the column sort
            return jnp.take(y, jnp.asarray(self.inv_perm)[:self.shape[1]],
                            axis=1)
        return y[:, :self.shape[1]]

    def spmv(self, x: Any) -> jax.Array:
        return self._run(jnp.asarray(x)[None, :])[0]

    def spmm(self, x: Any) -> jax.Array:
        return self._run(jnp.asarray(x))


class RsellShards:
    """Host-packed per-shard chunk lists + the group placement map.

    Not a pytree on purpose: leaves are placed by
    ``parallel.sparse.rsell_spmm_sharded`` with explicit shardings.
    """

    def __init__(self, cj, ct, idx, vals, group_map, shape, padded, nnz,
                 counts, w_shard, perm_plan=None, run: int = 1):
        self.run = run                 # uniform pack run alignment
        self.cj = cj                   # (D, Lmax) int32 local group
        self.ct = ct                   # (D, Lmax) int32 window
        self.idx = idx                 # (D, Lmax, 8, 128) int8
        self.vals = vals               # (D, Lmax, 8, 128)
        self.group_map = group_map     # (D, nb_loc) sorted group id or -1
        self.shape = shape
        self.padded = padded
        self.nnz = nnz
        self.counts = counts           # (D,) real chunks per shard
        self.w_shard = w_shard         # (D,) max tile demand per shard
        self.perm_plan = perm_plan     # column unpermute (None if unsorted)

    @property
    def n_shards(self) -> int:
        return self.cj.shape[0]

    @property
    def balance(self) -> float:
        """max/mean real-chunk load — 1.0 is perfectly balanced."""
        mean = float(self.counts.mean()) or 1.0
        return float(self.counts.max()) / mean

    def __repr__(self) -> str:
        c = self.counts
        return (f"RsellShards(shape={self.shape}, nnz={self.nnz}, "
                f"D={self.n_shards}, chunks/shard "
                f"[{int(c.min())}..{int(c.max())}] mean {c.mean():.0f}, "
                f"balance {self.balance:.2f}, "
                f"w/shard [{int(self.w_shard.min())}.."
                f"{int(self.w_shard.max())}])")


def rsell_shard_pack(csr_or_dense, n_shards: int,
                     assignment: str = "balance",
                     sort: bool | str = "auto") -> RsellShards:
    """Assign output COLUMNS to shards and pack each shard's own chunk list.

    Column (not group) granularity matters on skewed matrices: a tile is
    128 columns wide, so a handful of head columns concentrated in one
    group would cap any group-level balancing at max_group_load/mean.

    ``assignment``:
    - ``balance`` (default): serpentine-deal the demand-ordered columns
      across shards — every shard's k-th local group holds a similar
      demand mix, so per-shard chunk loads land within a few % of equal.
    - ``sorted``: contiguous demand-ordered ranges — shard 0 takes the
      densest columns (maximal per-shard width spread: each shard pays its
      OWN width, the chip-level analog of AWSP-Ref's per-warp max,
      awsp_ref.cpp:25-40).
    - ``contiguous``: shard d takes columns [d*cps, (d+1)*cps) in original
      order, NO demand sort and NO output permutation (``perm_plan`` is
      None; ``sort`` is ignored). The unpermute plan's one-hot masks are
      O(n^2/128) bytes — fine at the 8k-column SpMV scale, impossible at
      AMG-level sizes — so this mode is the carrier for sharded greedy
      AMG hierarchies (amg.setup(mesh=...)), whose near-uniform Galerkin
      operators don't need demand balancing.

    No divisibility requirements: trailing shards take empty columns, and
    chunk lists pad with zero chunks to the max shard length. The output
    is reassembled with one static column permutation (kernels/permute.py),
    except ``contiguous``, which is already in order.
    """
    from tpusparse.formats.csr import (CsrMatrix, col_window_widths,
                                       csr_rows_subset)
    from tpusparse.kernels.permute import permute_plan

    csr = csr_or_dense if isinstance(csr_or_dense, CsrMatrix) else \
        CsrMatrix.from_dense(np.asarray(csr_or_dense))
    m, n = csr.shape
    mp, np_ = round_up(m, _LANES), round_up(n, _LANES)
    if assignment == "contiguous":
        sort = False
    elif sort == "auto":
        cw = col_window_widths(csr)
        med = float(np.median(cw)) if cw.size else 0.0
        sort = med > 0 and int(cw.max()) >= 1.5 * med
    col_nnz = np.zeros(np_, dtype=np.int64)
    col_nnz[:n] = csr.row_nnz
    order = np.argsort(-col_nnz, kind="stable") if sort \
        else np.arange(np_, dtype=np.int64)

    nb = np_ // _LANES
    nb_loc = -(-nb // n_shards)
    cps = nb_loc * _LANES                        # columns per shard
    total = n_shards * cps
    assign = np.full((n_shards, cps), np_, dtype=np.int64)  # np_ == empty
    if assignment == "balance":
        k = np.arange(np_)
        cyc = k % (2 * n_shards)                 # serpentine deal
        d = np.where(cyc < n_shards, cyc, 2 * n_shards - 1 - cyc)
        slot = k // n_shards
        assign[d, slot] = order
    elif assignment in ("sorted", "contiguous"):
        # contiguous: order is the identity (sort forced off above), so
        # shard d holds columns [d*cps, (d+1)*cps) and needs no unpermute
        padded = np.concatenate(
            [order, np.full(total - np_, np_, dtype=np.int64)])
        assign = padded.reshape(n_shards, cps)
    else:
        raise ValueError(f"unknown assignment {assignment!r}")

    packs = [rsell_pack_csr(csr_rows_subset(csr, assign[d]), sort=False)
             for d in range(n_shards)]
    counts = np.array([p["n_real"] for p in packs], dtype=np.int64)
    w_shard = np.array([p["w_max"] for p in packs], dtype=np.int64)
    # one program serves every shard, so the run flag must be uniform:
    # run-aligned only when every shard's pack aligned
    run = _RUN if all(p.get("run", 1) == _RUN for p in packs) else 1
    lmax = max(int(max(p["cj"].shape[0] for p in packs)), 1)
    if run > 1:
        lmax = -(-lmax // _RUN) * _RUN
    cj_s = np.zeros((n_shards, lmax), np.int32)
    ct_s = np.zeros((n_shards, lmax), np.int32)
    idx_s = np.zeros((n_shards, lmax, _SUB, _LANES), np.int8)
    val_s = np.zeros((n_shards, lmax, _SUB, _LANES), csr.values.dtype)
    for d, p in enumerate(packs):
        k = p["cj"].shape[0]
        cj_s[d, :k] = p["cj"]
        ct_s[d, :k] = p["ct"]
        idx_s[d, :k] = p["idx"]
        val_s[d, :k] = p["vals"]

    # one column-granular unpermute: original column c sits at flat output
    # lane d * cps + slot where assign[d, slot] == c
    if assignment == "contiguous":
        perm_plan = None        # identity placement, O(n^2/128) plan skipped
    else:
        flat = assign.ravel()
        real = flat < np_
        pos_of = np.empty(np_ + 1, dtype=np.int64)
        pos_of[flat[real]] = np.flatnonzero(real)
        pp = permute_plan(pos_of[:n], src_size=total)
        perm_plan = (pp["oidx"], pp["oh"])
    group_map = (assign[:, ::_LANES] // _LANES).astype(np.int32)  # info only
    return RsellShards(cj_s, ct_s, idx_s, val_s, group_map,
                       (m, n), (mp, np_), int(csr.nnz), counts, w_shard,
                       perm_plan=perm_plan, run=run)
