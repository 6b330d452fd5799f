"""Multi-chip sparse SpMV/SpMM: sharded formats under shard_map.

The BASELINE.json scaling component, with no reference counterpart
(single-GPU study, SURVEY.md §2.4). Partitions:

- ``n``  — shard output column groups: SELL leaves shard on their ``nb``
  axis, X is replicated (the fully-exchanged-halo case); zero steady-state
  comm, Y lands sharded. The chip-level analog of the reference's
  block-per-32-columns decomposition (wsp.cu:13).
- ``m``  — shard contraction windows: SELL leaves shard on ``nt``, each chip
  consumes its X shard and psums partial Y over the interconnect — the
  chip-level lift of the reference's split-M-across-warps + smem reduction
  (asp.cu:13-40).
- ``2d`` — batch x output mesh for SpMM: X shards over the batch axis, the
  format over the output axis (the DP x TP analog).

BSR shards by output groups with per-device block counts padded to the max
(explicit zero blocks), since shard_map needs rectangular shards.
"""

from __future__ import annotations

from typing import Any

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax
from jax import shard_map as _shard_map
from jax.sharding import Mesh, PartitionSpec as P

from tpusparse.parallel import comm

from tpusparse.formats.bsr import bsr_pack
from tpusparse.formats.sell import SellMatrix

_LANES = 128


def _as_2d(x: Any) -> tuple[jax.Array, bool]:
    """(x2d, squeeze): promote (m,) activations to (1, m)."""
    squeeze = np.ndim(x) == 1
    xj = jnp.asarray(x)
    return (xj[None, :] if squeeze else xj), squeeze


def _pad_axis(arr: jax.Array, axis: int, mult: int) -> jax.Array:
    """Zero-pad ``axis`` to a multiple of ``mult`` (shard divisibility —
    padded groups/windows multiply zeros and are sliced off the output)."""
    pad = -arr.shape[axis] % mult
    if not pad:
        return arr
    widths = [(0, 0)] * arr.ndim
    widths[axis] = (0, pad)
    return jnp.pad(arr, widths)


# ----------------------------- SELL ---------------------------------------


def sell_spmm_sharded(s: SellMatrix, x: Any, mesh: Mesh,
                      partition: str = "n") -> jax.Array:
    """y = x @ A with SELL-format A sharded over ``mesh``.

    x: (m,) or (b, m). Returns the full (replicated-view) result; XLA keeps
    the physical layout sharded per ``partition``.
    """
    from tpusparse.kernels.sell_spmv import sell_spmm_padded

    x2d, squeeze = _as_2d(x)
    mp, np_ = s.padded
    if x2d.shape[1] != mp:
        x2d = jnp.pad(x2d, ((0, 0), (0, mp - x2d.shape[1])))

    idx_l, vals_l = jnp.asarray(s.idx), jnp.asarray(s.vals)
    # int8 value storage: per-output-column scales shard with the column
    # groups (nb axis). Dequant happens AFTER each partial reduction, and
    # scaling commutes with the m/ring partial-sum psum
    # (scale * sum(partials) == sum(scale * partials)), so every partition
    # threads them safely.
    sc = None if getattr(s, "scales", None) is None else jnp.asarray(s.scales)

    def _with_scales(args, specs, col_sharded: bool, d: int):
        if sc is None:
            return args, specs
        sc_l = _pad_axis(sc, 0, d) if col_sharded else sc
        return (*args, sc_l), (*specs, P("n") if col_sharded else P())

    if partition == "n":
        d = mesh.shape["n"]
        idx_l = _pad_axis(idx_l, 0, d)            # zero column groups
        vals_l = _pad_axis(vals_l, 0, d)

        def f(idx_loc, vals_loc, x_full, *rest):
            return sell_spmm_padded(idx_loc, vals_loc, x_full,
                                    rest[0] if rest else None)

        args, specs = _with_scales((idx_l, vals_l, x2d),
                                      (P("n"), P("n"), P()), True, d)
        y = _shard_map(f, mesh=mesh, check_vma=False,
                       in_specs=specs, out_specs=P(None, "n"))(*args)
    elif partition == "m":
        d = mesh.shape["n"]                       # axis carries M-shards here
        idx_l = _pad_axis(idx_l, 1, d)            # zero contraction windows
        vals_l = _pad_axis(vals_l, 1, d)
        x2d = _pad_axis(x2d, 1, idx_l.shape[1] * _LANES)

        def f(idx_loc, vals_loc, x_loc, *rest):
            out = sell_spmm_padded(idx_loc, vals_loc, x_loc,
                                   rest[0] if rest else None)
            return comm.psum_y(out, "n")

        args, specs = _with_scales(
            (idx_l, vals_l, x2d),
            (P(None, "n"), P(None, "n"), P(None, "n")), False, d)
        y = _shard_map(f, mesh=mesh, check_vma=False,
                       in_specs=specs, out_specs=P())(*args)
    elif partition == "ring":
        # shard BOTH dims: each chip owns a column-group slab (nb) and an
        # X window-shard; X shards rotate via ppermute while each chip
        # consumes the matching window band of its local SELL slice —
        # halo exchange overlapped with compute (the ring-attention analog,
        # SURVEY.md §5). Peak memory per chip: format/D + X/D.
        d = mesh.shape["n"]
        idx_l = _pad_axis(_pad_axis(idx_l, 0, d), 1, d)
        vals_l = _pad_axis(_pad_axis(vals_l, 0, d), 1, d)
        x2d = _pad_axis(x2d, 1, idx_l.shape[1] * _LANES)
        band = idx_l.shape[1] // d

        def f(idx_loc, vals_loc, x_loc, *rest):
            my = lax.axis_index("n")
            b = x_loc.shape[0]

            def consume(s, xc):
                # xc is X window-shard ((my + s) % D): consume that band
                t0 = ((my + s) % d) * band
                idx_b = lax.dynamic_slice_in_dim(idx_loc, t0, band, axis=1)
                val_b = lax.dynamic_slice_in_dim(vals_loc, t0, band, axis=1)
                return sell_spmm_padded(idx_b, val_b, xc,
                                        rest[0] if rest else None)

            def step(s, carry):
                y, xc = carry
                return (y + consume(s, xc),
                        comm.ring_shift(xc, "n", shift=-1))

            y0 = jnp.zeros((b, idx_loc.shape[0] * _LANES),
                           x_loc.dtype)   # the product returns x's dtype
            y0 = lax.pcast(y0, "n", to="varying")
            # D-1 sends: the last band skips the unread final ring shift
            y, xc = lax.fori_loop(0, d - 1, step, (y0, x_loc))
            return y + consume(d - 1, xc)

        args, specs = _with_scales((idx_l, vals_l, x2d),
                                      (P("n"), P("n"), P(None, "n")), True, d)
        y = _shard_map(f, mesh=mesh, check_vma=False,
                       in_specs=specs, out_specs=P(None, "n"))(*args)
    elif partition == "2d":
        db, dn = mesh.shape["b"], mesh.shape["n"]
        idx_l = _pad_axis(idx_l, 0, dn)
        vals_l = _pad_axis(vals_l, 0, dn)
        b_real = x2d.shape[0]
        x2d = _pad_axis(x2d, 0, db)               # zero batch rows

        def f(idx_loc, vals_loc, x_loc, *rest):
            return sell_spmm_padded(idx_loc, vals_loc, x_loc,
                                    rest[0] if rest else None)

        args, specs = _with_scales((idx_l, vals_l, x2d),
                                      (P("n"), P("n"), P("b")), True, dn)
        y = _shard_map(f, mesh=mesh, check_vma=False,
                       in_specs=specs, out_specs=P("b", "n"))(*args)
        y = y[:b_real]
    else:
        raise ValueError(f"unknown partition {partition!r}")

    y = y[:, :s.shape[1]]
    return y[0] if squeeze else y


# ----------------------------- RSELL ---------------------------------------


def rsell_spmm_sharded(shards, x: Any, mesh: Mesh) -> jax.Array:
    """y = x @ A with ragged-SELL chunk shards over ``mesh`` (output groups
    assigned per ``formats.rsell.rsell_shard_pack`` — no divisibility
    requirements; per-shard chunk loads differ and are padded with zero
    chunks, so traffic imbalance exactly mirrors the work imbalance the
    assignment chose)."""
    from tpusparse.kernels.rsell_spmv import rsell_spmm_padded

    x2d, squeeze = _as_2d(x)
    mp, np_ = shards.padded
    if x2d.shape[1] != mp:
        x2d = jnp.pad(x2d, ((0, 0), (0, mp - x2d.shape[1])))
    d = shards.n_shards
    if mesh.shape["n"] != d:
        raise ValueError(f"packed for {d} shards, mesh has {mesh.shape['n']}")
    nb_loc = shards.group_map.shape[1]

    def f(cj_loc, ct_loc, idx_loc, vals_loc, x_full):
        return rsell_spmm_padded(cj_loc[0], ct_loc[0], idx_loc[0],
                                 vals_loc[0], x_full,
                                 n_padded=nb_loc * _LANES)

    y = _shard_map(f, mesh=mesh, check_vma=False,
                   in_specs=(P("n"), P("n"), P("n"), P("n"), P()),
                   out_specs=P(None, "n"))(
        jnp.asarray(shards.cj), jnp.asarray(shards.ct),
        jnp.asarray(shards.idx), jnp.asarray(shards.vals), x2d)

    # concat order is (shard, local column); the pack built ONE static
    # column permutation covering both the shard placement and any
    # pack-time demand sort — undo it with one gather. Contiguous
    # shards (perm_plan None, e.g. sharded-AMG carriers) are already in
    # order and just slice off the shard padding.
    if shards.perm_plan is None:
        return (y[0] if squeeze else y)[..., :shards.shape[1]]
    from tpusparse.kernels.permute import apply_permutation

    y = apply_permutation(y, shards.perm_plan, shards.shape[1])
    return y[0] if squeeze else y


# ----------------------------- BINNED ---------------------------------------


def binned_spmm_sharded(bm, x: Any, mesh: Mesh) -> jax.Array:
    """Output-sharded binned SELL: each width bucket's column groups shard
    over the mesh (zero-group padded — no divisibility requirement), bucket
    outputs concatenate in pack order, and the pack-time column sort is
    undone with one gather — the distributed twin of
    ``BinnedSellMatrix._run``."""
    from tpusparse.kernels.sell_spmv import sell_spmm_padded

    x2d, squeeze = _as_2d(x)
    d = mesh.shape["n"]
    parts = []
    for bk in bm.buckets:
        vals = jnp.asarray(bk["vals"])
        idx = jnp.asarray(bk["idx"])
        nbk = vals.shape[0]
        mp = vals.shape[1] * _LANES
        xp = x2d if x2d.shape[1] == mp else \
            jnp.pad(x2d, ((0, 0), (0, mp - x2d.shape[1])))
        idx_l = _pad_axis(idx, 0, d)
        vals_l = _pad_axis(vals, 0, d)

        yk = _shard_map(sell_spmm_padded, mesh=mesh, check_vma=False,
                        in_specs=(P("n"), P("n"), P()),
                        out_specs=P(None, "n"))(idx_l, vals_l, xp)
        parts.append(yk[:, :nbk * _LANES])        # drop shard-pad groups
    y_sorted = jnp.concatenate(parts, axis=1)
    y = jnp.take(y_sorted, jnp.asarray(bm.inv_perm), axis=1)
    return y[0] if squeeze else y


# ----------------------------- AWSP ----------------------------------------


def awsp_shard_slabs(w: "AwspMatrix", n_devices: int,
                     partition: str) -> tuple:
    """One-time slab repack for the m/ring partitions: splits the REAL
    window groups into ``n_devices`` slabs of ceil(ng/D), each with its own
    zero group appended (the format keeps one global zero group only).
    Activation-independent — serving loops should build this once and pass
    it to ``awsp_spmm_sharded(slabs=...)`` instead of paying the
    O(format-bytes) rearrange per call."""
    d = n_devices
    g = w.g
    ng = w.n_groups
    ng_loc = -(-ng // d)
    nb = w.vals.shape[0]

    def _per_slab(leaf, fill_shape):
        real = leaf[:, :ng * g]
        real = _pad_axis(real, 1, d * ng_loc * g)
        s5 = real.reshape(nb, d, ng_loc * g, *fill_shape)
        s5 = jnp.moveaxis(s5, 1, 0)           # (d, nb, ng_loc*G, ...)
        zpad = [(0, 0)] * s5.ndim
        zpad[2] = (0, g)                      # per-slab zero group
        return jnp.pad(s5, zpad)

    idx_s = _per_slab(jnp.asarray(w.idx), (w.w, _LANES))
    vals_s = _per_slab(jnp.asarray(w.vals), (w.w, _LANES))
    if partition == "ring":
        # each chip owns a COLUMN slab of every window-group slab
        idx_s = _pad_axis(jnp.moveaxis(idx_s, 0, 1)
                          .reshape(nb, d * (ng_loc + 1) * g, w.w,
                                   _LANES), 0, d)
        vals_s = _pad_axis(jnp.moveaxis(vals_s, 0, 1)
                           .reshape(nb, d * (ng_loc + 1) * g, w.w,
                                    _LANES), 0, d)
    return idx_s, vals_s


def awsp_spmm_sharded(w: "AwspMatrix", x: Any, mesh: Mesh,
                      partition: str = "n",
                      plan: np.ndarray | None = None,
                      slabs: tuple | None = None) -> jax.Array:
    """y = x @ A with AWSP-format A sharded over ``mesh``.

    - ``n``: column groups shard on ``nb``; the activation window-group
      plan is host-computed once and replicated — every chip skips the same
      dead window groups of its own column slab, so traffic per chip is
      (active groups / groups) x (format bytes / D).
    - ``m``: window groups shard across chips (each chip gets its own zero
      group + a LOCAL plan over its group slab), partial Ys psum over the
      interconnect. Per-device plans pad to the longest with the local zero
      group; a pad entry reduces that zero group again, so the overhead
      equals the activation imbalance — zero on i.i.d. X, bounded by the
      skew on structured X.
    - ``ring``: column groups shard on ``nb`` AND X rotates in window-group
      bands via ppermute, each step consuming the matching band with that
      band's precomputed plan — activation skip preserved under the ring.
    """
    from tpusparse.kernels.awsp_spmv import awsp_spmm_padded

    x2d, squeeze = _as_2d(x)
    g = w.g
    d = mesh.shape["n"]
    ng = w.n_groups
    ng_loc = -(-ng // d)

    if partition == "n":
        if plan is None:
            plan = w.plan(np.asarray(x2d))
        rows_tot = w.vals.shape[1] * _LANES
        xp = jnp.pad(x2d, ((0, 0), (0, rows_tot - x2d.shape[1])))
        idx_l = _pad_axis(jnp.asarray(w.idx), 0, d)   # zero column groups
        vals_l = _pad_axis(jnp.asarray(w.vals), 0, d)

        def f(plan_full, idx_loc, vals_loc, x_full):
            return awsp_spmm_padded(plan_full, idx_loc, vals_loc, x_full,
                                    g=g)

        y = _shard_map(f, mesh=mesh, check_vma=False,
                       in_specs=(P(), P("n"), P("n"), P()),
                       out_specs=P(None, "n"))(
            jnp.asarray(plan), idx_l, vals_l, xp)
    elif partition in ("m", "ring"):
        if plan is None:
            plan = w.plan(np.asarray(x2d))
        plan = np.asarray(plan)
        plan = plan[plan < ng]                    # drop the empty-X marker
        nb = w.vals.shape[0]
        # the slab repack is activation-independent; build once per
        # (format, mesh, partition) and pass slabs= in serving loops
        if slabs is None:
            slabs = awsp_shard_slabs(w, d, partition)
        idx_s, vals_s = slabs
        rows_slab = ng_loc * g * _LANES
        xp = jnp.pad(x2d, ((0, 0),
                           (0, d * rows_slab - x2d.shape[1])))
        x_s = jnp.moveaxis(xp.reshape(x2d.shape[0], d, rows_slab), 1, 0)
        x_s = jnp.pad(x_s, ((0, 0), (0, 0), (0, g * _LANES)))

        # local plans: per slab, the active groups it owns (local ids);
        # pad with the LOCAL zero group id ng_loc
        slab_of = plan // ng_loc
        counts = np.bincount(slab_of, minlength=d)
        lmax = max(int(counts.max()) if counts.size else 0, 1)
        plans = np.full((d, lmax), ng_loc, dtype=np.int32)
        for dd in range(d):
            loc = plan[slab_of == dd] - dd * ng_loc
            plans[dd, :loc.size] = loc

        if partition == "m":
            def f(plan_loc, idx_loc, vals_loc, x_loc):
                out = awsp_spmm_padded(plan_loc[0], idx_loc[0], vals_loc[0],
                                       x_loc[0], g=g)
                return comm.psum_y(out, "n")

            y = _shard_map(f, mesh=mesh, check_vma=False,
                           in_specs=(P("n"), P("n"), P("n"), P("n")),
                           out_specs=P())(
                jnp.asarray(plans), idx_s, vals_s, x_s)
        else:                                     # ring
            # each chip owns a COLUMN slab of every window-group slab and
            # rotates X slabs, consuming band (my+s)%d with its local plan
            # (awsp_shard_slabs already produced the ring layout)
            idx_r, vals_r = idx_s, vals_s
            bandw = (ng_loc + 1) * g

            def f(plans_all, idx_loc, vals_loc, x_loc):
                my = lax.axis_index("n")
                b = x_loc.shape[0]

                def consume(s, xc):
                    band = (my + s) % d
                    idx_b = lax.dynamic_slice_in_dim(
                        idx_loc, band * bandw, bandw, axis=1)
                    val_b = lax.dynamic_slice_in_dim(
                        vals_loc, band * bandw, bandw, axis=1)
                    pl_b = lax.dynamic_index_in_dim(
                        plans_all, band, 0, keepdims=False)
                    return awsp_spmm_padded(pl_b, idx_b, val_b, xc, g=g)

                def step(s, carry):
                    y, xc = carry
                    return (y + consume(s, xc),
                            comm.ring_shift(xc, "n", shift=-1))

                y0 = jnp.zeros((b, idx_loc.shape[0] * _LANES),
                               x_loc.dtype)
                y0 = lax.pcast(y0, "n", to="varying")
                # D-1 sends: the final band skips the unread ring shift
                y, xc = lax.fori_loop(0, d - 1, step, (y0, x_loc))
                return y + consume(d - 1, xc)

            y = _shard_map(f, mesh=mesh, check_vma=False,
                           in_specs=(P(), P("n"), P("n"), P(None, "n")),
                           out_specs=P(None, "n"))(
                jnp.asarray(plans), idx_r, vals_r,
                jnp.moveaxis(x_s, 0, 1).reshape(
                    x2d.shape[0], d * (rows_slab + g * _LANES)))
    else:
        raise ValueError(f"unknown partition {partition!r}")
    y = y[:, :w.shape[1]]
    return y[0] if squeeze else y


# ----------------------------- TCSR ----------------------------------------


def tcsr_shard_pack(a_or_csr, n_shards: int,
                    expect_batch: int = 1) -> dict[str, Any]:
    """Shard a TCSR matrix by output column groups: BOTH tiers (SELL-packed
    tiles and dense blocks) split per device with zero-tile/zero-block
    padding to rectangular lists. Group counts pad to the device count —
    no divisibility requirements."""
    from tpusparse.formats.bsr import _canonicalize_blocks
    from tpusparse.formats.csr import CsrMatrix
    from tpusparse.formats.tcsr import TcsrMatrix, _canonicalize_sell_tiles

    f = a_or_csr if isinstance(a_or_csr, TcsrMatrix) else (
        TcsrMatrix.from_csr(a_or_csr, expect_batch=expect_batch)
        if isinstance(a_or_csr, CsrMatrix)
        else TcsrMatrix.from_dense(np.asarray(a_or_csr),
                                   expect_batch=expect_batch))
    mp, np_ = f.padded
    nb = np_ // _LANES
    nb_pad = -(-nb // n_shards) * n_shards
    gpd = nb_pad // n_shards
    out: dict[str, Any] = dict(shape=f.shape, padded=(mp, nb_pad * _LANES),
                               w=f.w, nnz=f.nnz, n_shards=n_shards,
                               gpd=gpd)

    if f.n_sell:
        s_bi = np.asarray(f.s_bi)
        s_bj = np.asarray(f.s_bj)
        idx = np.asarray(f.idx)
        vals = np.asarray(f.vals)
        # drop the GLOBAL canonicalization's zero/pad tiles before sharding
        # (per-shard canonicalization below re-inserts exactly what each
        # shard needs; carrying both layers would inflate every shard's
        # padded list length and stream dead zero tiles)
        live = vals.reshape(vals.shape[0], -1).any(axis=1)
        s_bi, s_bj = s_bi[live], s_bj[live]
        idx, vals = idx[live], vals[live]
        dev = s_bj // gpd
        per = []
        for sh in range(n_shards):
            sel = dev == sh
            per.append(_canonicalize_sell_tiles(
                s_bi[sel], s_bj[sel] - sh * gpd, idx[sel], vals[sel],
                gpd, f.w))
        lmax = max(p[0].size for p in per)
        sbi = np.zeros((n_shards, lmax), np.int32)
        sbj = np.full((n_shards, lmax), gpd - 1, np.int32)
        sidx = np.zeros((n_shards, lmax, f.w, _LANES), np.int8)
        svals = np.zeros((n_shards, lmax, f.w, _LANES), vals.dtype)
        for sh, (bi_l, bj_l, idx_l, val_l) in enumerate(per):
            k = bi_l.size
            # keep bj non-decreasing: pad slots stay at gpd-1 (zero tiles)
            sbi[sh, :k] = bi_l
            sbj[sh, :k] = bj_l
            sidx[sh, :k] = idx_l
            svals[sh, :k] = val_l
        out.update(s_bi=sbi, s_bj=sbj, idx=sidx, vals=svals)

    if f.bsr is not None:
        b = f.bsr
        bi = np.asarray(b.bi)
        bj = np.asarray(b.bj)
        blocks = np.asarray(b.blocks)
        live = blocks.reshape(blocks.shape[0], -1).any(axis=1)
        bi, bj, blocks = bi[live], bj[live], blocks[live]
        dev = bj // gpd
        shards = []
        for sh in range(n_shards):
            sel = dev == sh
            shards.append(_canonicalize_blocks(
                bi[sel], bj[sel] - sh * gpd,
                lambda order, sel=sel: blocks[sel][order],
                gpd, b.block_m, blocks.dtype))
        dbi, dbj, dblk = _pad_block_lists(shards, b.block_m, gpd - 1,
                                          blocks.dtype)
        out.update(d_bi=dbi, d_bj=dbj, blocks=dblk, block_m=b.block_m)
    return out


def tcsr_spmm_sharded(packed: dict[str, Any], x: Any,
                      mesh: Mesh) -> jax.Array:
    """Output-sharded TCSR SpMV/SpMM from ``tcsr_shard_pack`` output: each
    device runs its SELL-tier tiles (bsell form) and dense-tier blocks
    (bsr form) over its own column-group slab; zero steady-state comm."""
    from tpusparse.kernels.bsell_spmv import bsell_spmm_padded
    from tpusparse.kernels.bsr_spmv import bsr_spmm_padded

    x2d, squeeze = _as_2d(x)
    mp, np_ = packed["padded"]
    if x2d.shape[1] != mp:
        x2d = jnp.pad(x2d, ((0, 0), (0, mp - x2d.shape[1])))
    d = packed["n_shards"]
    if mesh.shape["n"] != d:
        raise ValueError(f"packed for {d} shards, mesh has {mesh.shape['n']}")
    n_local = packed["gpd"] * _LANES
    b = x2d.shape[0]
    has_sell = "vals" in packed
    has_dense = "blocks" in packed
    block_m = packed.get("block_m", _LANES)

    def f(*args):
        i = 0
        y = None
        if has_sell:
            sbi, sbj, idx, vals = args[0:4]
            i = 4
            y = bsell_spmm_padded(sbi[0], sbj[0], idx[0], vals[0],
                                  args[-1], n_padded=n_local)
        if has_dense:
            dbi, dbj, blk = args[i:i + 3]
            yd = bsr_spmm_padded(dbi[0], dbj[0], blk[0], args[-1],
                                 block_m=block_m, n_padded=n_local)
            y = yd if y is None else y + yd
        if y is None:
            y = jnp.zeros((b, n_local), args[-1].dtype)
        return y

    operands = []
    specs = []
    if has_sell:
        operands += [jnp.asarray(packed[k])
                     for k in ("s_bi", "s_bj", "idx", "vals")]
        specs += [P("n")] * 4
    if has_dense:
        operands += [jnp.asarray(packed[k])
                     for k in ("d_bi", "d_bj", "blocks")]
        specs += [P("n")] * 3
    operands.append(x2d)
    specs.append(P())
    y = _shard_map(f, mesh=mesh, check_vma=False, in_specs=tuple(specs),
                   out_specs=P(None, "n"))(*operands)
    y = y[:, :packed["shape"][1]]
    return y[0] if squeeze else y


# ----------------------------- BSR -----------------------------------------


def _pad_block_lists(per_shard, tbm, pad_bj, dtype):
    """Rectangularize per-shard (bi, bj, blocks) lists: pad every list to
    the max length with zero blocks accumulating into ``pad_bj``."""
    nmax = max(max(len(t[0]) for t in per_shard), 1)
    k_sh = len(per_shard)
    bi_s = np.zeros((k_sh, nmax), np.int32)
    bj_s = np.full((k_sh, nmax), pad_bj, np.int32)
    blk_s = np.zeros((k_sh, nmax, tbm, _LANES), dtype)
    for sh, (bi, bj, blk) in enumerate(per_shard):
        k = len(bi)
        bi_s[sh, :k] = bi
        bj_s[sh, :k] = bj
        blk_s[sh, :k] = blk
    return bi_s, bj_s, blk_s


def bsr_shard_pack(a: np.ndarray, n_shards: int, block_m: int = 128,
                   partition: str = "n") -> dict[str, Any]:
    """Pack dense A into per-device BSR shards.

    - ``n``: each device owns ceil(nb/D) output column groups (group count
      padded — no divisibility requirement).
    - ``m``: each device owns ceil(mb/D) contraction block-rows; partial Ys
      psum at run time.
    - ``ring``: devices own output slabs AND X rotates over contraction
      bands — block lists are split per (device, band).

    Per-device (per-band) block lists pad with explicit zero blocks to the
    max count so shards stay rectangular; imbalanced block placement costs
    zero-block traffic proportional to the imbalance.
    """
    from tpusparse.formats.bsr import _canonicalize_blocks

    full = bsr_pack(a, block_m=block_m)
    mp, np_ = full["padded"]
    tbm = full["block_m"]
    bi, bj, blocks = full["bi"], full["bj"], full["blocks"]
    nb = np_ // _LANES
    mb = mp // tbm

    def _subset(sel, bi_off, bj_off, n_groups_local):
        bi_l = bi[sel] - bi_off
        bj_l = bj[sel] - bj_off
        return _canonicalize_blocks(
            bi_l, bj_l, lambda order: blocks[sel][order],
            n_groups_local, tbm, blocks.dtype)

    if partition == "n":
        nb_pad = -(-nb // n_shards) * n_shards
        gpd = nb_pad // n_shards
        dev = bj // gpd
        shards = [_subset(dev == sh, 0, sh * gpd, gpd)
                  for sh in range(n_shards)]
        bi_s, bj_s, blk_s = _pad_block_lists(shards, tbm, gpd - 1, blocks.dtype)
        return dict(bi=bi_s, bj=bj_s, blocks=blk_s, shape=full["shape"],
                    padded=(mp, nb_pad * _LANES), block_m=tbm,
                    nnz=full["nnz"], n_shards=n_shards, partition="n")
    if partition == "m":
        mb_pad = -(-mb // n_shards) * n_shards
        rpd = mb_pad // n_shards
        dev = bi // rpd
        shards = [_subset(dev == sh, sh * rpd, 0, nb)
                  for sh in range(n_shards)]
        bi_s, bj_s, blk_s = _pad_block_lists(shards, tbm, nb - 1, blocks.dtype)
        return dict(bi=bi_s, bj=bj_s, blocks=blk_s, shape=full["shape"],
                    padded=(mb_pad * tbm, np_), block_m=tbm,
                    nnz=full["nnz"], n_shards=n_shards, partition="m")
    if partition == "ring":
        nb_pad = -(-nb // n_shards) * n_shards
        gpd = nb_pad // n_shards
        mb_pad = -(-mb // n_shards) * n_shards
        rpd = mb_pad // n_shards
        dev = bj // gpd
        band = bi // rpd
        cells = [[_subset((dev == sh) & (band == bb), bb * rpd, sh * gpd,
                          gpd)
                  for bb in range(n_shards)] for sh in range(n_shards)]
        flat = [c for row in cells for c in row]
        bi_s, bj_s, blk_s = _pad_block_lists(flat, tbm, gpd - 1, blocks.dtype)
        lm = bi_s.shape[1]
        return dict(bi=bi_s.reshape(n_shards, n_shards, lm),
                    bj=bj_s.reshape(n_shards, n_shards, lm),
                    blocks=blk_s.reshape(n_shards, n_shards, lm, tbm,
                                         _LANES),
                    shape=full["shape"],
                    padded=(mb_pad * tbm, nb_pad * _LANES), block_m=tbm,
                    nnz=full["nnz"], n_shards=n_shards, partition="ring")
    raise ValueError(f"unknown partition {partition!r}")


def bsr_spmm_sharded(packed: dict[str, Any], x: Any, mesh: Mesh) -> jax.Array:
    """Sharded BSR SpMV/SpMM from ``bsr_shard_pack`` output. For SpMM over
    a 2-D ("b", "n") mesh, pack with ``partition='n'`` — X shards over the
    batch axis (the DP x TP analog)."""
    from tpusparse.kernels.bsr_spmv import bsr_spmm_padded

    x2d, squeeze = _as_2d(x)
    mp, np_ = packed["padded"]
    if x2d.shape[1] != mp:
        x2d = jnp.pad(x2d, ((0, 0), (0, mp - x2d.shape[1])))
    d = packed["n_shards"]
    if mesh.shape["n"] != d:
        raise ValueError(f"packed for {d} shards, mesh has {mesh.shape['n']}")
    block_m = packed["block_m"]
    b = x2d.shape[0]
    partition = packed.get("partition", "n")
    bi_a, bj_a, blk_a = (jnp.asarray(packed["bi"]),
                         jnp.asarray(packed["bj"]),
                         jnp.asarray(packed["blocks"]))

    if partition == "n":
        n_local = np_ // d
        has_b = "b" in mesh.shape          # 2-D batch x output mesh (SpMM)
        b_real = b
        if has_b:
            x2d = _pad_axis(x2d, 0, mesh.shape["b"])
            b = x2d.shape[0]

        def f(bi_loc, bj_loc, blk_loc, x_loc):
            return bsr_spmm_padded(bi_loc[0], bj_loc[0], blk_loc[0], x_loc,
                                   block_m=block_m, n_padded=n_local)

        y = _shard_map(f, mesh=mesh, check_vma=False,
                       in_specs=(P("n"), P("n"), P("n"),
                                 P("b") if has_b else P()),
                       out_specs=P("b", "n") if has_b else P(None, "n"))(
            bi_a, bj_a, blk_a, x2d)
        y = y[:b_real]
    elif partition == "m":
        def f(bi_loc, bj_loc, blk_loc, x_loc):
            y = bsr_spmm_padded(bi_loc[0], bj_loc[0], blk_loc[0], x_loc,
                                block_m=block_m, n_padded=np_)
            return comm.psum_y(y, "n")

        y = _shard_map(f, mesh=mesh, check_vma=False,
                       in_specs=(P("n"), P("n"), P("n"), P(None, "n")),
                       out_specs=P())(bi_a, bj_a, blk_a, x2d)
    elif partition == "ring":
        n_local = np_ // d
        lm = packed["bi"].shape[-1]

        def f(bi_loc, bj_loc, blk_loc, x_loc):
            my = lax.axis_index("n")

            def consume(s, xc):
                band = (my + s) % d
                bi_b = lax.dynamic_index_in_dim(bi_loc[0], band, 0, False)
                bj_b = lax.dynamic_index_in_dim(bj_loc[0], band, 0, False)
                blk_b = lax.dynamic_index_in_dim(blk_loc[0], band, 0, False)
                return bsr_spmm_padded(bi_b, bj_b, blk_b, xc,
                                       block_m=block_m, n_padded=n_local)

            def step(s, carry):
                y, xc = carry
                return (y + consume(s, xc),
                        comm.ring_shift(xc, "n", shift=-1))

            y0 = jnp.zeros((b, n_local), x_loc.dtype)
            y0 = lax.pcast(y0, "n", to="varying")
            # D-1 sends: the final band skips the unread ring shift
            y, xc = lax.fori_loop(0, d - 1, step, (y0, x_loc))
            return y + consume(d - 1, xc)

        y = _shard_map(f, mesh=mesh, check_vma=False,
                       in_specs=(P("n"), P("n"), P("n"), P(None, "n")),
                       out_specs=P(None, "n"))(bi_a, bj_a, blk_a, x2d)
    else:
        raise ValueError(f"unknown partition {partition!r}")
    y = y[:b, :packed["shape"][1]]
    return y[0] if squeeze else y


# ----------------------------- DIA -----------------------------------------


def dia_spmm_sharded(dm, x: Any, mesh: Mesh, partition: str = "halo") -> jax.Array:
    """y = x @ A with DIA-format A (``formats/dia.py``) sharded over ``mesh``.

    Banded structure is the textbook stencil-halo case: each chip owns a
    contiguous slab of output columns, and the only remote X it needs is a
    halo of width max|offset| at each slab edge. Partitions:

    - ``halo`` — X shards with the output slabs; one ``ppermute`` each way
      moves just the (hl + hr) halo elements per batch row, then the k
      shifted fused multiply-adds run on purely local data. Comm
      volume ∝ BANDWIDTH, not m — the 1M-unknown Laplacian's halo is 1024
      of 131k elements/chip at D=8 (0.8%). Requires a square operator and
      halos that fit the neighbor slab (max|offset| <= n/D); the packer
      zeroes out-of-range diagonal entries, so the ring's wrap-around halo
      garbage at the global edges multiplies zero coefficients.
    - ``n`` — X replicated, diagonals shard on their column axis; no
      steady-state comm (matches the other formats' ``n`` partition).

    Symmetric storage (``dm.sym``, only ``d >= 0`` kept): the mirror
    diagonal ``vals_d[c-d]`` crosses the slab edge, so the VALUES get the
    same treatment as X — one extra ``ppermute`` moving the k x max-offset
    left-edge strip (still ∝ bandwidth, and zero-masked on shard 0 where
    the global matrix has no mirror entries; the ring wrap would otherwise
    deliver real coefficients, unlike the X halo whose garbage meets
    packer-zeroed coefficients).
    """
    x2d, squeeze = _as_2d(x)
    m, n = dm.shape
    d = mesh.shape["n"]
    if dm.sym and dm.offsets and \
            max(dm.offsets) > -(-max(n, 1) // d):
        # the mirror read vals_d[c-d] reaches past the immediate left
        # neighbor's slab, which the single edge-strip ppermute cannot
        # serve — materialize full storage (diagonal arrays are small)
        dm = dm.desym()
    offsets = dm.offsets
    dmin = min(offsets) if offsets else 0
    dmax = max(offsets) if offsets else 0
    if dm.sym:
        dmin = min(dmin, -dmax)        # mirrors reach -dmax
    vals = _pad_axis(jnp.asarray(dm.vals), 1, d)      # zero columns
    np_ = vals.shape[1]
    n_loc = np_ // d
    b = x2d.shape[0]

    def mirror_local(vals_loc):
        """(k, hs + n_loc) local vals with the left-neighbor edge strip
        prepended (zeros on shard 0), for ``vals_d[c-d]`` mirror reads."""
        hs = dmax
        vh = comm.ring_shift(vals_loc[:, -hs:], "n", shift=1)
        vh = jnp.where(lax.axis_index("n") == 0, 0.0, vh)
        return jnp.concatenate([vh, vals_loc], axis=1), hs

    if partition == "halo":
        if m != n:
            raise ValueError("partition='halo' needs a square operator "
                             f"(shape {dm.shape}); use partition='n'")
        hl, hr = max(0, -dmin), max(0, dmax)
        if max(hl, hr) > n_loc:
            raise ValueError(
                f"halo {max(hl, hr)} exceeds the {n_loc}-element slab at "
                f"D={d}; band too wide for this mesh — use partition='n'")
        x2d = x2d.astype(jnp.float32)
        if x2d.shape[1] != np_:
            x2d = jnp.pad(x2d, ((0, 0), (0, np_ - x2d.shape[1])))

        def f(vals_loc, x_loc):
            parts = []
            if hl:
                parts.append(comm.ring_shift(x_loc[:, -hl:], "n", shift=1))
            parts.append(x_loc)
            if hr:
                parts.append(comm.ring_shift(x_loc[:, :hr], "n", shift=-1))
            xp = jnp.concatenate(parts, axis=1) if len(parts) > 1 else x_loc
            if dm.sym and dmax:
                vexp, hs = mirror_local(vals_loc)
            y = jnp.zeros((b, n_loc), jnp.float32)
            for i, off in enumerate(offsets):
                y = y + vals_loc[i][None, :] * lax.slice(
                    xp, (0, off + hl), (b, off + hl + n_loc))
                if dm.sym and off > 0:
                    vp = lax.slice(vexp, (i, hs - off),
                                   (i + 1, hs - off + n_loc))[0]
                    y = y + vp[None, :] * lax.slice(
                        xp, (0, hl - off), (b, hl - off + n_loc))
            return y

        y = _shard_map(f, mesh=mesh, check_vma=False,
                       in_specs=(P(None, "n"), P(None, "n")),
                       out_specs=P(None, "n"))(vals, x2d)
    elif partition == "n":
        lo = max(0, -dmin)
        hi = max(0, dmax + np_ - m)
        xp = jnp.pad(x2d.astype(jnp.float32), ((0, 0), (lo, hi)))

        def f(vals_loc, x_full):
            c0 = lax.axis_index("n") * n_loc
            if dm.sym and dmax:
                vexp, hs = mirror_local(vals_loc)
            y = jnp.zeros((b, n_loc), jnp.float32)
            for i, off in enumerate(offsets):
                xs = lax.dynamic_slice_in_dim(x_full, c0 + off + lo, n_loc,
                                              axis=1)
                y = y + vals_loc[i][None, :] * xs
                if dm.sym and off > 0:
                    vp = lax.slice(vexp, (i, hs - off),
                                   (i + 1, hs - off + n_loc))[0]
                    y = y + vp[None, :] * lax.dynamic_slice_in_dim(
                        x_full, c0 - off + lo, n_loc, axis=1)
            return y

        y = _shard_map(f, mesh=mesh, check_vma=False,
                       in_specs=(P(None, "n"), P()),
                       out_specs=P(None, "n"))(vals, xp)
    else:
        raise ValueError(f"unknown partition {partition!r}")
    y = y[:, :n]
    return y[0] if squeeze else y
