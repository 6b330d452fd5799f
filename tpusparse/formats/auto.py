"""auto_format: pick the right storage format from cheap matrix statistics.

The reference hard-codes which kernel runs (tester.cpp:54-63); a framework
should route a matrix to the format whose regime it falls in:

- banded (few distinct diagonals, diagonal storage within ~4x of the
  slot-format's nnz-proportional bytes): DIA — k statically shifted
  elementwise streams, no gathers, no tile quantum. Tile formats pay the
  8-slot chunk quantum on every touched tile of a wide-spread band, and
  slot formats stay far from their byte floor on banded structure, so DIA
  wins well past byte parity (the 4x headroom).
- near-dense (d > 0.65): compression cannot beat streaming dense A — use the
  ASP window-skip path (dense A + activation skipping; ~dense baseline on
  i.i.d. X, wins on structured X).
- block-structured (>= 40% of 128x128 tiles empty): TCSR — traffic scales
  with kept blocks, each stored dense or SELL-compressed (bytes ∝ in-block
  nnz) per the tcsr cost model.
- skewed columns (a few heavy columns force the global SELL width to >= 1.5x
  the typical column group's need) OR window-concentrated nnz (flat SELL's
  est. bytes >= 3x the 5 B/nnz slot floor — e.g. a defected band, where
  every column needs the band width in ONE window but flat SELL pays it in
  all of them): RSELL — per-tile widths, bytes track each tile's own
  demand at every size.
- otherwise: SELL (flat), or AWSP (SELL + activation window-group skip) when
  the caller expects structured activations.

The thresholds were fitted on an earlier accelerator and keep their values
until they are measured again on this one.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from tpusparse.utils import round_up

_LANES = 128


def matrix_stats(a: np.ndarray) -> dict[str, Any]:
    """Statistics driving format choice. This dense path is O(M*N) (it
    reshapes the full mask); for matrices too large to densify use
    ``matrix_stats_csr``, which is genuinely O(nnz)."""
    a = np.asarray(a)
    m, n = a.shape
    mask = a != 0
    nnz = int(mask.sum())
    density = nnz / max(a.size, 1)

    mp, np_ = round_up(m, _LANES), round_up(n, _LANES)
    mp_mask = np.zeros((mp, np_), dtype=bool)
    mp_mask[:m, :n] = mask
    tiles = mp_mask.reshape(mp // _LANES, _LANES, np_ // _LANES, _LANES)
    block_nnz = tiles.sum(axis=(1, 3))                    # (mb, nb)
    empty_block_frac = float((block_nnz == 0).mean())

    # SELL width demand per column (max window nnz): flat SELL pays the
    # global max for everyone; binned-after-sorting pays ~each column's own
    # demand — skew = global max vs the median column's demand.
    win = tiles.sum(axis=1)                               # (mb, nb, 128)
    col_w = win.max(axis=0).ravel()[:n] if win.size else np.zeros(1)
    w_global = int(col_w.max()) if col_w.size else 0
    w_typical = float(np.median(col_w)) if col_w.size else 0.0

    # per-TILE width demand -> what a per-tile-width format (RSELL, TCSR's
    # SELL tier) would actually store: round_up(w_tile, 8) slot-rows of
    # 5*128 bytes per occupied 128x128 tile. The batch routing law needs
    # this, not flat SELL's hub-inflated global padding (a hub graph's
    # est_sell_bytes can be 24x its real routed bytes, which would flip
    # B=8 serving to a catastrophic densify).
    w_tile = win.max(axis=2)                              # (mb, nb)
    occ = w_tile > 0
    slot_tile_bytes = int((np.ceil(w_tile[occ] / 8) * 8).sum()) * 5 * _LANES

    ii, jj = np.nonzero(mask)
    n_diags = int(np.unique(ii - jj).size)
    # only the DIA admission branch reads diag_sym: skip the O(n^2)
    # transpose compare unless the matrix is banded-shaped at all
    diag_sym = bool(m == n and 0 < n_diags <= 512
                    and np.array_equal(a, a.T))

    return dict(density=density, nnz=nnz,
                empty_block_frac=empty_block_frac,
                w_global=w_global, w_typical=w_typical, n_diags=n_diags,
                diag_sym=diag_sym, slot_tile_bytes=slot_tile_bytes)


def matrix_stats_csr(csr) -> dict[str, Any]:
    """The same statistics computed from (row_ptr, col_idx) in O(nnz) —
    never touches an (m, n) dense array, so the router works on matrices too
    large to materialize."""
    m, n = csr.shape
    nnz = csr.nnz
    density = nnz / max(m * n, 1)
    mp, np_ = round_up(m, _LANES), round_up(n, _LANES)
    mb, nb = mp // _LANES, np_ // _LANES

    r = np.repeat(np.arange(n, dtype=np.int64), csr.row_nnz)
    mi = csr.col_idx.astype(np.int64)
    live = np.unique((mi // _LANES) * nb + (r // _LANES)).size
    empty_block_frac = 1.0 - live / max(mb * nb, 1)

    # per-(column, window) counts -> per-column width demand
    from tpusparse.formats.csr import col_window_widths

    col_w = col_window_widths(csr)
    w_global = int(col_w.max()) if col_w.size else 0
    w_typical = float(np.median(col_w)) if col_w.size else 0.0

    # per-TILE width demand (see matrix_stats): O(nnz)
    if r.size:
        ckey = r * mb + (mi // _LANES)
        uk, counts = np.unique(ckey, return_counts=True)
        w_tile = np.zeros(mb * nb, dtype=np.int64)
        tkey = (uk % mb) * nb + (uk // mb) // _LANES
        np.maximum.at(w_tile, tkey, counts)
        occ = w_tile > 0
        slot_tile_bytes = int((np.ceil(w_tile[occ] / 8) * 8).sum()) * \
            5 * _LANES
    else:
        slot_tile_bytes = 0

    n_diags = int(np.unique(mi - r).size)

    # bitwise A == A.T in O(nnz log nnz): lexsorted triplets vs the
    # lexsorted swapped triplets. Only the DIA admission branch reads it,
    # so skip the two nnz-scale lexsorts unless the matrix is banded-shaped
    diag_sym = False
    if m == n and 0 < n_diags <= 512:
        v = csr.values
        o1 = np.lexsort((r, mi))
        o2 = np.lexsort((mi, r))
        diag_sym = bool(np.array_equal(mi[o1], r[o2])
                        and np.array_equal(r[o1], mi[o2])
                        and np.array_equal(v[o1], v[o2]))

    return dict(density=density, nnz=nnz,
                empty_block_frac=empty_block_frac,
                w_global=w_global, w_typical=w_typical, n_diags=n_diags,
                diag_sym=diag_sym, slot_tile_bytes=slot_tile_bytes)


def route(m: int, n: int, s: dict[str, Any], *,
          expect_structured_x: bool = False, expect_batch: int = 1) -> str:
    """The routing DECISION alone, from statistics — no packing. Returns
    one of {"dia", "asp", "tcsr", "rsell", "awsp", "sell"}.
    ``auto_format`` is this decision plus the matching packer; exposing it
    separately lets the gallery benchmark and router tests ask "what would
    you pick" on matrices whose packing costs seconds."""
    # banded first: when the stored diagonals are mostly FULL (the
    # structural banded signal — without it a small dense-ish random
    # matrix "has" every diagonal at low fill) and diagonal storage
    # (4*k*n bytes, zero-overhead streams) is within ~4x of the slot
    # formats' nnz-proportional floor (5 B/nnz), nothing tile- or
    # gather-shaped can beat it. Bitwise-symmetric operators store only
    # d >= 0 (formats/dia.py symmetric="auto"), so every byte in the
    # admission math halves. The final guard keeps DIA strictly under
    # dense bytes (with 20% headroom): a small near-dense matrix can pass
    # the fill + slot-floor tests with ~2x dense traffic spread over
    # hundreds of shifted streams, where one matmul is the speed of light.
    n_diags = s.get("n_diags", 1 << 30)
    eff_diags = (n_diags + 1) // 2 if s.get("diag_sym") else n_diags
    if 0 < n_diags <= 512 and \
            s["nnz"] >= 0.4 * eff_diags * min(m, n) and \
            4 * eff_diags * n <= 4.0 * 5 * s["nnz"] and \
            4 * eff_diags * n <= 0.8 * 4 * m * n:
        return "dia"
    # batch: gather formats pay gather work per (slot, batch) element, so
    # SpMM time is ~B x their bytes-time while dense-tile time is
    # density-independent; route to dense tiles when B x the bytes the
    # B=1 routing would ACTUALLY move exceeds ~1.3x dense bytes. That is
    # min(flat SELL, per-tile-width storage): on a hub graph flat SELL's
    # global padding is 24x the routed RSELL bytes, and using it here
    # would densify a d=0.002 matrix for B=8 serving.
    est_sell_bytes = (-(-n // _LANES)) * (-(-m // _LANES)) * \
        round_up(max(s["w_global"], 8), 8) * _LANES * 5
    eff_gather_bytes = min(est_sell_bytes,
                           s.get("slot_tile_bytes") or est_sell_bytes)
    dense_bytes = m * n * 4
    if expect_batch >= 2 and \
            expect_batch * eff_gather_bytes >= 1.3 * dense_bytes:
        return "tcsr" if s["empty_block_frac"] >= 0.4 else "asp"
    if s["density"] > 0.65:
        return "asp"
    if s["empty_block_frac"] >= 0.4:
        # TCSR rather than plain BSR: it keeps the block skip and adds the
        # per-tile dense/SELL tier choice, degenerating to BSR tiles exactly
        # when those are cheaper (formats/tcsr.py cost model)
        return "tcsr"
    skew = s["w_typical"] > 0 and s["w_global"] >= 1.5 * s["w_typical"]
    # flat-SELL padding ratio: its layout pays the global width in EVERY
    # window of every column, so a matrix whose nnz concentrate in few
    # windows per column (a band with defects: every column ~65 nnz in one
    # window, so w_global=67 with NO column skew and NO empty 128^2 blocks
    # once defects sprinkle every tile) packs to est_sell_bytes far above
    # the 5 B/nnz slot floor — 189 MB for a 3 MB matrix, a regret the skew
    # rule alone never sees. Per-tile-width formats track the floor.
    pad_ratio = est_sell_bytes / max(5 * s["nnz"], 1)
    if skew or pad_ratio >= 3.0:
        # RSELL: per-tile widths, bytes ∝ each tile's own demand
        return "rsell"
    return "awsp" if expect_structured_x else "sell"


def sorted_slot_tile_bytes(csr) -> int:
    """Per-tile slot demand AFTER the SELL-sigma column sort — what a
    skew-routed RSELL pack actually stores (``rsell_pack_csr`` sorts when
    the router's skew test fires; measured 4.4x smaller than unsorted on
    powerlaw d=0.15). O(nnz log nnz): rank columns by nnz, then per
    (sorted column group, window) tile take the max per-column count and
    charge ceil(w/8) chunks of 5120 B."""
    m, n = csr.shape
    order = np.argsort(-csr.row_nnz, kind="stable")
    rank = np.empty(n, np.int64)
    rank[order] = np.arange(n)
    r = np.repeat(rank, csr.row_nnz)
    mi = csr.col_idx.astype(np.int64)
    nt = (m + _LANES - 1) // _LANES
    ck = r * nt + (mi // _LANES)                 # (sorted col, window)
    uk, counts = np.unique(ck, return_counts=True)
    tkey = ((uk // nt) // _LANES) * nt + (uk % nt)
    o2 = np.argsort(tkey, kind="stable")
    tk, cc = tkey[o2], counts[o2]
    if not tk.size:
        return 0
    starts = np.concatenate([[0], np.flatnonzero(np.diff(tk)) + 1])
    w_tile = np.maximum.reduceat(cc, starts)
    return int((-(-w_tile // 8)).sum()) * 8 * 5 * _LANES


def predicted_bytes(m: int, n: int, s: dict[str, Any], kind: str,
                    csr=None) -> int:
    """Packed-bytes PREDICTION for ``kind`` from statistics alone — no
    packing. Exact enough to gate GB-scale packs before paying for them
    (bench/scale.py's quantum-floor guard): slot formats cannot go below
    round_up(w_tile, 8) x 5 B x 128 lanes per occupied 128^2 tile (the
    8-slot chunk quantum), which ``slot_tile_bytes`` sums exactly; a
    262144^2 powerlaw at d~8e-4 touches 99.2% of its 4.19M tiles, so
    EVERY slot format floors past one card's memory — the regime where
    the multi-chip partitions (parallel/sparse.py) are the design answer. Pass ``csr`` to price the skew-routed RSELL pack honestly
    (it sorts columns; stats-only prediction is the unsorted upper
    bound)."""
    if kind == "dia":
        eff = (s["n_diags"] + 1) // 2 if s.get("diag_sym") \
            else s["n_diags"]
        return 4 * eff * n
    if kind == "asp":
        return 4 * m * n
    if kind in ("rsell", "tcsr", "binned"):
        floor = int(s.get("slot_tile_bytes") or 0)
        skew = s["w_typical"] > 0 and \
            s["w_global"] >= 1.5 * s["w_typical"]
        if kind == "rsell" and skew and csr is not None:
            floor = sorted_slot_tile_bytes(csr)
        if kind == "tcsr":
            # per-tile dense/SELL tier: each tile costs at most the dense
            # tile (128^2 x 4 B), at least its SELL-tier slots
            live = 1.0 - s["empty_block_frac"]
            n_tiles = (round_up(m, _LANES) // _LANES) * \
                (round_up(n, _LANES) // _LANES)
            return int(min(floor, live * n_tiles * _LANES * _LANES * 4))
        return floor
    # flat SELL / AWSP: global width in every window of every column group
    return int((-(-n // _LANES)) * (-(-m // _LANES)) *
               round_up(max(s["w_global"], 8), 8) * _LANES * 5)


def auto_format(a, *, expect_structured_x: bool = False,
                expect_batch: int = 1,
                stats: dict[str, Any] | None = None):
    """Pack ``a`` into the format its statistics call for (see module doc).

    ``expect_batch``: anticipated SpMM batch size. Gather-based formats
    (SELL/AWSP) pay gather work per (slot, batch) element, so SpMM time is
    ~B x (the format's own bytes-time), while dense-tile time is
    density-independent. Crossover: route to dense tiles when B x
    estimated SELL bytes exceeds ~1.3x the dense bytes — TCSR when the
    structure is blocky, else ASP (dense tiles + activation window skip).

    ``a`` may be a dense ndarray or a ``CsrMatrix``: with CSR input both the
    statistics (``matrix_stats_csr``) and every packing branch stay O(nnz)
    in touched memory, except ASP, whose *format* is a reordered dense array
    (asp.cpp:5-13) — a matrix routed there is >65% dense, where the CSR
    triplets already outweigh the dense array.
    """
    from tpusparse.formats.csr import CsrMatrix

    is_csr = isinstance(a, CsrMatrix)
    if not is_csr:
        a = np.asarray(a)
    s = stats or (matrix_stats_csr(a) if is_csr else matrix_stats(a))

    m, n = a.shape
    kind = route(m, n, s, expect_structured_x=expect_structured_x,
                 expect_batch=expect_batch)
    if kind == "dia":
        from tpusparse.formats.dia import DiaMatrix as K
    elif kind == "asp":
        from tpusparse.kernels.asp_spmv import AspMatrix as K
    elif kind == "tcsr":
        from tpusparse.formats.tcsr import TcsrMatrix

        return TcsrMatrix.from_csr(a, expect_batch=expect_batch) if is_csr \
            else TcsrMatrix.from_dense(a, expect_batch=expect_batch)
    elif kind == "rsell":
        from tpusparse.formats.rsell import RsellMatrix as K
    elif kind == "awsp":
        from tpusparse.formats.awsp import AwspMatrix as K
    else:
        from tpusparse.formats.sell import SellMatrix as K
    return K.from_csr(a) if is_csr else K.from_dense(a)
