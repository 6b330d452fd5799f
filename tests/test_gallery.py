"""Gallery workloads: routing decisions + the regret-report plumbing.

The measurements themselves run on the real chip (bench/gallery.py CLI);
these tests pin the router's DECISION on each topology family (small
instances of the same constructions) and the JSON/markdown round trip.
"""

import io
import json

import numpy as np
import pytest

from tpusparse.bench import gallery
from tpusparse.formats.auto import matrix_stats_csr, route
from tpusparse.formats.csr import CsrMatrix
from tpusparse.testing import generators


def _route_of(a, batch=1):
    if not isinstance(a, CsrMatrix):
        a = CsrMatrix.from_dense(np.asarray(a))
    return route(*a.shape, matrix_stats_csr(a), expect_batch=batch)


def test_route_rmat_skew_to_ragged():
    # hub columns: global width far above typical -> per-tile-width carrier
    assert _route_of(generators.rmat_csr(10, 16, seed=1)) == "rsell"


def test_route_mesh_to_block_skip():
    # Delaunay graph Laplacian: ~7 nnz/row spread near the diagonal ->
    # most 128^2 tiles empty -> tcsr
    assert _route_of(generators.mesh_csr(48, 48, seed=2)) == "tcsr"


def test_route_stencils_to_dia():
    assert _route_of(generators.stencil_csr((24, 24, 24))) == "dia"
    assert _route_of(generators.stencil_csr((128, 128), eps=100.0)) == "dia"


def test_route_banded_defects_not_flat_sell():
    # r3 gallery finding: the defected band has NO column skew and NO empty
    # blocks, but flat SELL pays the band width in every window (~40x the
    # slot floor). The padding-ratio rule must route to a per-tile-width
    # format.
    a = generators.banded_defects_csr(2048, bandwidth=32,
                                      defect_density=1e-3, seed=3)
    assert _route_of(a) in ("rsell", "tcsr")


def test_route_nm_pruned_to_flat_sell():
    # N:M pruning is perfectly uniform per window: flat SELL's best case
    a = generators.nm_pruned_matrix(1024, 1024, 2, 4, seed=4)
    assert _route_of(a) == "sell"
    # ... and at large batch the gather law pushes to dense tiles
    assert _route_of(a, batch=32) == "asp"


def test_route_block_pruned_to_tcsr():
    a = generators.block_pruned_matrix(1024, 1024, block=128,
                                       keep_frac=0.3, fill=0.5, seed=5)
    assert _route_of(a, batch=1) == "tcsr"
    assert _route_of(a, batch=32) == "tcsr"


def test_route_batch_uses_routed_bytes_not_flat_sell():
    """r3 fix: the batch flip must compare B x the bytes the B=1 routing
    would ACTUALLY move (per-tile-width storage on skew), not flat SELL's
    hub-inflated global padding — which flipped a d~0.002 hub graph at
    B=8 into densifying 268 MB while RSELL at B=8 still beat dense."""
    g = generators.rmat_csr(13, 16, seed=1)
    assert _route_of(g, batch=1) == "rsell"
    assert _route_of(g, batch=8) == "rsell"      # 8 x ~20 MB << 1.3 x dense
    assert _route_of(g, batch=32) == "asp"       # 32 x crosses the law


def test_route_batch_win_region():
    """The SpMM win-region picks: banded -> DIA at every batch
    (B-independent shifted streams); block-pruned -> TCSR, whose tier
    model goes all-dense-tier (one matrix product, B-independent) as B
    grows; N:M-pruned -> dense tiles + activation skip at batch."""
    st = generators.stencil_csr((64, 64))
    for b in (1, 8, 32):
        assert _route_of(st, batch=b) == "dia"
    bp = generators.block_pruned_matrix(1024, 1024, block=128,
                                        keep_frac=0.3, fill=0.5, seed=5)
    for b in (8, 32):
        assert _route_of(bp, batch=b) == "tcsr"
    nm = generators.nm_pruned_matrix(1024, 1024, 2, 4, seed=7)
    assert _route_of(nm, batch=8) == "asp"


def test_candidates_gate_hub_width_and_density():
    g = generators.rmat_csr(13, 16, seed=1)   # the gallery-scale instance
    s = matrix_stats_csr(g)
    names = [e["name"] for e in gallery.candidates(g, s)]
    assert "sell" not in names          # hub width blows flat-SELL bytes
    assert "dia" not in names           # thousands of sprayed diagonals
    assert {"binned", "rsell", "tcsr", "bsr"} <= set(names)
    b = generators.stencil_csr((24, 24))
    names_b = [e["name"] for e in gallery.candidates(b, matrix_stats_csr(b))]
    assert "dia" in names_b


def test_gallery_json_and_render_round_trip(tmp_path):
    path = str(tmp_path / "g.json")
    rec = dict(run="test-0000", workload="wl", batch=1, m=8, n=8, nnz=4,
               density=0.0625, note="x", routed="sell", best="rsell",
               regret_pct=25.0,
               rows={"sell": dict(us=10.0, mb=1.0, roofline=0.5, pack_s=0.1),
                     "rsell": dict(us=8.0, mb=0.5, roofline=0.9, pack_s=0.2)})
    gallery._append(path, rec)
    # rerun of the same (workload, batch) replaces, not duplicates
    rec2 = dict(rec, regret_pct=0.0, routed="rsell")
    gallery._append(path, rec2)
    assert len(gallery.load(path)) == 1
    assert gallery.load(path)[0]["routed"] == "rsell"
    out = io.StringIO()
    gallery.render(path, out=out)
    text = out.getvalue()
    assert "wl" in text and "test-0000" in text
    assert "regret <= 10% on 1/1" in text


def test_every_workload_is_buildable_and_routes():
    # builders run (small ones fully; the 4096^2 dense families are covered
    # by their generator tests) and route() returns a known format name
    small = ["rmat-s13-ef16", "mesh2d-96", "stencil3d-27pt-32"]
    for name in small:
        a = gallery.WORKLOADS[name]["build"]()
        s = matrix_stats_csr(a)
        assert gallery.route_name(a, s) in (
            "sell", "binned", "rsell", "tcsr", "dia", "asp", "awsp")


def test_scale_train_gate_records_sizing_law():
    """bench.scale pre-sizes the train stage: when
    twins + grads + the uploaded pack (5x format bytes) exceed the
    operand budget, the record carries a train_gate law naming the
    sharded path instead of a raw RESOURCE_EXHAUSTED."""
    from tpusparse.bench import scale as S
    from tpusparse.bench.roofline import format_bytes
    from tpusparse.formats.auto import auto_format
    from tpusparse.testing import generators

    csr = generators.random_sparse_csr(512, 512, 0.05, seed=42,
                                       distribution="powerlaw")
    nbytes = format_bytes(auto_format(csr))
    # budget just above the pack (chain runs) but under the twin-pack
    # sizing (params + grads + planes + pack -> train gated)
    rec = S.run(m=512, density=0.05, quick=True, verbose=False,
                hbm_budget=int(1.2 * nbytes))
    assert "train_gate" in rec, rec
    assert "trainable_linear_sharded" in rec["train_gate"]
    assert rec["train_operands_gb"] > 0
    assert "train_us" not in rec and "train_error" not in rec
    assert "spmv_us" in rec          # the chain up to the gate still ran


def test_scale_quick_train_runs_when_it_fits():
    from tpusparse.bench import scale as S

    rec = S.run(m=512, density=0.05, quick=True, verbose=False)
    assert "train_us" in rec, rec.get("train_error", rec)
