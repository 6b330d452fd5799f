"""auto_format routes matrices to the format their statistics call for."""

import numpy as np

from tests.conftest import assert_close
from tpusparse import auto_format, matrix_stats, spmv
from tpusparse.formats.auto import route
from tpusparse.testing import generators, reference


def _check(a, fmt_cls_name):
    f = auto_format(a)
    assert type(f).__name__ == fmt_cls_name, type(f).__name__
    x = generators.random_sparse_vector(a.shape[0], density=0.5, seed=3)
    assert_close(spmv(f, x), reference.sgemv_cpu(x, a),
                 name=f"auto[{fmt_cls_name}]")


def test_uniform_mid_density_is_sell():
    a = generators.random_sparse_matrix(512, 384, density=0.4, seed=1)
    _check(a, "SellMatrix")


def test_near_dense_is_asp():
    a = generators.random_sparse_matrix(512, 384, density=0.8, seed=1)
    _check(a, "AspMatrix")


def test_block_structured_is_tcsr():
    a = generators.random_sparse_matrix(512, 384, density=0.3, seed=2,
                                        distribution="blocks")
    s = matrix_stats(a)
    if s["empty_block_frac"] >= 0.4:
        _check(a, "TcsrMatrix")
    else:  # generator produced dense-ish block cover; stats must still agree
        assert type(auto_format(a)).__name__ != "TcsrMatrix"


def test_powerlaw_is_rsell():
    # small skewed matrix: X/Y fit the rsell wide kernel -> per-tile widths
    a = generators.random_sparse_matrix(1024, 512, density=0.15, seed=4,
                                        distribution="powerlaw")
    s = matrix_stats(a)
    assert s["w_global"] >= 1.5 * s["w_typical"]
    _check(a, "RsellMatrix")


def test_skew_falls_back_to_binned_when_rsell_vmem_bound_binds():
    """Skew routes to RSELL at EVERY size and batch: its product keeps no
    operand resident in on-chip memory, so no X/Y budget caps it and the
    skew branch never falls back to binned (which packed a 262144^2
    powerlaw at 24.5 GB). Stats are supplied (skew, non-blocky, low
    density) so only the branch under test varies; the matrix is a real
    65536^2 CSR that is never densified."""
    from tpusparse.formats.csr import CsrMatrix

    n = 65536
    rng = np.random.default_rng(0)
    rows = np.sort(rng.integers(0, n, 200))
    csr = CsrMatrix.from_coo(n, n, rows, rng.integers(0, n, 200),
                             rng.uniform(-1, 1, 200).astype(np.float32))
    # slot_tile_bytes supplied (5 B/nnz, the real per-tile demand of a
    # 200-nnz matrix) so the BATCH branch (B x gather bytes vs dense)
    # doesn't fire first — this test pins the skew branch
    stats = dict(density=1e-5, nnz=csr.nnz, empty_block_frac=0.0,
                 w_global=12, w_typical=8.0, slot_tile_bytes=5 * csr.nnz)
    for batch in (1, 4, 48):
        assert route(n, n, stats, expect_batch=batch) == "rsell", batch
    f48 = auto_format(csr, expect_batch=48, stats=stats)
    assert type(f48).__name__ == "RsellMatrix", type(f48).__name__
    # the flat-SELL padding branch (no column skew) goes to RSELL too
    pad_stats = dict(stats, w_global=64, w_typical=64.0)
    assert route(n, n, pad_stats, expect_batch=48) == "rsell"


def test_structured_x_pref_is_awsp():
    a = generators.random_sparse_matrix(512, 384, density=0.4, seed=5)
    f = auto_format(a, expect_structured_x=True)
    assert type(f).__name__ == "AwspMatrix"


def test_stats_shape():
    a = generators.random_sparse_matrix(300, 200, density=0.3, seed=6)
    s = matrix_stats(a)
    assert 0 < s["density"] < 1 and s["nnz"] == int((a != 0).sum())


def test_batched_mid_density_is_asp():
    a = generators.random_sparse_matrix(512, 384, density=0.5, seed=7)
    f = auto_format(a, expect_batch=8)
    assert type(f).__name__ == "AspMatrix"
    xb = generators.random_sparse_batch(8, 512, density=0.5, seed=7)
    from tpusparse import spmm
    assert_close(spmm(f, xb), reference.sgemm_cpu(xb, a), name="auto_spmm")


def test_batched_low_density_still_mxu_path():
    """At B>=4 the gather cost per (slot, batch) element loses to dense
    tiles at every density."""
    a = generators.random_sparse_matrix(512, 384, density=0.1, seed=10)
    f = auto_format(a, expect_batch=8)
    assert type(f).__name__ in ("AspMatrix", "TcsrMatrix")


def test_near_dense_never_routes_to_dia():
    # review r2: the widened banded-first rule admitted a 256^2 d=0.9
    # matrix (511 diagonals, ~2x dense bytes over shifted streams); the
    # dense-bytes ceiling must keep such matrices on a dense path
    from tpusparse.formats.auto import auto_format
    from tpusparse.formats.dia import DiaMatrix
    from tpusparse.testing import generators

    rnd = generators.random_sparse_matrix(256, 256, density=0.9, seed=7)
    assert not isinstance(auto_format(rnd), DiaMatrix)


def test_predicted_bytes_quantum_floor():
    """predicted_bytes tracks real packed bytes well enough to gate
    GB-scale packs (bench/scale.py cliff guard): slot formats floor at
    the per-touched-tile chunk quantum."""
    from tpusparse.bench.roofline import format_bytes
    from tpusparse.formats.auto import predicted_bytes
    from tpusparse.formats.rsell import RsellMatrix

    from tpusparse.formats.csr import CsrMatrix

    # uniform (no skew -> pack doesn't sort): stats-only prediction is
    # the exact chunk stream; the pack adds only per-chunk cj/ct int32s
    a = generators.random_sparse_matrix(1024, 768, density=0.02, seed=11)
    s = matrix_stats(a)
    pred = predicted_bytes(1024, 768, s, "rsell")
    real = format_bytes(RsellMatrix.from_dense(a))
    assert 0.8 * pred <= real <= 1.5 * pred, (pred, real)
    # dense-family prediction is exact
    assert predicted_bytes(1024, 768, s, "asp") == 1024 * 768 * 4

    # powerlaw (skew -> the pack SORTS columns, 2.7x below the unsorted
    # bound here): with the CSR in hand the prediction prices the sort
    ap = generators.random_sparse_matrix(1024, 768, density=0.02, seed=11,
                                         distribution="powerlaw")
    sp_ = matrix_stats(ap)
    csr = CsrMatrix.from_dense(ap)
    pred_up = predicted_bytes(1024, 768, sp_, "rsell")
    pred_sorted = predicted_bytes(1024, 768, sp_, "rsell", csr=csr)
    real_p = format_bytes(RsellMatrix.from_dense(ap))
    assert real_p <= pred_up, (real_p, pred_up)      # upper bound holds
    assert 0.8 * pred_sorted <= real_p <= 1.5 * pred_sorted, \
        (pred_sorted, real_p)


def test_scale_bench_cliff_guard():
    """The GB-scale bench records the quantum-floor law instead of
    attempting a pack predicted past the memory budget."""
    from tpusparse.bench import scale

    rec = scale.run(m=2048, density=0.002, quick=True, train=False,
                    hbm_budget=1, verbose=False)
    assert rec["cliff"] == "quantum_floor"
    assert "floor_law" in rec and rec["predicted_gb"] >= 0
    assert "spmv_us" not in rec          # device phase skipped
