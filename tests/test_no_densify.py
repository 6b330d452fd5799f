"""No-densify ingestion: every format packs from CsrMatrix, the router works
on CsrMatrix, and a matrix far too large to materialize densely is routed and
multiplied without any (m, n) host allocation."""

import tracemalloc

import numpy as np
import pytest

from tests.conftest import assert_close
from tpusparse.formats.auto import auto_format, matrix_stats, matrix_stats_csr
from tpusparse.formats.binned import BinnedSellMatrix
from tpusparse.formats.bsr import BsrMatrix
from tpusparse.formats.csr import CsrMatrix, col_window_widths, csr_rows_subset
from tpusparse.testing import generators


def _csr_oracle(csr, x):
    """O(nnz) float64 reference straight from the triplets — no dense A."""
    n = csr.shape[1]
    y = np.zeros(n, dtype=np.float64)
    r = np.repeat(np.arange(n), csr.row_nnz)
    np.add.at(y, r, csr.values.astype(np.float64) *
              np.asarray(x, dtype=np.float64)[csr.col_idx])
    return y


@pytest.mark.parametrize("dist,density", [
    ("uniform", 0.3), ("powerlaw", 0.15), ("blocks", 0.2), ("banded", 0.1)])
def test_from_csr_matches_from_dense(dist, density):
    a = generators.random_sparse_matrix(320, 256, density=density, seed=11,
                                        distribution=dist)
    c = CsrMatrix.from_dense(a)
    for cls, kw in [(BsrMatrix, {}), (BsrMatrix, dict(block_m=64)),
                    (BinnedSellMatrix, {})]:
        f_dense = cls.from_dense(a, **kw)
        f_csr = cls.from_csr(c, **kw)
        np.testing.assert_array_equal(
            f_csr.to_dense(), f_dense.to_dense(),
            err_msg=f"{cls.__name__} from_csr != from_dense ({dist})")
        np.testing.assert_array_equal(f_csr.to_dense(), a)


def test_bsr_from_csr_bytes_scale_with_blocks():
    a = generators.random_sparse_matrix(512, 512, density=0.1, seed=3,
                                        distribution="blocks")
    f = BsrMatrix.from_csr(CsrMatrix.from_dense(a))
    assert f.block_density < 0.6          # blocks generator leaves gaps
    assert f.device_bytes() < a.nbytes


def test_matrix_stats_csr_matches_dense():
    for dist in ("uniform", "powerlaw", "blocks"):
        a = generators.random_sparse_matrix(384, 320, density=0.2, seed=5,
                                            distribution=dist)
        s_dense = matrix_stats(a)
        s_csr = matrix_stats_csr(CsrMatrix.from_dense(a))
        for k in ("nnz", "w_global", "empty_block_frac"):
            assert s_dense[k] == s_csr[k], (dist, k)
        assert s_dense["density"] == pytest.approx(s_csr["density"])
        assert s_dense["w_typical"] == pytest.approx(s_csr["w_typical"])


def test_col_window_widths_and_rows_subset():
    a = generators.random_sparse_matrix(300, 200, density=0.25, seed=9)
    c = CsrMatrix.from_dense(a)
    mp = 384
    win = np.pad(a != 0, ((0, mp - 300), (0, 0))).reshape(3, 128, 200)
    np.testing.assert_array_equal(col_window_widths(c),
                                  win.sum(axis=1).max(axis=0))
    rows = np.array([5, 2, 199, 200, 230])        # incl. out-of-range pads
    sub = csr_rows_subset(c, rows)
    want = np.zeros((300, 5), np.float32)
    want[:, :3] = a[:, [5, 2, 199]]
    np.testing.assert_array_equal(sub.to_dense(), want)


def test_auto_format_csr_routes_like_dense():
    cases = [
        (dict(density=0.7, distribution="uniform"), {}, "AspMatrix"),
        (dict(density=0.15, distribution="blocks"), {}, "TcsrMatrix"),
        (dict(density=0.15, distribution="powerlaw"), {},
         "RsellMatrix"),
        (dict(density=0.3, distribution="uniform"),
         dict(expect_structured_x=True), "AwspMatrix"),
        (dict(density=0.3, distribution="uniform"), {}, "SellMatrix"),
        (dict(density=0.5, distribution="uniform"),
         dict(expect_batch=8), "AspMatrix"),
    ]
    for gen_kw, route_kw, want in cases:
        a = generators.random_sparse_matrix(256, 256, seed=21, **gen_kw)
        c = CsrMatrix.from_dense(a)
        got_dense = type(auto_format(a, **route_kw)).__name__
        got_csr = type(auto_format(c, **route_kw)).__name__
        assert got_dense == want and got_csr == want, \
            (gen_kw, route_kw, got_dense, got_csr)


def test_random_sparse_csr_seeded_and_sorted():
    c1 = generators.random_sparse_csr(500, 400, density=0.05, seed=42)
    c2 = generators.random_sparse_csr(500, 400, density=0.05, seed=42)
    np.testing.assert_array_equal(c1.col_idx, c2.col_idx)
    np.testing.assert_array_equal(c1.values, c2.values)
    assert abs(c1.nnz - 500 * 400 * 0.05) / (500 * 400 * 0.05) < 0.1
    r = np.repeat(np.arange(400), c1.row_nnz)
    assert bool(np.all((r[1:] > r[:-1]) |
                       (c1.col_idx[1:] > c1.col_idx[:-1])))
    p = generators.random_sparse_csr(512, 512, density=0.05, seed=1,
                                     distribution="powerlaw")
    nnz = p.row_nnz
    assert nnz.max() >= 4 * max(int(np.median(nnz)), 1)  # genuinely skewed


def test_large_no_densify_route_and_multiply():
    """The no-densify gate, scaled to what a CPU run can do
    in-suite: 8192^2 would be 268 MB dense (+ a 67 MB bool mask for any
    densifying step); the tracemalloc ceiling of 180 MB proves no step
    materialized (m, n) host memory. The 50k x 50k case differs only by
    constant factors (same code path; dense would be 10 GB)."""
    m = n = 8192
    tracemalloc.start()
    try:
        c = generators.random_sparse_csr(m, n, density=0.005, seed=123)
        fmt = auto_format(c)
        x = generators.random_sparse_vector(m, density=0.5, seed=123)
        y = np.asarray(fmt.spmv(x))
        _, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    assert peak < 180e6, f"peak host alloc {peak / 1e6:.0f} MB — densified?"
    assert type(fmt).__name__ in ("RsellMatrix", "BinnedSellMatrix",
                                  "SellMatrix")
    assert_close(y, _csr_oracle(c, x), name=f"no-densify {type(fmt).__name__}")
