"""Native C++ converters: availability + bit-identity with the numpy packers."""

import numpy as np
import pytest

from tpusparse import native
from tpusparse.formats.csr import CsrMatrix
from tpusparse.formats.sell import sell_pack
from tpusparse.testing import generators

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="g++/native build unavailable")


@pytest.fixture(scope="module")
def dense():
    return generators.random_sparse_matrix(512, 384, density=0.35, seed=41)


def test_sell_pack_native_matches_numpy(dense):
    ref = sell_pack(dense, use_native=False)
    nat = sell_pack(dense, use_native=True)
    assert nat["w"] == ref["w"]
    np.testing.assert_array_equal(nat["vals"], ref["vals"])
    np.testing.assert_array_equal(nat["idx"], ref["idx"])


def test_csr_native_matches_numpy(dense):
    ref = CsrMatrix.from_dense(dense, use_native=False)
    nat = CsrMatrix.from_dense(dense, use_native=True)
    np.testing.assert_array_equal(nat.row_ptr, ref.row_ptr)
    np.testing.assert_array_equal(nat.col_idx, ref.col_idx)
    np.testing.assert_array_equal(nat.values, ref.values)


def test_native_speedup_smoke():
    # not a strict perf assertion — just that the native path runs at scale
    a = generators.random_sparse_matrix(2048, 2048, density=0.5, seed=1)
    import time

    t0 = time.perf_counter()
    nat = sell_pack(a, use_native=True)
    t_nat = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = sell_pack(a, use_native=False)
    t_np = time.perf_counter() - t0
    np.testing.assert_array_equal(nat["vals"], ref["vals"])
    print(f"native {t_nat*1e3:.0f}ms vs numpy {t_np*1e3:.0f}ms")


def test_sell_fill_csr_matches_numpy():
    from tpusparse import native
    from tpusparse.formats.csr import CsrMatrix
    from tpusparse.formats.sell import sell_pack_csr

    if not native.available():
        pytest.skip("native library unavailable")
    a = generators.random_sparse_matrix(640, 384, density=0.25, seed=61,
                                        distribution="powerlaw")
    csr = CsrMatrix.from_dense(a)
    p_native = sell_pack_csr(csr, use_native=True)
    p_numpy = sell_pack_csr(csr, use_native=False)
    assert p_native["w"] == p_numpy["w"]
    np.testing.assert_array_equal(p_native["vals"], p_numpy["vals"])
    np.testing.assert_array_equal(p_native["idx"], p_numpy["idx"])


def test_rsell_pack_native_matches_numpy():
    from tpusparse.formats.rsell import rsell_pack_csr

    for dist in ("uniform", "powerlaw", "blocks"):
        a = generators.random_sparse_matrix(640, 512, density=0.2, seed=43,
                                            distribution=dist)
        c = CsrMatrix.from_dense(a)
        ref = rsell_pack_csr(c, use_native=False)
        nat = rsell_pack_csr(c, use_native=True)
        assert nat["n_real"] == ref["n_real"] and nat["w_max"] == ref["w_max"]
        np.testing.assert_array_equal(nat["cj"], ref["cj"])
        np.testing.assert_array_equal(nat["ct"], ref["ct"])
        np.testing.assert_array_equal(nat["vals"], ref["vals"])
        np.testing.assert_array_equal(nat["idx"], ref["idx"])


def test_amg_aggregate_native_matches_numpy():
    from scipy import sparse as ssp

    from tpusparse import native
    from tpusparse.amg import _aggregate

    if not native.available():
        import pytest

        pytest.skip("native library unavailable")
    rng = np.random.default_rng(17)
    # symmetric random + an anisotropic stencil (exercises the theta mask)
    for theta in (0.0, 0.1):
        for seed in (1, 2):
            a = generators.random_sparse_matrix(300, 300, density=0.03,
                                                seed=seed)
            a = a + a.T + 10.0 * np.eye(300, dtype=np.float32)
            sp = ssp.csr_matrix(a.astype(np.float64))
            agg_n, cnt_n = _aggregate(sp, theta, use_native=False)
            agg_c, cnt_c = _aggregate(sp, theta, use_native=True)
            assert cnt_n == cnt_c
            np.testing.assert_array_equal(agg_n, agg_c)
