"""Sparse kernel parity vs the dense oracle (reference tolerance 1e-3)."""

import numpy as np
import pytest

from tests.conftest import assert_close
from tpusparse.formats.ell import EllMatrix
from tpusparse.testing import generators, reference


@pytest.fixture(scope="module", params=["uniform", "powerlaw", "blocks"])
def workload(request):
    a = generators.random_sparse_matrix(
        512, 384, density=0.4, seed=21, distribution=request.param)
    x = generators.random_sparse_vector(512, density=0.5, seed=21)
    return a, x, reference.sgemv_cpu(x, a)


def test_ell_spmv(workload):
    a, x, y_ref = workload
    assert_close(EllMatrix.from_dense(a).spmv(x), y_ref, name="ell_spmv")


def test_ell_spmm(workload):
    a, x, _ = workload
    xb = generators.random_sparse_batch(4, 512, density=0.5, seed=22)
    y_ref = reference.sgemm_cpu(xb, a)
    assert_close(EllMatrix.from_dense(a).spmm(xb), y_ref, name="ell_spmm")


def test_ops_dispatch(workload):
    from tpusparse import spmv

    a, x, y_ref = workload
    from tpusparse.formats.sell import SellMatrix

    assert_close(spmv(SellMatrix.from_dense(a), x), y_ref,
                 name="ops.spmv[sell]")


def test_sell_spmv(workload):
    from tpusparse.formats.sell import SellMatrix

    a, x, y_ref = workload
    s = SellMatrix.from_dense(a)
    assert_close(s.spmv(x), y_ref, name="sell_spmv")
    assert s.w % 8 == 0


def test_sell_spmm(workload):
    from tpusparse.formats.sell import SellMatrix

    a, x, _ = workload
    xb = generators.random_sparse_batch(3, 512, density=0.5, seed=24)
    y_ref = reference.sgemm_cpu(xb, a)
    assert_close(SellMatrix.from_dense(a).spmm(xb), y_ref, name="sell_spmm")


def test_bsr_spmv_blocks():
    from tpusparse.formats.bsr import BsrMatrix

    a = generators.random_sparse_matrix(512, 384, density=0.3, seed=7,
                                        distribution="blocks", block=128)
    x = generators.random_sparse_vector(512, density=0.5, seed=7)
    b = BsrMatrix.from_dense(a, block_m=128)
    assert_close(b.spmv(x), reference.sgemv_cpu(x, a), name="bsr_spmv")


def test_bsr_spmm_and_empty_group():
    from tpusparse.formats.bsr import BsrMatrix

    a = generators.random_sparse_matrix(512, 384, density=0.3, seed=7,
                                        distribution="blocks", block=128)
    a[:, :128] = 0  # empty output group must still produce zeros
    xb = generators.random_sparse_batch(5, 512, density=0.5, seed=8)
    b = BsrMatrix.from_dense(a, block_m=256)
    assert_close(b.spmm(xb), reference.sgemm_cpu(xb, a), name="bsr_spmm")


def test_binned_sell_powerlaw():
    from tpusparse.formats.binned import BinnedSellMatrix
    from tpusparse.formats.sell import SellMatrix

    a = generators.random_sparse_matrix(512, 640, density=0.25, seed=31,
                                        distribution="powerlaw")
    x = generators.random_sparse_vector(512, density=0.5, seed=31)
    b = BinnedSellMatrix.from_dense(a)
    assert_close(b.spmv(x), reference.sgemv_cpu(x, a), name="binned_spmv")
    # binning must beat flat SELL's global-max padding on skewed matrices
    flat = SellMatrix.from_dense(a)
    assert b.device_bytes() < 0.6 * flat.device_bytes()


def test_binned_sell_uniform_roundtrip():
    from tpusparse.formats.binned import BinnedSellMatrix

    a = generators.random_sparse_matrix(256, 384, density=0.5, seed=2)
    np.testing.assert_array_equal(BinnedSellMatrix.from_dense(a).to_dense(), a)


def test_binned_sell_spmm():
    from tpusparse.formats.binned import BinnedSellMatrix

    a = generators.random_sparse_matrix(512, 640, density=0.25, seed=31,
                                        distribution="powerlaw")
    xb = generators.random_sparse_batch(3, 512, density=0.5, seed=1)
    b = BinnedSellMatrix.from_dense(a)
    assert_close(b.spmm(xb), reference.sgemm_cpu(xb, a), name="binned_spmm")


def test_asp_window_skip():
    from tpusparse.kernels.asp_spmv import AspMatrix

    a = generators.random_sparse_matrix(512, 640, density=0.5, seed=3)
    x = generators.random_sparse_vector(512, density=0.5, seed=3)
    x2 = x.copy()
    x2[0:128] = 0
    x2[256:384] = 0
    m = AspMatrix.from_dense(a)
    assert len(m.plan(x2)) == 2  # skips the two zeroed windows
    assert_close(m.spmv(x), reference.sgemv_cpu(x, a), name="asp_dense_x")
    assert_close(m.spmv(x2), reference.sgemv_cpu(x2, a), name="asp_struct_x")
    assert np.abs(np.asarray(m.spmv(np.zeros(512, np.float32)))).max() == 0
    xb = generators.random_sparse_batch(3, 512, density=0.5, seed=4)
    assert_close(m.spmm(xb), reference.sgemm_cpu(xb, a), name="asp_spmm")


def test_sell_bf16_storage(workload):
    """Reduced-precision value storage (serving): looser tolerance."""
    import jax.numpy as jnp
    from tpusparse.formats.sell import SellMatrix

    a, x, y_ref = workload
    s = SellMatrix.from_dense(a, dtype=jnp.bfloat16)
    assert np.dtype(s.vals.dtype).itemsize == 2
    assert_close(s.spmv(x), y_ref, atol=5e-2, name="sell_bf16")


def test_sell_int8_storage(workload):
    """int8 value storage with per-column scales (serving): 2 bytes/slot."""
    import jax.numpy as jnp

    from tpusparse.formats.sell import SellMatrix

    a, x, y_ref = workload
    s = SellMatrix.from_dense(a, dtype="int8")
    assert np.asarray(s.vals).dtype == np.int8 and s.scales is not None
    f32 = SellMatrix.from_dense(a)
    assert s.device_bytes() < 0.45 * f32.device_bytes()
    # dequantized round-trip within quantization error
    assert float(np.abs(s.to_dense() - a).max()) < \
        float(np.abs(a).max()) / 127 + 1e-6
    assert_close(s.spmv(x), y_ref, atol=1e-1, name="sell_int8")
    xb = generators.random_sparse_batch(2, 512, density=0.5, seed=29)
    assert_close(s.spmm(xb), reference.sgemm_cpu(xb, a), atol=1e-1,
                 name="sell_int8_spmm")
