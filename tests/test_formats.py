"""Converter unit tests: dense -> format -> dense round trips.

SURVEY.md §4 calls the converters "the riskiest code — bitmap/padding logic";
the reference shipped them untested. Every format must reproduce the dense
matrix exactly (values are copied, not computed).
"""

import numpy as np
import pytest

from tpusparse.formats.csr import CsrMatrix
from tpusparse.formats.ell import EllMatrix
from tpusparse.testing import generators, reference


@pytest.fixture(scope="module", params=["uniform", "powerlaw", "blocks"])
def dense(request):
    return generators.random_sparse_matrix(
        384, 256, density=0.4, seed=13, distribution=request.param)


def test_csr_roundtrip(dense):
    c = CsrMatrix.from_dense(dense)
    np.testing.assert_array_equal(c.to_dense(), dense)
    assert c.nnz == (dense != 0).sum()
    assert c.row_ptr.shape == (dense.shape[1] + 1,)  # sentinel included
    assert c.row_ptr[-1] == c.nnz


def test_csr_from_coo(dense):
    rows, cols = np.nonzero(dense)
    c = CsrMatrix.from_coo(dense.shape[0], dense.shape[1],
                           rows, cols, dense[rows, cols])
    np.testing.assert_array_equal(c.to_dense(), dense)


def test_csr_save_load(tmp_path, dense):
    c = CsrMatrix.from_dense(dense)
    p = str(tmp_path / "mat.npz")
    c.save(p)
    c2 = CsrMatrix.load(p)
    np.testing.assert_array_equal(c2.to_dense(), dense)


def test_ell_roundtrip(dense):
    e = EllMatrix.from_dense(dense)
    np.testing.assert_array_equal(e.to_dense(), dense)
    assert e.val.shape[1] % 8 == 0


def test_sell_roundtrip(dense):
    from tpusparse.formats.sell import SellMatrix

    s = SellMatrix.from_dense(dense)
    np.testing.assert_array_equal(s.to_dense(), dense)


def test_sell_roundtrip_unaligned():
    from tpusparse.formats.sell import SellMatrix

    a = generators.random_sparse_matrix(200, 256, density=0.3, seed=3)[:, :250]
    s = SellMatrix.from_dense(a.copy())
    np.testing.assert_array_equal(s.to_dense(), a)


def test_bsr_roundtrip(dense):
    from tpusparse.formats.bsr import BsrMatrix

    b = BsrMatrix.from_dense(dense, block_m=128)
    np.testing.assert_array_equal(b.to_dense(), dense)


def test_bsr_from_blocks():
    from tpusparse.formats.bsr import BsrMatrix

    rng = np.random.default_rng(4)
    blocks = rng.uniform(-1, 1, (3, 128, 128)).astype(np.float32)
    bi = np.array([0, 1, 0]); bj = np.array([1, 1, 3])
    b = BsrMatrix.from_blocks(256, 512, bi, bj, blocks)
    d = b.to_dense()
    np.testing.assert_array_equal(d[0:128, 128:256], blocks[0])
    np.testing.assert_array_equal(d[128:256, 128:256], blocks[1])
    np.testing.assert_array_equal(d[0:128, 384:512], blocks[2])
    assert (d[:, 0:128] == 0).all()


@pytest.mark.parametrize("kind", ["sell", "awsp_g1", "bsr", "awsp", "binned",
                                  "asp", "tcsr", "tcsr_mixed", "rsell"])
def test_format_save_load(tmp_path, dense, kind):
    from tpusparse.formats import io
    from tpusparse.formats.awsp import AwspMatrix
    from tpusparse.formats.binned import BinnedSellMatrix
    from tpusparse.formats.bsr import BsrMatrix
    from tpusparse.formats.rsell import RsellMatrix
    from tpusparse.formats.sell import SellMatrix
    from tpusparse.formats.tcsr import TcsrMatrix
    from tpusparse.kernels.asp_spmv import AspMatrix

    fmt = {"sell": lambda: SellMatrix.from_dense(dense),
           "awsp_g1": lambda: AwspMatrix.from_dense(dense),
           "bsr": lambda: BsrMatrix.from_dense(dense, block_m=128),
           "awsp": lambda: AwspMatrix.from_dense(dense, g=2),
           "binned": lambda: BinnedSellMatrix.from_dense(dense),
           "asp": lambda: AspMatrix.from_dense(dense, block_n=128),
           "tcsr": lambda: TcsrMatrix.from_dense(dense),
           # expect_batch=32 flips every tile to the dense tier, covering
           # the nested-BsrMatrix branch of io save/load
           "tcsr_mixed": lambda: TcsrMatrix.from_dense(dense,
                                                       expect_batch=32),
           "rsell": lambda: RsellMatrix.from_dense(dense),
           }[kind]()
    p = str(tmp_path / f"{kind}.npz")
    io.save(p, fmt)
    fmt2 = io.load(p)
    np.testing.assert_array_equal(fmt2.to_dense(), dense)
    x = generators.random_sparse_vector(dense.shape[0], density=0.5, seed=9)
    from tests.conftest import assert_close
    from tpusparse.testing import reference as _ref
    assert_close(fmt2.spmv(x), _ref.sgemv_cpu(x, dense),
                 name=f"loaded-{kind}")


def test_sell_from_csr_matches_from_dense():
    from tpusparse.formats.csr import CsrMatrix
    from tpusparse.formats.sell import SellMatrix

    a = generators.random_sparse_matrix(300, 260, density=0.3, seed=51)
    s1 = SellMatrix.from_dense(a)
    s2 = SellMatrix.from_csr(CsrMatrix.from_dense(a))
    np.testing.assert_array_equal(np.asarray(s1.vals), np.asarray(s2.vals))
    np.testing.assert_array_equal(np.asarray(s1.idx), np.asarray(s2.idx))
    assert s1.w == s2.w and s1.padded == s2.padded
    np.testing.assert_array_equal(s2.to_dense(), a)


def test_sell_from_csr_spmv_large_sparse():
    """Ingestion path for matrices never materialized densely."""
    from tpusparse.formats.csr import CsrMatrix
    from tpusparse.formats.sell import SellMatrix
    from tests.conftest import assert_close

    rng = np.random.default_rng(52)
    m = n = 2048
    nnz = 20000
    rows = rng.integers(0, m, nnz)
    cols = rng.integers(0, n, nnz)
    vals = rng.uniform(-1, 1, nnz).astype(np.float32)
    # dedupe coordinates (CSR ingest sums duplicates ambiguously otherwise)
    flat = rows * n + cols
    _, keep = np.unique(flat, return_index=True)
    rows, cols, vals = rows[keep], cols[keep], vals[keep]
    csr = CsrMatrix.from_coo(m, n, rows, cols, vals)
    s = SellMatrix.from_csr(csr)
    x = generators.random_sparse_vector(m, density=0.5, seed=53)
    a = np.zeros((m, n), np.float32)
    a[rows, cols] = vals
    assert_close(s.spmv(x), reference.sgemv_cpu(x, a), name="sell_from_csr")


def test_awsp_from_csr():
    from tpusparse.formats.awsp import AwspMatrix
    from tpusparse.formats.csr import CsrMatrix

    a = generators.random_sparse_matrix(300, 260, density=0.3, seed=54)
    w1 = AwspMatrix.from_dense(a, g=2)
    w2 = AwspMatrix.from_csr(CsrMatrix.from_dense(a), g=2)
    np.testing.assert_array_equal(np.asarray(w1.vals), np.asarray(w2.vals))
    np.testing.assert_array_equal(w2.to_dense(), a)


def test_csr_to_dense_sums_duplicates():
    """Duplicates must sum on every route (kernels already sum)."""
    c = CsrMatrix.from_coo(8, 8, rows=[0, 0, 5], cols=[3, 3, 7],
                           values=np.array([1.0, 2.0, 4.0], np.float32))
    assert c.to_dense()[0, 3] == 3.0
    from tpusparse.formats.sell import SellMatrix

    e0 = np.zeros(8, np.float32)
    e0[0] = 1.0
    y = np.asarray(SellMatrix.from_csr(c).spmv(e0))
    assert y[3] == 3.0


def test_sell_from_csr_unsorted_rows():
    """Legal CSR does not guarantee sorted col_idx within a row."""
    from tpusparse.formats.sell import SellMatrix

    c = CsrMatrix(shape=(256, 2),
                  row_ptr=np.array([0, 3, 3], np.int32),
                  col_idx=np.array([5, 130, 7], np.int32),
                  values=np.array([1.0, 2.0, 3.0], np.float32))
    d = SellMatrix.from_csr(c).to_dense()
    assert d[5, 0] == 1.0 and d[130, 0] == 2.0 and d[7, 0] == 3.0


def test_load_leaf_count_guard(tmp_path):
    from tpusparse.formats import io
    from tpusparse.formats.sell import SellMatrix

    a = generators.random_sparse_matrix(128, 128, density=0.3, seed=99)
    p = str(tmp_path / "x.npz")
    io.save(p, SellMatrix.from_dense(a))
    z = dict(np.load(p, allow_pickle=False))
    z["leaf2"] = np.zeros(3)                  # simulate layout drift
    np.savez_compressed(p, **z)
    with pytest.raises(ValueError, match="leaves"):
        io.load(p)


def test_load_dict_meta_guard(tmp_path):
    # pre-r2 files stored meta as a dict repr; tree_unflatten would unpack
    # its KEYS positionally and silently build a corrupt object
    from tpusparse.formats import io
    from tpusparse.formats.sell import SellMatrix

    a = generators.random_sparse_matrix(128, 128, density=0.3, seed=97)
    p = str(tmp_path / "oldmeta.npz")
    io.save(p, SellMatrix.from_dense(a))
    z = dict(np.load(p, allow_pickle=False))
    z["meta"] = np.asarray(repr({"shape": (128, 128), "w": 8}))
    np.savez_compressed(p, **z)
    with pytest.raises(ValueError, match="re-pack"):
        io.load(p)


def test_save_load_bf16(tmp_path):
    import jax.numpy as jnp

    from tpusparse.formats import io
    from tpusparse.formats.sell import SellMatrix
    from tests.conftest import assert_close
    from tpusparse.testing import reference as _ref

    a = generators.random_sparse_matrix(256, 256, density=0.3, seed=98)
    p = str(tmp_path / "bf16.npz")
    io.save(p, SellMatrix.from_dense(a, dtype=jnp.bfloat16))
    s2 = io.load(p)
    assert str(np.asarray(s2.vals).dtype) == "bfloat16"
    x = generators.random_sparse_vector(256, density=0.5, seed=98)
    assert_close(s2.spmv(x), _ref.sgemv_cpu(x, a), atol=5e-2,
                 name="loaded-bf16")


def test_scipy_interop():
    sparse = pytest.importorskip("scipy.sparse")
    from tests.conftest import assert_close
    from tpusparse.formats.sell import SellMatrix
    from tpusparse.testing import reference as _ref

    a = generators.random_sparse_matrix(300, 200, density=0.2, seed=97)
    sp = sparse.csr_matrix(a)                 # scipy CSR of A itself
    c = CsrMatrix.from_scipy(sp)
    np.testing.assert_array_equal(c.to_dense(), a)
    np.testing.assert_array_equal(c.to_scipy().toarray(), a)
    x = generators.random_sparse_vector(300, density=0.5, seed=97)
    assert_close(SellMatrix.from_csr(c).spmv(x), _ref.sgemv_cpu(x, a),
                 name="scipy->sell")


def test_mtx_ingestion(tmp_path):
    from tpusparse.formats.csr import CsrMatrix

    p = tmp_path / "t.mtx"
    p.write_text("%%MatrixMarket matrix coordinate real general\n"
                 "3 4 5\n1 1 1.5\n2 3 -2.0\n3 4 0.25\n1 4 3.0\n3 1 7.0\n")
    c = CsrMatrix.from_mtx(str(p))
    want = np.zeros((3, 4), np.float64)
    want[0, 0], want[1, 2], want[2, 3], want[0, 3], want[2, 0] = \
        1.5, -2.0, 0.25, 3.0, 7.0
    np.testing.assert_array_equal(c.to_dense(), want)


def test_sell_int8_save_load(tmp_path, dense):
    from tpusparse.formats import io
    from tpusparse.formats.sell import SellMatrix
    from tests.conftest import assert_close
    from tpusparse.testing import reference as _ref

    s = SellMatrix.from_dense(dense, dtype="int8")
    p = str(tmp_path / "i8.npz")
    io.save(p, s)
    s2 = io.load(p)
    assert np.asarray(s2.vals).dtype == np.int8 and s2.scales is not None
    x = generators.random_sparse_vector(dense.shape[0], density=0.5, seed=9)
    assert_close(s2.spmv(x), _ref.sgemv_cpu(x, dense), atol=1e-1,
                 name="loaded-sell-int8")


def test_torch_interop():
    torch = pytest.importorskip("torch")
    a = generators.random_sparse_matrix(96, 160, density=0.2, seed=91)
    td = torch.from_numpy(a)
    # dense / COO / CSR / CSC all land on the same CsrMatrix
    c_dense = CsrMatrix.from_torch(td)
    np.testing.assert_array_equal(c_dense.to_dense(), a)
    for t in (td.to_sparse_coo(), td.to_sparse_csr(), td.to_sparse_csc()):
        c = CsrMatrix.from_torch(t)
        assert c.shape == (96, 160)
        np.testing.assert_array_equal(c.to_dense(), a)
    # round trip back to torch (sparse CSC of A) and through a kernel
    back = c_dense.to_torch()
    np.testing.assert_array_equal(back.to_dense().numpy(), a)
    from tests.conftest import assert_close
    from tpusparse.formats.sell import SellMatrix

    x = generators.random_sparse_vector(96, density=0.5, seed=92)
    assert_close(SellMatrix.from_csr(c_dense).spmv(x),
                 (np.asarray(x, np.float64) @ a.astype(np.float64)
                  ).astype(np.float32), name="torch->sell")
    with pytest.raises(ValueError, match="2-D"):
        CsrMatrix.from_torch(torch.zeros(3))
    # bf16/fp16 trained weights (numpy has no bridge for torch bf16;
    # review r2: this crashed) widen to fp32 on ingest — dense and sparse
    tb = td.to(torch.bfloat16)
    want = tb.float().numpy()
    np.testing.assert_array_equal(
        CsrMatrix.from_torch(tb).to_dense(), want)
    np.testing.assert_array_equal(
        CsrMatrix.from_torch(tb.to_sparse_coo()).to_dense(), want)
    np.testing.assert_array_equal(
        CsrMatrix.from_torch(td.to(torch.float16)).to_dense(),
        td.half().float().numpy())
