"""TCSR two-tier format: intra-block compression parity with the reference's
TCSRMatrix (tcsr.cpp:13-34) — bytes ∝ in-block nnz on partially-filled
blocks."""

import numpy as np
import pytest

from tests.conftest import assert_close
from tpusparse.formats.csr import CsrMatrix
from tpusparse.formats.tcsr import TcsrMatrix, _tier_cutoff
from tpusparse.testing import generators, reference

_LANES = 128


def _blocks_matrix(fill: float, seed: int = 0, m: int = 512, n: int = 512):
    """Block-structured support (128x128 tiles, ~35% kept) with the KEPT
    tiles only `fill`-dense inside — the TCSR showcase the reference's
    intra-block compaction targets."""
    rng = np.random.default_rng(seed)
    keep = rng.random((m // _LANES, n // _LANES)) < 0.35
    keep.flat[0] = True
    mask = np.kron(keep, np.ones((_LANES, _LANES), bool))
    mask &= rng.random((m, n)) < fill
    a = rng.uniform(-1, 1, (m, n)) * mask
    a = np.where(mask & (a == 0), 1e-3, a).astype(np.float32)
    return a


@pytest.mark.parametrize("dist,density", [
    ("uniform", 0.3), ("powerlaw", 0.15), ("blocks", 0.2), ("banded", 0.1)])
def test_tcsr_round_trip(dist, density):
    a = generators.random_sparse_matrix(384, 256, density=density, seed=13,
                                        distribution=dist)
    f = TcsrMatrix.from_dense(a)
    np.testing.assert_array_equal(f.to_dense(), a)
    f_csr = TcsrMatrix.from_csr(CsrMatrix.from_dense(a))
    np.testing.assert_array_equal(f_csr.to_dense(), a)


@pytest.mark.parametrize("fill", [0.3, 0.5])
def test_tcsr_spmv_and_bytes(fill):
    """The r1 'done' gate: on block-structured matrices at 30-50% in-block
    fill, stored bytes track in-block nnz (dense BSR tiles pay 1/fill x)."""
    from tpusparse.formats.bsr import BsrMatrix

    a = _blocks_matrix(fill, seed=3)
    f = TcsrMatrix.from_dense(a)
    bsr = BsrMatrix.from_dense(a)
    x = generators.random_sparse_vector(512, density=0.5, seed=3)
    assert_close(f.spmv(x), reference.sgemv_cpu(x, a), name=f"tcsr f={fill}")
    # bytes ∝ in-block nnz: vs dense tiles expect ~(5/4)*fill with W-padding
    ratio = f.device_bytes() / bsr.device_bytes()
    assert ratio < 1.25 * fill * 5 / 4 + 0.15, ratio
    assert f.n_sell > 0 and f.n_dense == 0       # fills this low never go dense


def test_tcsr_two_tier_split(monkeypatch):
    """Mixed fills: near-dense tiles take the dense tier, sparse ones SELL.

    The measured split penalty (running both tier kernels costs ~15 us of
    alternating-dispatch overhead, tcsr._TIER_SPLIT_BYTES) means a 2 MB
    matrix can never BUY a split — so this test zeroes the penalty to
    exercise the mixed-tier pack/kernel mechanics, and
    ``test_tcsr_marginal_split_folds`` asserts the production behavior."""
    import tpusparse.formats.tcsr as tcsr_mod

    monkeypatch.setattr(tcsr_mod, "_TIER_SPLIT_BYTES", 0)
    rng = np.random.default_rng(7)
    m, n = 512, 1024
    a = np.zeros((m, n), np.float32)
    n_dense_tiles = n_sell_tiles = 0
    for g in range(8):                       # every output group gets a mix
        for k, fill in ((0, 0.97), (1, 0.97), (2, 0.08), (3, 0.08)):
            bi = (g + k) % 4
            tile = rng.uniform(0.1, 1, (128, 128)) * \
                (rng.random((128, 128)) < fill)
            a[bi * 128:(bi + 1) * 128, g * 128:(g + 1) * 128] = tile
            if fill > 0.5:
                n_dense_tiles += 1
            else:
                n_sell_tiles += 1
    f = TcsrMatrix.from_dense(a)
    assert f.n_dense == n_dense_tiles, (f.n_dense, n_dense_tiles)
    assert f.n_sell == n_sell_tiles, (f.n_sell, n_sell_tiles)
    x = generators.random_sparse_vector(m, density=0.5, seed=7)
    assert_close(f.spmv(x), reference.sgemv_cpu(x, a), name="tcsr two-tier")
    np.testing.assert_array_equal(f.to_dense(), a)


def test_tcsr_marginal_split_folds():
    """The r3 gallery misroute: blockpruned tiles (50% fill, w_b 72-88)
    split 261 sell + 57 dense to save 0.8 MB of traffic, but the split
    itself measured +15 us (37-42 vs 23 us either single tier) — a 104%
    regret vs BSR. With the measured split charge the pack folds to one
    tier unless the split saves real megabytes."""
    a = generators.block_pruned_matrix(1024, 1024, block=128, keep_frac=0.3,
                                       fill=0.5, seed=5)
    f = TcsrMatrix.from_dense(a)
    assert (f.n_sell == 0) != (f.n_dense == 0), (f.n_sell, f.n_dense)
    x = generators.random_sparse_vector(1024, density=0.5, seed=5)
    assert_close(f.spmv(x), reference.sgemv_cpu(x, a), name="tcsr folded")


def test_tcsr_expect_batch_moves_cutoff():
    """Batched SpMM pays the gather floor per batch column, so the same
    matrix tips toward dense tiles as expect_batch grows."""
    a = _blocks_matrix(0.4, seed=5)
    f1 = TcsrMatrix.from_dense(a, expect_batch=1)
    f8 = TcsrMatrix.from_dense(a, expect_batch=8)
    assert f8.n_dense >= f1.n_dense
    assert f8.n_dense > 0                      # 0.4*128 ≈ 51 > 120/8 slots
    xb = generators.random_sparse_batch(4, 512, density=0.5, seed=5)
    y = f8.spmm(xb)
    y_ref = np.stack([reference.sgemv_cpu(xb[i], a) for i in range(4)])
    assert_close(y, y_ref, name="tcsr spmm b=4")


def test_tcsr_spmm_batched():
    a = generators.random_sparse_matrix(384, 384, density=0.15, seed=9,
                                        distribution="blocks")
    f = TcsrMatrix.from_dense(a)
    xb = generators.random_sparse_batch(8, 384, density=0.5, seed=9)
    y_ref = np.stack([reference.sgemv_cpu(xb[i], a) for i in range(8)])
    assert_close(f.spmm(xb), y_ref, name="tcsr spmm b=8")


def test_tcsr_empty_and_all_dense_edges():
    a = np.zeros((256, 256), np.float32)
    f = TcsrMatrix.from_dense(a)
    assert f.n_sell == 0 and f.n_dense == 0
    assert np.all(np.asarray(f.spmv(np.ones(256, np.float32))) == 0)

    d = generators.random_sparse_matrix(256, 256, density=0.9, seed=2)
    fd = TcsrMatrix.from_dense(d)
    assert fd.n_sell == 0 and fd.n_dense == 4   # w_b ~ 119 > 102 cutoff
    x = generators.random_sparse_vector(256, density=0.5, seed=2)
    assert_close(fd.spmv(x), reference.sgemv_cpu(x, d), name="tcsr all-dense")


def test_tier_cutoff_model():
    # all tiny -> all SELL at the max rounded width
    assert _tier_cutoff(np.array([3, 5, 8]), 1) == 8
    # all near-dense -> dense tier (5*W*128 > 65536 for W > 102)
    assert _tier_cutoff(np.array([120, 128]), 1) == 0
    # batch scales the gather cost: W=32 tiles flip dense at B=16
    assert _tier_cutoff(np.array([32]), 1) == 32
    assert _tier_cutoff(np.array([32]), 16) == 0
