"""RSELL (ragged SELL, per-tile widths) + ragged sharding."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from tests.conftest import assert_close
from tpusparse.formats.csr import CsrMatrix
from tpusparse.formats.rsell import (RsellMatrix, rsell_shard_pack)
from tpusparse.parallel import make_mesh
from tpusparse.parallel.sparse import rsell_spmm_sharded
from tpusparse.testing import generators, reference


@pytest.mark.parametrize("dist,density", [
    ("uniform", 0.3), ("powerlaw", 0.2), ("blocks", 0.2), ("banded", 0.1)])
def test_rsell_round_trip_and_spmv(dist, density):
    a = generators.random_sparse_matrix(384, 256, density=density, seed=17,
                                        distribution=dist)
    f = RsellMatrix.from_dense(a)
    np.testing.assert_array_equal(f.to_dense(), a)
    x = generators.random_sparse_vector(384, density=0.5, seed=17)
    assert_close(f.spmv(x), reference.sgemv_cpu(x, a), name=f"rsell {dist}")


def test_rsell_spmm():
    a = generators.random_sparse_matrix(384, 384, density=0.15, seed=19,
                                        distribution="powerlaw")
    f = RsellMatrix.from_dense(a)
    xb = generators.random_sparse_batch(4, 384, density=0.5, seed=19)
    y_ref = np.stack([reference.sgemv_cpu(xb[i], a) for i in range(4)])
    assert_close(f.spmm(xb), y_ref, name="rsell spmm")


def test_rsell_bytes_beat_sell_and_binned_on_skew():
    from tpusparse.formats.binned import BinnedSellMatrix
    from tpusparse.formats.sell import SellMatrix

    a = generators.random_sparse_matrix(1024, 1024, density=0.15, seed=4,
                                        distribution="powerlaw")
    r = RsellMatrix.from_dense(a)
    s = SellMatrix.from_dense(a)
    b = BinnedSellMatrix.from_dense(a)
    assert r.device_bytes() < b.device_bytes() < s.device_bytes(), \
        (r.device_bytes(), b.device_bytes(), s.device_bytes())


def test_rsell_block_skip():
    a = generators.random_sparse_matrix(512, 512, density=0.1, seed=6,
                                        distribution="blocks")
    f = RsellMatrix.from_dense(a)
    # empty tiles emit no chunks: far fewer than the dense tile grid's
    # worst case of (nb * nt * w_max / 8)
    nb = nt = 4
    assert f.n_real < 0.7 * nb * nt * max(f.w_max, 8) / 8


def test_rsell_empty():
    f = RsellMatrix.from_dense(np.zeros((256, 256), np.float32))
    assert np.all(np.asarray(f.spmv(np.ones(256, np.float32))) == 0)


def test_rsell_sharded_ragged_gate():
    """The r1 'done' gate, verbatim workload: powerlaw d=0.25 sharded over
    8 virtual devices. 'sorted' assignment demonstrates the per-shard width
    spread; 'balance' shows the load-balance stat the repr carries."""
    m, n = 512, 640                   # nb=5: NOT divisible by 8 on purpose
    a = generators.random_sparse_matrix(m, n, density=0.25, seed=25,
                                        distribution="powerlaw")
    x = generators.random_sparse_vector(m, density=0.5, seed=25)
    y_ref = reference.sgemv_cpu(x, a)
    mesh = make_mesh({"n": 8})

    sh_sorted = rsell_shard_pack(a, 8, assignment="sorted")
    w = sh_sorted.w_shard
    assert w.max() >= 2 * max(int(w[w > 0].min()), 1), w  # width spread >=2x
    assert_close(rsell_spmm_sharded(sh_sorted, x, mesh), y_ref,
                 name="rsell sharded sorted")

    sh_bal = rsell_shard_pack(a, 8, assignment="balance")
    assert sh_bal.balance < sh_sorted.balance
    assert sh_bal.balance < 1.5, sh_bal
    assert "balance" in repr(sh_bal) and "w/shard" in repr(sh_bal)
    assert_close(rsell_spmm_sharded(sh_bal, x, mesh), y_ref,
                 name="rsell sharded balance")


def test_rsell_sharded_from_csr_no_densify():
    c = generators.random_sparse_csr(640, 640, density=0.05, seed=31)
    mesh = make_mesh({"n": 4})
    sh = rsell_shard_pack(c, 4)
    x = generators.random_sparse_vector(640, density=0.5, seed=31)
    y = np.asarray(rsell_spmm_sharded(sh, x, mesh))
    yd = np.zeros(640, np.float64)
    r = np.repeat(np.arange(640), c.row_nnz)
    np.add.at(yd, r, c.values.astype(np.float64) *
              x.astype(np.float64)[c.col_idx])
    assert_close(y, yd, name="rsell sharded csr")


def test_rsell_sharded_batch():
    a = generators.random_sparse_matrix(512, 384, density=0.2, seed=33,
                                        distribution="powerlaw")
    mesh = make_mesh({"n": 4}, jax.devices()[:4])
    # nb=3 < 4 devices: some shards own only empty columns
    sh = rsell_shard_pack(a, 4)
    xb = generators.random_sparse_batch(4, 512, density=0.5, seed=33)
    y_ref = np.stack([reference.sgemv_cpu(xb[i], a) for i in range(4)])
    assert_close(rsell_spmm_sharded(sh, xb, mesh), y_ref,
                 name="rsell sharded b=4")


def test_rsell_sharded_contiguous():
    """'contiguous' assignment: no demand sort, no output permutation
    (perm_plan is None — the unpermute plan's one-hot masks are O(n^2/128)
    bytes, which the sharded-AMG carrier cannot afford at level sizes)."""
    m, n = 512, 640
    a = generators.random_sparse_matrix(m, n, density=0.15, seed=77)
    x = generators.random_sparse_vector(m, density=0.5, seed=77)
    y_ref = reference.sgemv_cpu(x, a)
    mesh = make_mesh({"n": 8})
    sh = rsell_shard_pack(a, 8, assignment="contiguous")
    assert sh.perm_plan is None
    assert_close(rsell_spmm_sharded(sh, x, mesh), y_ref,
                 name="rsell sharded contiguous")
    # batch path slices the same way
    xb = generators.random_sparse_batch(3, m, density=0.5, seed=78)
    y_refb = np.stack([reference.sgemv_cpu(xb[i], a) for i in range(3)])
    assert_close(rsell_spmm_sharded(sh, xb, mesh), y_refb,
                 name="rsell sharded contiguous b=3")


def test_run_alignment_property_and_gate():
    """Run-aligned packs: when per-group padding stays under the 20% gate,
    every 8-chunk sub-block of the stream shares one cj, pad chunks carry
    the group's cj with zero vals, and the spmv matches the oracle. Packs
    whose group padding would exceed the gate (many 1-3 chunk groups)
    must REFUSE alignment and stay flat."""
    from tpusparse.formats.rsell import _RUN

    # dense-ish groups -> tiny pad fraction -> aligned
    a = generators.random_sparse_matrix(1024, 1024, density=0.3, seed=5,
                                        distribution="powerlaw")
    f = RsellMatrix.from_dense(a)
    assert f.run == _RUN, f.run
    cj = np.asarray(f.cj)
    assert cj.size % _RUN == 0
    blocks = cj.reshape(-1, _RUN)
    assert (blocks == blocks[:, :1]).all(), "run straddles groups"
    x = generators.random_sparse_vector(1024, density=0.5, seed=5)
    assert_close(f.spmv(x), reference.sgemv_cpu(x, a), name="rsell run=8")

    # many 1-3 chunk groups -> pad past the gate -> flat pack
    b = generators.random_sparse_matrix(256, 2048, density=0.01, seed=6)
    g = RsellMatrix.from_dense(b)
    assert g.run == 1, g.run
    xb = generators.random_sparse_vector(256, density=0.5, seed=6)
    assert_close(g.spmv(xb), reference.sgemv_cpu(xb, b), name="rsell run=1")


def test_run_alignment_legacy_aux_loads_flat():
    """Packs saved before the run field (5-entry aux) load as run=1."""
    a = generators.random_sparse_matrix(384, 256, density=0.2, seed=8)
    f = RsellMatrix.from_dense(a)
    leaves, aux = f.tree_flatten()
    legacy = RsellMatrix.tree_unflatten(tuple(aux)[:5], leaves)
    assert legacy.run == 1
    x = generators.random_sparse_vector(384, density=0.5, seed=8)
    assert_close(legacy.spmv(x), reference.sgemv_cpu(x, a),
                 name="rsell legacy aux")


def test_run_alignment_sharded_uniform():
    """Sharded packs carry one uniform run flag; aligned shard streams
    stay correct through the mesh path."""
    a = generators.random_sparse_matrix(768, 1024, density=0.3, seed=44,
                                        distribution="powerlaw")
    sh = rsell_shard_pack(a, 4, assignment="contiguous")
    assert sh.run in (1, 8)
    if sh.run == 8:
        for d in range(4):
            cjd = np.asarray(sh.cj[d]).reshape(-1, 8)
            # pad rows (all-zero vals) are exempt; real runs constant
            assert (cjd == cjd[:, :1]).all()
    mesh = make_mesh({"n": 4}, jax.devices()[:4])
    x = generators.random_sparse_vector(768, density=0.5, seed=44)
    assert_close(rsell_spmm_sharded(sh, x, mesh),
                 reference.sgemv_cpu(x, a), name="rsell sharded run")
