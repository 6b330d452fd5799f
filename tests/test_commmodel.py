"""The chip-to-chip comm model's assumptions vs the actually-lowered programs.

The model (bench/commmodel.py) is analytic; what it must not be is
fictional: each partition's claimed collective kind is asserted against the
StableHLO the sharded SpMV actually lowers to on the 8-device mesh, and the
byte formulas are checked for internal consistency."""

import jax
import numpy as np
import pytest

from tpusparse.bench.commmodel import comm_model, report
from tpusparse.parallel import make_mesh, spmv_sharded
from tpusparse.parallel.sparse import sell_spmm_sharded
from tpusparse.formats.sell import SellMatrix
from tpusparse.testing import generators

_OPS = {"all-reduce": "all_reduce", "collective-permute": "collective_permute"}


@pytest.fixture(scope="module")
def mesh8():
    return make_mesh({"n": 8}, jax.devices()[:8])


def _lowered_text(fn, *args):
    return jax.jit(fn).lower(*args).as_text()


@pytest.mark.parametrize("partition", ["n", "m", "ring"])
def test_model_collectives_match_lowered_dense(mesh8, partition):
    a = generators.random_sparse_matrix(1024, 1024, density=0.5, seed=1)
    x = generators.random_sparse_vector(1024, density=0.5, seed=1)
    txt = _lowered_text(
        lambda aa, xx: spmv_sharded(aa, xx, mesh=mesh8, partition=partition),
        a, x)
    e = comm_model(partition, m=1024, n=1024, n_devices=8)
    for kind, op in _OPS.items():
        if kind in e.collectives:
            assert op in txt, f"{partition}: model claims {kind}, not lowered"
        else:
            assert op not in txt, \
                f"{partition}: lowered {op} the model does not account for"


@pytest.mark.parametrize("partition", ["n", "m", "ring"])
def test_model_collectives_match_lowered_sell(mesh8, partition):
    a = generators.random_sparse_matrix(1024, 1024, density=0.5, seed=2)
    x = generators.random_sparse_vector(1024, density=0.5, seed=2)
    s = SellMatrix.from_dense(a)
    txt = _lowered_text(
        lambda idx, vals, xx: sell_spmm_sharded(
            SellMatrix(idx, vals, s.shape, s.padded, s.w, s.nnz),
            xx, mesh8, partition),
        np.asarray(s.idx), np.asarray(s.vals), x)
    e = comm_model(partition, m=1024, n=1024, n_devices=8,
                   format_bytes=s.device_bytes())
    for kind, op in _OPS.items():
        if kind in e.collectives:
            assert op in txt
        else:
            assert op not in txt


def test_model_numbers():
    # n: perfect; m: comm does not shrink with D (full-width psum); ring:
    # overlapped — efficient once per-band compute >= chunk transfer
    en = comm_model("n", m=4096, n=4096, n_devices=8)
    assert en.efficiency == 1.0 and en.link_bytes == 0
    em = comm_model("m", m=4096, n=4096, n_devices=8)
    assert em.link_bytes == int(2 * 7 / 8 * 4096 * 4)
    assert 0 < em.efficiency < 1
    er = comm_model("ring", m=4096, n=4096, n_devices=8)
    assert er.link_bytes == 7 * 4096 * 4
    # 64 MB slab / 3350 GB/s / 8 bands = 2.5 us/band vs 16 KB chunk at
    # 450 GB/s = 0.04 us: fully overlapped -> ~100%
    assert er.efficiency > 0.95
    # batched ring eventually becomes comm-bound
    er_b = comm_model("ring", m=4096, n=4096, batch=512, n_devices=8)
    assert er_b.efficiency < er.efficiency


def test_report_renders():
    txt = report(device_counts=(2, 8))
    assert "weak efficiency" in txt and "D=  8" in txt


def test_train_model_collectives_match_lowered(mesh8):
    """The sharded training step must lower to exactly the collectives the
    train model charges: one all-reduce family (the dx psum) and NO
    collective-permute (both value-gradient kernels are comm-free)."""
    from tpusparse.autodiff import trainable_linear_sharded
    from tpusparse.bench.commmodel import train_model
    from tpusparse.formats.csr import CsrMatrix

    a = generators.random_sparse_matrix(1024, 1024, density=0.3, seed=5)
    apply, params, _, _ = trainable_linear_sharded(
        CsrMatrix.from_dense(a), mesh8)
    x = generators.random_sparse_vector(1024, density=0.5, seed=5)

    def step(p, xx):
        import jax.numpy as jnp

        dp, dx = jax.grad(lambda pp, v: jnp.sum(apply(pp, v) ** 2),
                          argnums=(0, 1))(p, xx)
        return dp, dx

    txt = _lowered_text(step, params, np.asarray(x, np.float32))
    e = train_model(m=1024, n=1024, n_devices=8)
    assert "all-reduce" in e.collectives
    assert "all_reduce" in txt
    assert "collective_permute" not in txt


def test_train_model_efficiency_shape():
    from tpusparse.bench.commmodel import train_model

    e2 = train_model(m=4096, n=4096, n_devices=2, format_bytes=60_000_000)
    e16 = train_model(m=4096, n=4096, n_devices=16, format_bytes=60_000_000)
    # comm is one small activation all-reduce against 4 format passes of
    # compute: efficiency stays high and degrades slowly with D
    assert e2.efficiency > 0.95 and e16.efficiency > 0.9
    assert e16.link_bytes > e2.link_bytes


def test_model_collectives_match_lowered_dia(mesh8):
    from tpusparse.formats.dia import DiaMatrix
    from tpusparse.parallel.sparse import dia_spmm_sharded

    a = generators.random_sparse_matrix(1024, 1024, density=0.5, seed=3)
    band = np.tril(np.triu(a, -3), 5)
    dm = DiaMatrix.from_dense(band)
    x = generators.random_sparse_vector(1024, density=0.5, seed=3)
    txt = _lowered_text(
        lambda vals, xx: dia_spmm_sharded(
            DiaMatrix(dm.offsets, vals, dm.shape, dm.nnz), xx, mesh8,
            "halo"),
        np.asarray(dm.vals), x)
    hl = max(0, -min(dm.offsets))
    hr = max(0, max(dm.offsets))
    e = comm_model("halo", m=1024, n=1024, n_devices=8,
                   format_bytes=dm.device_bytes(), halo=hl + hr)
    for kind, op in _OPS.items():
        if kind in e.collectives:
            assert op in txt
        else:
            assert op not in txt
    # halo link bytes are D- and slab-independent, tiny vs the slab
    assert e.link_bytes == (hl + hr) * 4
    assert e.efficiency > 0.99


def test_model_collectives_match_lowered_dia_sym(mesh8):
    # symmetric storage: ONE extra ppermute ships the k_half x dmax vals
    # edge strip (parallel/sparse.py mirror_local); collective kind is
    # unchanged and the modeled link bytes stay bandwidth-proportional
    from tpusparse.formats.dia import DiaMatrix
    from tpusparse.parallel.sparse import dia_spmm_sharded

    rng = np.random.default_rng(4)
    n = 1024
    a = np.zeros((n, n), dtype=np.float32)
    ii, jj = np.indices(a.shape)
    for off in (0, 1, 3):
        band = (ii - jj) == off
        a[band] = rng.normal(size=int(band.sum())).astype(np.float32)
    a = a + np.tril(a, -1).T
    dm = DiaMatrix.from_dense(a)
    assert dm.sym
    x = generators.random_sparse_vector(n, density=0.5, seed=4)
    txt = _lowered_text(
        lambda vals, xx: dia_spmm_sharded(
            DiaMatrix(dm.offsets, vals, dm.shape, dm.nnz, sym=True),
            xx, mesh8, "halo"),
        np.asarray(dm.vals), x)
    assert "collective_permute" in txt and "all_reduce" not in txt
    dmax = max(dm.offsets)
    e = comm_model("halo", m=n, n=n, n_devices=8,
                   format_bytes=dm.device_bytes(), halo=2 * dmax,
                   vals_halo=len(dm.offsets) * dmax)
    assert e.link_bytes == (2 * dmax + len(dm.offsets) * dmax) * 4
    assert e.efficiency > 0.95   # toy 12 KB operator; grows with the slab
