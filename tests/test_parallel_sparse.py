"""Sharded sparse SpMV/SpMM on the virtual 8-device CPU mesh."""

import jax
import numpy as np
import pytest

from tests.conftest import assert_close
from tpusparse.formats.sell import SellMatrix
from tpusparse.parallel.mesh import make_mesh
from tpusparse.parallel.sparse import (
    bsr_shard_pack,
    bsr_spmm_sharded,
    sell_spmm_sharded,
)
from tpusparse.testing import generators, reference


@pytest.fixture(scope="module")
def mesh8():
    return make_mesh({"n": 8}, jax.devices()[:8])


@pytest.fixture(scope="module")
def workload():
    a = generators.random_sparse_matrix(1024, 2048, density=0.3, seed=17)
    x = generators.random_sparse_vector(1024, density=0.5, seed=17)
    return a, x, reference.sgemv_cpu(x, a)


@pytest.mark.parametrize("partition", ["n", "m"])
def test_sell_sharded(mesh8, workload, partition):
    a, x, y_ref = workload
    s = SellMatrix.from_dense(a)
    assert_close(sell_spmm_sharded(s, x, mesh8, partition), y_ref,
                 name=f"sell_sharded[{partition}]")


def test_sell_sharded_2d(workload):
    a, x, _ = workload
    mesh2 = make_mesh({"b": 2, "n": 4}, jax.devices()[:8])
    xb = generators.random_sparse_batch(4, 1024, density=0.5, seed=3)
    s = SellMatrix.from_dense(a)
    assert_close(sell_spmm_sharded(s, xb, mesh2, "2d"),
                 reference.sgemm_cpu(xb, a), name="sell_sharded[2d]")


def test_bsr_sharded(mesh8, workload):
    a, x, y_ref = workload
    packed = bsr_shard_pack(a, 8, block_m=128)
    assert_close(bsr_spmm_sharded(packed, x, mesh8), y_ref,
                 name="bsr_sharded")


def test_bsr_sharded_spmm_uneven_blocks(mesh8):
    # concentrate blocks on one device so per-device padding is exercised
    a = generators.random_sparse_matrix(512, 2048, density=0.15, seed=9,
                                        distribution="blocks", block=128)
    a[:, :256] = 1.0  # device 0's groups fully dense
    xb = generators.random_sparse_batch(2, 512, density=0.5, seed=9)
    packed = bsr_shard_pack(a, 8, block_m=128)
    assert_close(bsr_spmm_sharded(packed, xb, mesh8),
                 reference.sgemm_cpu(xb, a), name="bsr_sharded_uneven")


def test_sell_sharded_indivisible_pads(mesh8, workload):
    # 15 groups over 8 devices: handled by automatic zero-group padding
    # (an earlier version raised ValueError here)
    a, x, _ = workload
    s = SellMatrix.from_dense(a[:, :1920])
    assert_close(sell_spmm_sharded(s, x, mesh8, "n"),
                 reference.sgemv_cpu(x, a[:, :1920]), name="sell_pad15")


def test_awsp_sharded_n():
    import numpy as np
    from tpusparse.formats.awsp import AwspMatrix
    from tpusparse.parallel import make_mesh
    from tpusparse.parallel.sparse import awsp_spmm_sharded
    from tpusparse.testing import generators, reference
    from tests.conftest import assert_close

    a = generators.random_sparse_matrix(512, 512, density=0.4, seed=41)
    x = generators.random_sparse_vector(512, density=0.5, seed=41).copy()
    x[256:] = 0                                   # dead half -> plan skips
    f = AwspMatrix.from_dense(a, g=1)
    mesh = make_mesh({"n": 4})
    y = awsp_spmm_sharded(f, x, mesh)
    assert_close(y, reference.sgemv_cpu(x, a), name="awsp_sharded_n")
    assert f.plan(x).size == 2                    # 2 of 4 windows live

    xb = generators.random_sparse_batch(4, 512, density=0.5, seed=42)
    yb = awsp_spmm_sharded(f, xb, mesh)
    assert_close(yb, reference.sgemm_cpu(xb, a), name="awsp_sharded_n_spmm")


def test_sell_sharded_ring():
    import numpy as np
    from tpusparse.formats.sell import SellMatrix
    from tpusparse.parallel import make_mesh
    from tpusparse.parallel.sparse import sell_spmm_sharded
    from tpusparse.testing import generators, reference
    from tests.conftest import assert_close

    a = generators.random_sparse_matrix(1024, 512, density=0.4, seed=43)
    x = generators.random_sparse_vector(1024, density=0.5, seed=43)
    s = SellMatrix.from_dense(a)
    mesh = make_mesh({"n": 4})
    y = sell_spmm_sharded(s, x, mesh, partition="ring")
    assert_close(y, reference.sgemv_cpu(x, a), name="sell_ring")

    xb = generators.random_sparse_batch(4, 1024, density=0.5, seed=44)
    yb = sell_spmm_sharded(s, xb, mesh, partition="ring")
    assert_close(yb, reference.sgemm_cpu(xb, a), name="sell_ring_spmm")


@pytest.mark.parametrize("partition", ["n", "m", "ring"])
def test_sell_sharded_non_divisible(mesh8, partition):
    """Divisibility is handled by automatic zero padding:
    nb=7 groups, nt=5 windows over 8 devices."""
    a = generators.random_sparse_matrix(640, 896, density=0.3, seed=41)
    x = generators.random_sparse_vector(640, density=0.5, seed=41)
    s = SellMatrix.from_dense(a)
    assert_close(sell_spmm_sharded(s, x, mesh8, partition),
                 reference.sgemv_cpu(x, a),
                 name=f"sell_sharded_nondiv[{partition}]")


def test_sell_sharded_2d_non_divisible():
    mesh2 = make_mesh({"b": 2, "n": 4}, jax.devices()[:8])
    a = generators.random_sparse_matrix(512, 640, density=0.3, seed=43)
    xb = generators.random_sparse_batch(3, 512, density=0.5, seed=43)
    s = SellMatrix.from_dense(a)
    assert_close(sell_spmm_sharded(s, xb, mesh2, "2d"),
                 reference.sgemm_cpu(xb, a), name="sell_2d_nondiv")


def test_bsr_sharded_non_divisible(mesh8):
    a = generators.random_sparse_matrix(512, 896, density=0.2, seed=45,
                                        distribution="blocks", block=128)
    x = generators.random_sparse_vector(512, density=0.5, seed=45)
    packed = bsr_shard_pack(a, 8, block_m=128)   # nb=7 over 8 shards
    assert_close(bsr_spmm_sharded(packed, x, mesh8),
                 reference.sgemv_cpu(x, a), name="bsr_nondiv")


def test_awsp_sharded_non_divisible(mesh8):
    from tpusparse.formats.awsp import AwspMatrix
    from tpusparse.parallel.sparse import awsp_spmm_sharded

    a = generators.random_sparse_matrix(512, 896, density=0.3, seed=47)
    x = generators.random_sparse_vector(512, density=0.5, seed=47)
    w = AwspMatrix.from_dense(a, g=2)
    assert_close(awsp_spmm_sharded(w, x, mesh8),
                 reference.sgemv_cpu(x, a), name="awsp_nondiv")


@pytest.mark.parametrize("partition", ["m", "ring"])
def test_awsp_sharded_m_ring(mesh8, partition):
    from tpusparse.formats.awsp import AwspMatrix
    from tpusparse.parallel.sparse import awsp_spmm_sharded

    a = generators.random_sparse_matrix(2048, 512, density=0.3, seed=51)
    x = generators.random_sparse_vector(2048, density=0.5, seed=51)
    w = AwspMatrix.from_dense(a, g=1)
    assert_close(awsp_spmm_sharded(w, x, mesh8, partition=partition),
                 reference.sgemv_cpu(x, a), name=f"awsp[{partition}]")


@pytest.mark.parametrize("partition", ["m", "ring"])
def test_awsp_sharded_structured_x(mesh8, partition):
    """Structured activations: only a band of X is live, so per-device
    plans are RAGGED (some slabs fully dead) — the zero-group padding and
    local-plan machinery are actually exercised."""
    from tpusparse.formats.awsp import AwspMatrix
    from tpusparse.parallel.sparse import awsp_spmm_sharded

    a = generators.random_sparse_matrix(2048, 512, density=0.3, seed=53)
    x = generators.random_sparse_vector(2048, density=0.5, seed=53)
    x[512:] = 0.0                      # live rows only in slabs 0-1
    w = AwspMatrix.from_dense(a, g=1)
    assert_close(awsp_spmm_sharded(w, x, mesh8, partition=partition),
                 reference.sgemv_cpu(x, a), name=f"awsp_struct[{partition}]")


@pytest.mark.parametrize("partition", ["m", "ring"])
def test_bsr_sharded_m_ring(mesh8, partition):
    from tpusparse.parallel.sparse import bsr_shard_pack, bsr_spmm_sharded

    a = generators.random_sparse_matrix(1152, 896, density=0.2, seed=55,
                                        distribution="blocks", block=128)
    x = generators.random_sparse_vector(1152, density=0.5, seed=55)
    packed = bsr_shard_pack(a, 8, block_m=128, partition=partition)
    assert_close(bsr_spmm_sharded(packed, x, mesh8),
                 reference.sgemv_cpu(x, a), name=f"bsr[{partition}]")


def test_bsr_sharded_2d_spmm():
    from tpusparse.parallel.sparse import bsr_shard_pack, bsr_spmm_sharded

    mesh2 = make_mesh({"b": 2, "n": 4}, jax.devices()[:8])
    a = generators.random_sparse_matrix(512, 1024, density=0.2, seed=57,
                                        distribution="blocks", block=128)
    xb = generators.random_sparse_batch(3, 512, density=0.5, seed=57)
    packed = bsr_shard_pack(a, 4, block_m=128)
    assert_close(bsr_spmm_sharded(packed, xb, mesh2),
                 reference.sgemm_cpu(xb, a), name="bsr[2d]")


def test_binned_sharded_n(mesh8):
    from tpusparse.formats.binned import BinnedSellMatrix
    from tpusparse.parallel.sparse import binned_spmm_sharded

    a = generators.random_sparse_matrix(1024, 1408, density=0.2, seed=59,
                                        distribution="powerlaw")  # nb=11
    x = generators.random_sparse_vector(1024, density=0.5, seed=59)
    bm = BinnedSellMatrix.from_dense(a)
    assert len(bm.widths) >= 2          # a real multi-bucket case
    assert_close(binned_spmm_sharded(bm, x, mesh8),
                 reference.sgemv_cpu(x, a), name="binned[n]")


def test_awsp_prepacked_slabs(mesh8):
    """Serving-loop path: slabs built once, reused across calls."""
    from tpusparse.formats.awsp import AwspMatrix
    from tpusparse.parallel.sparse import awsp_shard_slabs, awsp_spmm_sharded

    a = generators.random_sparse_matrix(2048, 512, density=0.3, seed=61)
    w = AwspMatrix.from_dense(a, g=1)
    slabs = awsp_shard_slabs(w, 8, "m")
    for seed in (61, 62):
        x = generators.random_sparse_vector(2048, density=0.5, seed=seed)
        assert_close(awsp_spmm_sharded(w, x, mesh8, partition="m",
                                       slabs=slabs),
                     reference.sgemv_cpu(x, a), name=f"awsp slabs {seed}")


def test_tcsr_sharded(mesh8, monkeypatch):
    """Both TCSR tiers sharded by output groups (nb=7: non-divisible).
    The measured tier-split penalty (tcsr._TIER_SPLIT_BYTES) folds a
    sub-MB matrix to one tier in production; zero it here to exercise the
    sharded mixed-tier path."""
    import tpusparse.formats.tcsr as tcsr_mod
    from tpusparse.parallel.sparse import tcsr_shard_pack, tcsr_spmm_sharded

    monkeypatch.setattr(tcsr_mod, "_TIER_SPLIT_BYTES", 0)
    rng = np.random.default_rng(71)
    a = np.zeros((512, 896), np.float32)                 # nb=7 over 8 devs
    for g in range(7):                                   # per group: 2 dense
        for k, fill in ((0, 0.97), (1, 0.97), (2, 0.08), (3, 0.08)):
            bi = (g + k) % 4                             # + 2 sparse tiles
            tile = rng.uniform(0.1, 1, (128, 128)) * \
                (rng.random((128, 128)) < fill)
            a[bi * 128:(bi + 1) * 128, g * 128:(g + 1) * 128] = tile
    packed = tcsr_shard_pack(a, 8)
    assert "vals" in packed and "blocks" in packed       # both tiers live
    x = generators.random_sparse_vector(512, density=0.5, seed=71)
    assert_close(tcsr_spmm_sharded(packed, x, mesh8),
                 reference.sgemv_cpu(x, a), name="tcsr_sharded")
    xb = generators.random_sparse_batch(3, 512, density=0.5, seed=72)
    assert_close(tcsr_spmm_sharded(packed, xb, mesh8),
                 reference.sgemm_cpu(xb, a), name="tcsr_sharded_spmm")


def test_tcsr_sharded_from_csr(mesh8):
    from tpusparse.formats.csr import CsrMatrix
    from tpusparse.parallel.sparse import tcsr_shard_pack, tcsr_spmm_sharded

    a = generators.random_sparse_matrix(512, 1024, density=0.2, seed=73,
                                        distribution="blocks", block=128)
    packed = tcsr_shard_pack(CsrMatrix.from_dense(a), 8)
    x = generators.random_sparse_vector(512, density=0.5, seed=73)
    assert_close(tcsr_spmm_sharded(packed, x, mesh8),
                 reference.sgemv_cpu(x, a), name="tcsr_sharded_csr")


@pytest.mark.parametrize("partition", ["n", "m", "ring"])
def test_sell_sharded_int8_scales(mesh8, workload, partition):
    """int8 value storage shards: scales ride the column-group axis (or
    replicate for contraction shards); dequant commutes with the psum."""
    a, x, _ = workload
    s = SellMatrix.from_dense(a, dtype="int8")
    assert s.scales is not None
    y_single = np.asarray(s.spmv(x))          # int8 quantization is the
    y = sell_spmm_sharded(s, x, mesh8, partition)  # same on 1 or D chips
    assert_close(y, y_single, atol=5e-3,
                 name=f"sell_sharded_int8[{partition}]")


def test_sell_sharded_int8_scales_2d(workload):
    a, _, _ = workload
    mesh2 = make_mesh({"b": 2, "n": 4}, jax.devices()[:8])
    xb = generators.random_sparse_batch(4, 1024, density=0.5, seed=3)
    s = SellMatrix.from_dense(a, dtype="int8")
    y_single = np.asarray(s.spmm(xb))
    assert_close(sell_spmm_sharded(s, xb, mesh2, "2d"), y_single,
                 atol=5e-3, name="sell_sharded_int8[2d]")
