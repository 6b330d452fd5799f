"""Multi-device SpMV on the virtual 8-device CPU mesh (SURVEY.md §4)."""

import jax
import numpy as np
import pytest

from tests.conftest import assert_close
from tpusparse.parallel import make_mesh, spmv_sharded
from tpusparse.testing import generators, reference


@pytest.fixture(scope="module")
def mesh8():
    assert len(jax.devices()) >= 8, "conftest must provide 8 CPU devices"
    return make_mesh({"n": 8}, jax.devices()[:8])


@pytest.fixture(scope="module")
def workload():
    a = generators.random_sparse_matrix(512, 1024, density=0.5, seed=5)
    x = generators.random_sparse_vector(512, density=0.5, seed=5)
    return a, x, reference.sgemv_cpu(x, a)


@pytest.mark.parametrize("partition", ["n", "m", "ring"])
def test_spmv_sharded(mesh8, workload, partition):
    a, x, y_ref = workload
    y = spmv_sharded(a, x, mesh=mesh8, partition=partition)
    assert_close(y, y_ref, name=f"spmv_sharded[{partition}]")


@pytest.mark.parametrize("partition", ["n", "m", "ring"])
def test_indivisible_pads(mesh8, partition):
    # r1 raised ValueError here; all partitions now auto-pad
    a = generators.random_sparse_matrix(516, 1020, density=0.5, seed=5)
    x = generators.random_sparse_vector(516, density=0.5, seed=5)
    y = spmv_sharded(a, x, mesh=mesh8, partition=partition)
    assert_close(y, reference.sgemv_cpu(x, a),
                 name=f"dense_pad[{partition}]")


def test_graft_dryrun():
    import __graft_entry__

    # 4 devices: same code paths, half the shard_map compile bill; the
    # driver separately runs the full 8-device dryrun every round
    __graft_entry__.dryrun_multichip(4)


def test_graft_entry_compiles():
    import __graft_entry__

    fn, args = __graft_entry__.entry()
    y = np.asarray(jax.jit(fn)(*args))
    fmt, x = args
    assert_close(y, reference.sgemv_cpu(np.asarray(x), fmt.to_dense()),
                 name="graft_entry")
