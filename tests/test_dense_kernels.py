"""Dense baseline vs the CPU oracle at the reference tolerance."""

import numpy as np

from tests.conftest import assert_close
from tpusparse.kernels.dense import dense_xla
from tpusparse.testing import generators, reference
from tpusparse.testing.tester import KernelEntry, SpmvTester
from tpusparse.config import SpmvConfig


def test_dense_xla(small_workload):
    a, x, y_ref = small_workload
    assert_close(dense_xla(a, x), y_ref, name="dense_xla")


def test_dense_spmm():
    a = generators.random_sparse_matrix(256, 256, density=0.5, seed=11)
    x = generators.random_sparse_batch(8, 256, density=0.5, seed=11)
    y_ref = reference.sgemm_cpu(x, a)
    assert_close(dense_xla(a, x), y_ref, name="dense_xla_spmm")


def test_tester_harness():
    cfg = SpmvConfig(m=256, n=256, kernels=("dense_xla",))
    t = SpmvTester(cfg)
    t.register(KernelEntry("dense_xla", prepare=lambda a: a,
                           run=lambda fmt, x: dense_xla(fmt, x)))
    from tpusparse.formats.sell import SellMatrix

    t.register(KernelEntry("sell", prepare=SellMatrix.from_dense,
                           run=lambda fmt, x: fmt.spmv(x)))
    reports = t.run(verbose=False)
    assert all(r.ok for r in reports)
    assert [r.name for r in reports] == ["dense_xla", "sell"]


def test_tester_catches_bad_kernel():
    cfg = SpmvConfig(m=256, n=256)
    t = SpmvTester(cfg)
    t.register(KernelEntry("broken", prepare=lambda a: a,
                           run=lambda fmt, x: dense_xla(fmt, x) + 1.0))
    reports = t.run(raise_on_fail=False, verbose=False)
    assert not reports[0].ok

    try:
        t.run(verbose=False)
    except AssertionError:
        pass
    else:
        raise AssertionError("tester.run should raise on mismatch")
