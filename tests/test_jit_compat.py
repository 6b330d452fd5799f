"""Every format's product works under jax.jit (formats are pytrees).

AWSP/ASP have host-side activation plans; under tracing they must fall back
to visiting everything rather than crashing (their docstrings promise this).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from tests.conftest import assert_close
from tpusparse.testing import generators, reference

_FMT = ["sell", "awsp", "bsr", "bsr_bm64", "binned", "ell", "asp", "tcsr",
        "tcsr_dense_tier", "rsell", "dia"]


def _pack(name, a):
    if name == "sell":
        from tpusparse.formats.sell import SellMatrix

        return SellMatrix.from_dense(a)
    if name == "awsp":
        from tpusparse.formats.awsp import AwspMatrix

        return AwspMatrix.from_dense(a, g=2)
    if name == "bsr":
        from tpusparse.formats.bsr import BsrMatrix

        return BsrMatrix.from_dense(a, block_m=128)
    if name == "bsr_bm64":
        from tpusparse.formats.bsr import BsrMatrix

        return BsrMatrix.from_dense(a, block_m=64)
    if name == "binned":
        from tpusparse.formats.binned import BinnedSellMatrix

        return BinnedSellMatrix.from_dense(a)
    if name == "ell":
        from tpusparse.formats.ell import EllMatrix

        return EllMatrix.from_dense(a)
    if name == "rsell":
        from tpusparse.formats.rsell import RsellMatrix

        return RsellMatrix.from_dense(a)
    if name == "dia":
        from tpusparse.formats.dia import DiaMatrix

        # a random matrix touches ~m+n diagonals; raise the cap — jit
        # compatibility is what is under test, not routing
        return DiaMatrix.from_dense(a, max_diags=1024)
    if name.startswith("tcsr"):
        from tpusparse.formats.tcsr import TcsrMatrix

        # expect_batch=32 forces the dense tier (nested BsrMatrix child)
        return TcsrMatrix.from_dense(
            a, expect_batch=32 if name.endswith("dense_tier") else 1)
    from tpusparse.kernels.asp_spmv import AspMatrix

    return AspMatrix.from_dense(a, block_n=128)


@pytest.mark.parametrize("fmt", _FMT)
def test_spmv_under_jit(fmt):
    a = generators.random_sparse_matrix(384, 256, density=0.3, seed=77)
    x = generators.random_sparse_vector(384, density=0.5, seed=77)
    f = _pack(fmt, a)

    @jax.jit
    def run(fmt_tree, xv):
        return fmt_tree.spmv(xv)

    y = run(f, jnp.asarray(x))
    assert_close(y, reference.sgemv_cpu(x, a), name=f"jit[{fmt}]")
    # second call with fresh leaves must hit the cache, not retrace-and-fail
    y2 = run(jax.tree_util.tree_map(np.asarray, f), jnp.asarray(x))
    assert_close(y2, reference.sgemv_cpu(x, a), name=f"jit[{fmt}] cached")


def test_awsp_dynamic_device_plan_under_jit():
    """Jitting over abstract activations takes the DEVICE-side
    dynamic-skip path (plan computed on device, padded with the zero
    group) — exact results for any activation pattern, one compile, no
    host round-trip. A precomputed static plan is still accepted and
    exact."""
    from tpusparse.formats.awsp import AwspMatrix

    a = generators.random_sparse_matrix(512, 256, density=0.3, seed=88)
    f = AwspMatrix.from_dense(a, g=1)

    @jax.jit
    def run(fmt, xv):
        return fmt.spmv(xv)

    x = generators.random_sparse_vector(512, density=0.5, seed=88).copy()
    patterns = [slice(128, 512), slice(0, 128), slice(0, 512)]
    for live in patterns:                     # distinct active counts,
        xi = np.zeros_like(x)                 # same jitted callable
        xi[live] = x[live] + 1e-3
        y = run(f, jnp.asarray(xi))
        assert_close(y, reference.sgemv_cpu(xi, a), name=f"awsp dyn {live}")
    y0 = run(f, jnp.zeros(512, jnp.float32))  # all-zero X: zero-group step
    np.testing.assert_allclose(np.asarray(y0), 0.0)

    # static precomputed plan: still exact under jit
    xs = np.zeros_like(x)
    xs[:128] = x[:128] + 1e-3
    plan = f.plan(xs)
    assert plan.size == 1                     # only 1 of 4 groups live

    @jax.jit
    def run_planned(fmt, xv):
        return fmt.spmv(xv, plan=plan)

    assert_close(run_planned(f, jnp.asarray(xs)), reference.sgemv_cpu(xs, a),
                 name="awsp planned jit")


def test_asp_dynamic_device_plan_under_jit():
    from tpusparse.kernels.asp_spmv import AspMatrix

    a = generators.random_sparse_matrix(512, 256, density=0.4, seed=89)
    f = AspMatrix.from_dense(a, block_n=128)

    @jax.jit
    def run(fmt, xv):
        return fmt.spmv(xv)

    x = generators.random_sparse_vector(512, density=0.5, seed=89).copy()
    for live in (slice(0, 128), slice(256, 512), slice(0, 512)):
        xi = np.zeros_like(x)
        xi[live] = x[live] + 1e-3
        y = run(f, jnp.asarray(xi))
        assert_close(y, reference.sgemv_cpu(xi, a), name=f"asp dyn {live}")
    np.testing.assert_allclose(np.asarray(run(f, jnp.zeros(512, jnp.float32))), 0.0)


def test_device_group_plan_compaction():
    from tpusparse.kernels.awsp_spmv import device_group_plan

    x = np.zeros((1, 8 * 128), np.float32)
    x[0, 3 * 128 + 5] = 1.0
    x[0, 6 * 128 + 7] = 2.0
    plan = device_group_plan(jnp.asarray(x), 8, 128)
    assert plan.shape == (8,)
    assert list(np.asarray(plan)[:2]) == [3, 6]
    assert (np.asarray(plan)[2:] == 8).all()    # tail points at zero group
    plan0 = device_group_plan(jnp.zeros((1, 8 * 128)), 8, 128)
    assert (np.asarray(plan0) == 8).all()


