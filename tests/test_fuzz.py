"""Cross-format fuzz: random shapes/densities/distributions round-trip and
match the float64 oracle at the reference tolerance."""

import numpy as np
import pytest

from tests.conftest import assert_close
from tpusparse.testing import generators, reference

_FORMATS = ["sell", "awsp", "bsr", "ell", "rsell", "binned", "asp"]


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
    if name == "ell":
        from tpusparse.formats.ell import EllMatrix

        return EllMatrix.from_dense(a)
    if name == "rsell":
        from tpusparse.formats.rsell import RsellMatrix

        return RsellMatrix.from_dense(a)
    if name == "binned":
        from tpusparse.formats.binned import BinnedSellMatrix

        return BinnedSellMatrix.from_dense(a)
    from tpusparse.kernels.asp_spmv import AspMatrix

    return AspMatrix.from_dense(a, block_n=128)


def _cases(n_cases=6):
    rng = np.random.default_rng(2026)
    for _ in range(n_cases):
        m = int(rng.integers(1, 5)) * 64 + int(rng.integers(0, 64))
        n = int(rng.integers(1, 4)) * 64 + int(rng.integers(0, 64))
        density = float(rng.choice([0.05, 0.2, 0.5, 0.9]))
        dist = str(rng.choice(["uniform", "powerlaw", "banded", "blocks"]))
        seed = int(rng.integers(0, 10000))
        yield m, n, density, dist, seed


@pytest.mark.parametrize("fmt", _FORMATS)
def test_fuzz_spmv(fmt):
    for m, n, density, dist, seed in _cases():
        a = generators.random_sparse_matrix(m, n, density=density, seed=seed,
                                            distribution=dist)
        x = generators.random_sparse_vector(m, density=0.5, seed=seed + 1)
        f = _pack(fmt, a)
        label = f"{fmt}[{m}x{n} d={density} {dist} s={seed}]"
        assert_close(f.spmv(x), reference.sgemv_cpu(x, a), name=label)
        if hasattr(f, "to_dense"):
            np.testing.assert_allclose(f.to_dense(), a, atol=0,
                                       err_msg=label)


@pytest.mark.parametrize("fmt", ["sell", "awsp", "bsr", "asp"])
def test_fuzz_spmm(fmt):
    for m, n, density, dist, seed in list(_cases())[:3]:
        a = generators.random_sparse_matrix(m, n, density=density, seed=seed,
                                            distribution=dist)
        b = int(np.random.default_rng(seed).integers(2, 7))
        xb = generators.random_sparse_batch(b, m, density=0.5, seed=seed + 2)
        f = _pack(fmt, a)
        label = f"{fmt}-spmm[{m}x{n} B={b} d={density} {dist}]"
        assert_close(f.spmm(xb), reference.sgemm_cpu(xb, a), name=label)
