"""Lanczos eigensolver (tpusparse/eig.py) vs numpy.linalg.eigh oracle."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpusparse.eig import eigsh, lanczos, spectrum_bounds
from tpusparse.formats.csr import CsrMatrix
from tpusparse.formats.sell import SellMatrix
from tpusparse.solve import cg, chebyshev_preconditioner


def _spd(n: int, seed: int = 3, cond: float = 50.0) -> np.ndarray:
    """Dense SPD with known spectrum spread and ~60% sparsity."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    lam = np.geomspace(1.0, cond, n)
    a = (q * lam) @ q.T
    return a.astype(np.float32)


@pytest.fixture(scope="module")
def spd256():
    a = _spd(256)
    return a, np.linalg.eigvalsh(a.astype(np.float64))


def test_lanczos_basis_orthonormal(spd256):
    a, _ = spd256
    t, v = lanczos(jnp.asarray(a).__matmul__, 24, n=256)
    g = np.asarray(v) @ np.asarray(v).T
    # 1e-4: fp32 CGS2 loses ~sqrt(n) ulps per vector; the projections run
    # at HIGHEST precision (eig._hdot), so a GPU's TF32 (~1e-3 per
    # product) never enters
    np.testing.assert_allclose(g, np.eye(24), atol=1e-4)
    # t is the projection V A Vt
    t_ref = np.asarray(v) @ a @ np.asarray(v).T
    np.testing.assert_allclose(np.asarray(t), t_ref, atol=1e-3)


def test_eigsh_extremal_values(spd256):
    a, lam = spd256
    s = SellMatrix.from_csr(CsrMatrix.from_dense(a))
    evals, evecs, resid = eigsh(s, k=3, which="LA", ncv=40)
    # extremal Ritz values converge fast; top value to ~1e-3 relative
    np.testing.assert_allclose(np.asarray(evals)[-1], lam[-1], rtol=2e-3)
    assert float(resid[-1]) < 1e-2 * lam[-1]
    # Ritz vector is an eigenvector: A v ~ lambda v
    v = np.asarray(evecs)[-1]
    av = a @ v
    np.testing.assert_allclose(av, float(evals[-1]) * v,
                               atol=2e-2 * lam[-1])


def test_eigsh_sa_and_be(spd256):
    a, lam = spd256
    op = jnp.asarray(a).__matmul__
    lo, _, _ = eigsh(op, k=2, which="SA", ncv=64, n=256)
    assert abs(float(lo[0]) - lam[0]) < 0.2 * lam[0]
    be, _, _ = eigsh(op, k=2, which="BE", ncv=64, n=256)
    assert float(be[0]) < float(be[-1])
    np.testing.assert_allclose(float(be[-1]), lam[-1], rtol=2e-3)


def test_eigsh_validation(spd256):
    a, _ = spd256
    op = jnp.asarray(a).__matmul__
    with pytest.raises(ValueError, match="which"):
        eigsh(op, which="LM", n=256)
    with pytest.raises(ValueError, match="k <= ncv"):
        eigsh(op, k=30, ncv=10, n=256)


def test_eigsh_jits(spd256):
    a, lam = spd256
    f = jax.jit(lambda m: eigsh(m.__matmul__, k=1, which="LA", ncv=24,
                                n=256, return_vectors=False)[0])
    evals = f(jnp.asarray(a))
    np.testing.assert_allclose(float(evals[0]), lam[-1], rtol=5e-3)


def test_spectrum_bounds_contain_and_drive_chebyshev():
    # 2-D Laplacian: spectrum known analytically in (0, 8)
    side = 16
    n = side * side
    a = np.zeros((n, n), np.float32)
    idx = np.arange(n).reshape(side, side)
    a[np.arange(n), np.arange(n)] = 4.0
    for (di, dj) in ((0, 1), (1, 0)):
        src = idx[: side - di, : side - dj].ravel()
        dst = idx[di:, dj:].ravel()
        a[src, dst] = -1.0
        a[dst, src] = -1.0
    lam = np.linalg.eigvalsh(a.astype(np.float64))
    s = SellMatrix.from_csr(CsrMatrix.from_dense(a))
    lmin, lmax = spectrum_bounds(s, ncv=48)
    assert float(lmin) <= lam[0] * 1.05 and float(lmax) >= lam[-1] * 0.999
    assert float(lmin) > 0.25 * lam[0]          # not a trivial lower bound
    # exact bounds make the Chebyshev-CG combo converge in very few iters
    rng = np.random.default_rng(5)
    b = rng.normal(size=n).astype(np.float32)
    m_inv = chebyshev_preconditioner(s, lmax, lmin=lmin, degree=8)
    z, info = cg(s, jnp.asarray(b), tol=1e-5, m_inv=m_inv)
    assert int(info["iters"]) <= 14
    np.testing.assert_allclose(np.asarray(s.spmv(z)), b, atol=1e-3)
