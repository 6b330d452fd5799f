"""Iterative solver (tpusparse/solve.py): CG over packed formats."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpusparse.formats.csr import CsrMatrix
from tpusparse.formats.sell import SellMatrix
from tpusparse.solve import cg, jacobi_preconditioner


def _laplacian_2d(side: int) -> np.ndarray:
    """SPD 5-point Laplacian on a side x side grid (classic CG workload)."""
    n = side * side
    a = np.zeros((n, n), dtype=np.float32)
    idx = np.arange(n).reshape(side, side)
    a[np.arange(n), np.arange(n)] = 4.0
    for (di, dj) in ((0, 1), (1, 0)):
        src = idx[: side - di, : side - dj].ravel()
        dst = idx[di:, dj:].ravel()
        a[src, dst] = -1.0
        a[dst, src] = -1.0
    return a


@pytest.fixture(scope="module")
def spd_system():
    a = _laplacian_2d(16)  # 256 x 256, density ~2%
    rng = np.random.default_rng(81)
    z_true = rng.normal(size=256).astype(np.float32)
    b = (a.astype(np.float64) @ z_true).astype(np.float32)
    return a, z_true, b


def test_cg_converges_on_sell(spd_system):
    a, z_true, b = spd_system
    s = SellMatrix.from_csr(CsrMatrix.from_dense(a))
    z, info = cg(s, jnp.asarray(b), tol=1e-5)
    assert float(info["resnorm"]) <= 1e-5 * np.linalg.norm(b) * 1.01
    np.testing.assert_allclose(np.asarray(z), z_true, atol=5e-3)
    assert 0 < int(info["iters"]) <= 256


def test_cg_jits_and_callable_operator(spd_system):
    a, z_true, b = spd_system
    s = SellMatrix.from_csr(CsrMatrix.from_dense(a))

    @jax.jit
    def solve(bb):
        z, info = cg(lambda v: s.spmv(v), bb, tol=1e-5, maxiter=400)
        return z, info["iters"]

    z, iters = solve(jnp.asarray(b))
    np.testing.assert_allclose(np.asarray(z), z_true, atol=5e-3)
    assert int(iters) <= 400


def test_cg_jacobi_preconditioner(spd_system):
    a, z_true, b = spd_system
    # scale rows/cols to create wild conditioning that Jacobi fixes
    d = np.exp(np.linspace(0, 4, 256)).astype(np.float32)
    a2 = (a * d[None, :]) * d[:, None]
    b2 = (a2.astype(np.float64) @ z_true).astype(np.float32)
    s = SellMatrix.from_csr(CsrMatrix.from_dense(a2))
    prec = jacobi_preconditioner(np.diag(a2))
    z_p, info_p = cg(s, jnp.asarray(b2), tol=1e-5, maxiter=2000, m_inv=prec)
    _z0, info_0 = cg(s, jnp.asarray(b2), tol=1e-5, maxiter=2000)
    # preconditioning must strictly reduce iterations on this system
    assert int(info_p["iters"]) < int(info_0["iters"])
    # fp32 CG on an ill-conditioned system: solution error scales with
    # condition number; check it is in the right neighborhood only
    np.testing.assert_allclose(np.asarray(z_p), z_true, rtol=5e-2,
                               atol=1e-2)


def test_cg_maxiter_and_validation(spd_system):
    a, _z, b = spd_system
    s = SellMatrix.from_csr(CsrMatrix.from_dense(a))
    _z, info = cg(s, jnp.asarray(b), tol=0.0, maxiter=5)
    assert int(info["iters"]) == 5
    with pytest.raises(ValueError, match="1-D"):
        cg(s, jnp.zeros((2, 256)))


def test_cg_over_sharded_spmv(spd_system):
    """CG composes with the multi-chip sharded SpMV (operator = a sharded
    closure over the 8-device mesh)."""
    from tpusparse.parallel.mesh import make_mesh
    from tpusparse.parallel.sparse import sell_spmm_sharded

    a, z_true, b = spd_system
    s = SellMatrix.from_csr(CsrMatrix.from_dense(a))
    mesh = make_mesh({"n": 8}, jax.devices()[:8])
    z, info = cg(lambda v: sell_spmm_sharded(s, v, mesh, "n"),
                 jnp.asarray(b), tol=1e-5, maxiter=400)
    np.testing.assert_allclose(np.asarray(z), z_true, atol=5e-3)
    assert int(info["iters"]) <= 400


def _convection_diffusion(side: int, c: float = 0.4) -> np.ndarray:
    """Nonsymmetric banded operator: 2-D Laplacian + upwind convection."""
    a = _laplacian_2d(side)
    n = side * side
    idx = np.arange(n).reshape(side, side)
    src = idx[:, : side - 1].ravel()
    a[src, src + 1] += -c          # downstream coupling only: asymmetric
    return a


def test_bicgstab_nonsymmetric_dia():
    """The system CG cannot solve; DIA packs S.T so spmv applies S."""
    from tpusparse.formats.dia import DiaMatrix
    from tpusparse.solve import bicgstab

    s_mat = _convection_diffusion(16)
    assert not np.allclose(s_mat, s_mat.T)
    fmt = DiaMatrix.from_dense(np.ascontiguousarray(s_mat.T))
    rng = np.random.default_rng(82)
    z_true = rng.normal(size=256).astype(np.float32)
    b = jnp.asarray((s_mat.astype(np.float64) @ z_true).astype(np.float32))
    # fp32 BiCGStab needs ~2x the fp64 scipy count (138) on this system
    z, info = bicgstab(fmt, b, tol=1e-6, maxiter=1000)
    np.testing.assert_allclose(np.asarray(z), z_true, atol=5e-3)
    assert int(info["iters"]) < 1000
    # jit-compatibility: the whole solve is one compiled while_loop
    z2, _ = jax.jit(lambda f, bb: bicgstab(f, bb, tol=1e-6,
                                           maxiter=1000))(fmt, b)
    np.testing.assert_allclose(np.asarray(z2), z_true, atol=5e-3)


def test_bicgstab_preconditioned_and_validation(spd_system):
    from tpusparse.solve import bicgstab

    a, z_true, b = spd_system
    s = SellMatrix.from_csr(CsrMatrix.from_dense(a))
    prec = jacobi_preconditioner(np.diag(a))
    z, info = bicgstab(s, jnp.asarray(b), tol=1e-6, m_inv=prec)
    np.testing.assert_allclose(np.asarray(z), z_true, atol=5e-3)
    zp, infop = bicgstab(s, jnp.asarray(b), tol=1e-6)
    assert int(info["iters"]) <= int(infop["iters"])
    with pytest.raises(ValueError, match="1-D"):
        bicgstab(s, jnp.zeros((2, 256)))


def test_bicgstab_maxiter(spd_system):
    from tpusparse.solve import bicgstab

    a, _z, b = spd_system
    s = SellMatrix.from_csr(CsrMatrix.from_dense(a))
    _, info = bicgstab(s, jnp.asarray(b), tol=0.0, maxiter=5)
    assert int(info["iters"]) == 5


def test_gmres_nonsymmetric_dia():
    """GMRES(60) on the convection-diffusion system. restart=30 stagnates
    here for scipy too (fp64 included) — restart length, not precision,
    gates convergence on convection-dominated operators."""
    from tpusparse.formats.dia import DiaMatrix
    from tpusparse.solve import gmres

    s_mat = _convection_diffusion(16)
    fmt = DiaMatrix.from_dense(np.ascontiguousarray(s_mat.T))
    rng = np.random.default_rng(83)
    z_true = rng.normal(size=256).astype(np.float32)
    b = jnp.asarray((s_mat.astype(np.float64) @ z_true).astype(np.float32))
    z, info = gmres(fmt, b, tol=1e-6, restart=60, maxiter=600)
    # 5e-3: a 1e-6 residual times the operator's conditioning; the CGS2
    # projections run at HIGHEST precision (solve._hdot), not TF32
    np.testing.assert_allclose(np.asarray(z), z_true, atol=5e-3)
    assert int(info["iters"]) < 600
    # jit-compatibility: whole solve traces into one while_loop
    z2, _ = jax.jit(lambda f, bb: gmres(f, bb, tol=1e-6, restart=60,
                                        maxiter=600))(fmt, b)
    np.testing.assert_allclose(np.asarray(z2), z_true, atol=5e-3)


def test_gmres_right_preconditioned(spd_system):
    """Right preconditioning reduces restart cycles and keeps the TRUE
    residual in info (the whole point of right vs left)."""
    from tpusparse.solve import gmres

    a, z_true, b = spd_system
    s = SellMatrix.from_csr(CsrMatrix.from_dense(a))
    prec = jacobi_preconditioner(np.diag(a) * 0.25 + 3.0)  # mild smoother
    z, info = gmres(s, jnp.asarray(b), tol=1e-6, restart=20, maxiter=400,
                    m_inv=prec)
    np.testing.assert_allclose(np.asarray(z), z_true, atol=5e-3)
    r = np.asarray(b) - a @ np.asarray(z)
    # info resnorm is the true residual (right preconditioning contract)
    np.testing.assert_allclose(float(info["resnorm"]), np.linalg.norm(r),
                               rtol=0.3, atol=1e-4)


def test_gmres_maxiter_and_validation(spd_system):
    from tpusparse.solve import gmres

    a, _z, b = spd_system
    s = SellMatrix.from_csr(CsrMatrix.from_dense(a))
    _, info = gmres(s, jnp.asarray(b), tol=0.0, restart=10, maxiter=20)
    assert int(info["iters"]) == 20  # two whole cycles
    with pytest.raises(ValueError, match="1-D"):
        gmres(s, jnp.zeros((2, 256)))


def test_chebyshev_preconditioned_cg(spd_system):
    """Chebyshev m_inv divides CG's iteration count (the dot-allreduce
    count at pod scale); power iteration supplies the spectrum bound."""
    from tpusparse.solve import chebyshev_preconditioner, estimate_lmax

    a, z_true, b = spd_system
    s = SellMatrix.from_csr(CsrMatrix.from_dense(a))
    lmax = estimate_lmax(s)
    # Laplacian lmax is 8(1 - O(h^2)); the 1.1 safety must contain it
    assert 7.0 <= float(lmax) <= 9.5
    _, info_plain = cg(s, jnp.asarray(b), tol=1e-6)
    prec = chebyshev_preconditioner(s, lmax, degree=8)
    z, info = cg(s, jnp.asarray(b), tol=1e-6, m_inv=prec)
    np.testing.assert_allclose(np.asarray(z), z_true, atol=5e-3)
    assert int(info["iters"]) * 2 < int(info_plain["iters"])
    # jit end-to-end (preconditioner is jit-compatible: static degree)
    z2, _ = jax.jit(lambda f, bb: cg(f, bb, tol=1e-6,
                                     m_inv=chebyshev_preconditioner(
                                         f, 9.0, degree=8)))(s, jnp.asarray(b))
    np.testing.assert_allclose(np.asarray(z2), z_true, atol=5e-3)


def test_cg_multi_matches_single(spd_system):
    """4 RHS at once: one SpMM per iteration; every column must match the
    single-RHS solve within the fp32 tolerance contract."""
    from tpusparse.solve import cg_multi

    a, _z, _b = spd_system
    s = SellMatrix.from_csr(CsrMatrix.from_dense(a))
    rng = np.random.default_rng(84)
    z_true = rng.normal(size=(4, 256)).astype(np.float32)
    b = jnp.asarray((z_true.astype(np.float64) @ a.astype(np.float64).T)
                    .astype(np.float32))
    z, info = cg_multi(s, b, tol=1e-6)
    assert info["resnorm"].shape == (4,)
    np.testing.assert_allclose(np.asarray(z), z_true, atol=5e-3)
    for i in range(4):
        zi, _ = cg(s, b[i], tol=1e-6)
        np.testing.assert_allclose(np.asarray(z)[i], np.asarray(zi),
                                   atol=1e-3)


def test_cg_multi_mixed_convergence_freezes(spd_system):
    """Columns with wildly different scales: the easy column must stay
    converged (frozen alpha) while the hard ones keep iterating."""
    from tpusparse.solve import cg_multi

    a, _z, _b = spd_system
    s = SellMatrix.from_csr(CsrMatrix.from_dense(a))
    rng = np.random.default_rng(85)
    z_true = np.stack([
        1e-3 * np.eye(256, dtype=np.float32)[0],        # nearly-trivial RHS
        rng.normal(size=256).astype(np.float32),
        1e3 * rng.normal(size=256).astype(np.float32),
    ])
    b = jnp.asarray((z_true.astype(np.float64) @ a.astype(np.float64).T)
                    .astype(np.float32))
    z, info = cg_multi(s, b, tol=1e-6, maxiter=400)
    rel = (np.abs(np.asarray(z) - z_true).max(axis=1)
           / np.maximum(np.abs(z_true).max(axis=1), 1e-9))
    assert (rel < 5e-3).all()
    # per-column residual below the per-column limit
    bn = np.linalg.norm(np.asarray(b), axis=1)
    assert (np.asarray(info["resnorm"]) <= 1e-6 * bn * 1.05).all()


def test_cg_multi_jit_and_validation(spd_system):
    from tpusparse.solve import cg_multi

    a, _z, _b = spd_system
    s = SellMatrix.from_csr(CsrMatrix.from_dense(a))
    rng = np.random.default_rng(86)
    z_true = rng.normal(size=(2, 256)).astype(np.float32)
    b = jnp.asarray((z_true.astype(np.float64) @ a.astype(np.float64).T)
                    .astype(np.float32))
    z, _ = jax.jit(lambda f, bb: cg_multi(f, bb, tol=1e-6))(s, b)
    np.testing.assert_allclose(np.asarray(z), z_true, atol=5e-3)
    with pytest.raises(ValueError, match="nrhs"):
        cg_multi(s, jnp.zeros(256))
