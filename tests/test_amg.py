"""Smoothed-aggregation AMG (tpusparse/amg.py): hierarchy, symmetry,
V-cycle convergence, CG preconditioning."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpusparse.amg import smoothed_aggregation
from tpusparse.formats.csr import CsrMatrix
from tpusparse.solve import cg


def _laplacian_2d(side: int) -> np.ndarray:
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
def lap32():
    a = _laplacian_2d(32)                      # 1024 unknowns
    amg = smoothed_aggregation(a, coarse_size=100)
    rng = np.random.default_rng(11)
    b = rng.normal(size=a.shape[0]).astype(np.float32)
    return a, amg, b


def test_hierarchy_shape(lap32):
    a, amg, _ = lap32
    sizes = [l.n for l in amg.levels]
    assert sizes[0] == 1024 and len(sizes) >= 2
    assert all(sizes[i] > sizes[i + 1] for i in range(len(sizes) - 1))
    assert sizes[-1] <= 100
    assert amg.operator_complexity < 3.0       # SA stays lean
    assert "levels=" in repr(amg)


def test_vcycle_contracts_error(lap32):
    a, amg, b = lap32
    # one V-cycle as a stationary iteration must shrink the residual hard
    z = np.asarray(amg(jnp.asarray(b)))
    r1 = b - a @ z
    assert np.linalg.norm(r1) < 0.2 * np.linalg.norm(b)


def test_vcycle_is_symmetric_linear(lap32):
    _, amg, _ = lap32
    rng = np.random.default_rng(3)
    u = jnp.asarray(rng.normal(size=1024).astype(np.float32))
    v = jnp.asarray(rng.normal(size=1024).astype(np.float32))
    mu, mv = np.asarray(amg(u)), np.asarray(amg(v))
    # <Mu, v> == <u, Mv> (required for use as a CG preconditioner)
    s1, s2 = float(np.dot(mu, np.asarray(v))), float(
        np.dot(np.asarray(u), mv))
    assert abs(s1 - s2) <= 1e-3 * max(abs(s1), abs(s2))
    # linearity
    muv = np.asarray(amg(u + 2.0 * v))
    np.testing.assert_allclose(muv, mu + 2.0 * mv, atol=2e-3 * np.max(
        np.abs(muv)))


def test_amg_cg_beats_plain_cg(lap32):
    a, amg, b = lap32
    z, info = amg.solve(jnp.asarray(b), tol=1e-6)
    _, plain = cg(amg.levels[0].apply_a, jnp.asarray(b), tol=1e-6)
    assert int(info["iters"]) <= 12
    assert int(info["iters"]) * 3 < int(plain["iters"])
    # 1e-3: the reference contract; the dense coarse inverse and dense
    # levels multiply at HIGHEST precision (amg._apply), so a GPU's TF32
    # cannot loosen the V-cycle
    np.testing.assert_allclose(a @ np.asarray(z), b, atol=1e-3)


def test_amg_jits(lap32):
    _, amg, b = lap32
    f = jax.jit(lambda r: amg(r))
    z1 = np.asarray(f(jnp.asarray(b)))
    z2 = np.asarray(amg(jnp.asarray(b)))
    np.testing.assert_allclose(z1, z2, atol=1e-5)


def test_amg_from_csr_no_densify_level0():
    a = _laplacian_2d(64)                      # 4096 > dense_cutoff
    csr = CsrMatrix.from_dense(a)
    amg = smoothed_aggregation(csr)
    assert amg.levels[0].fmt != "dense"        # packed format on the fine level
    rng = np.random.default_rng(7)
    b = rng.normal(size=4096).astype(np.float32)
    z, info = amg.solve(jnp.asarray(b), tol=1e-5)
    assert int(info["iters"]) <= 15
    np.testing.assert_allclose(a @ np.asarray(z), b, atol=1e-3)


def test_amg_validation():
    with pytest.raises(ValueError, match="square"):
        smoothed_aggregation(np.ones((4, 8), np.float32))
    bad = np.array([[2.0, 1.0], [0.0, 2.0]], np.float32)
    with pytest.raises(ValueError, match="symmetric"):
        smoothed_aggregation(bad)


def test_amg_anisotropic_with_strength_threshold():
    # anisotropic 2-D stencil: weak coupling in one direction; theta>0
    # drops the weak links so aggregates follow the strong direction
    side, eps = 24, 0.01
    n = side * side
    a = np.zeros((n, n), np.float64)
    idx = np.arange(n).reshape(side, side)
    a[np.arange(n), np.arange(n)] = 2.0 + 2.0 * eps
    for (di, dj, w) in ((0, 1, 1.0), (1, 0, eps)):
        src = idx[: side - di, : side - dj].ravel()
        dst = idx[di:, dj:].ravel()
        a[src, dst] -= w
        a[dst, src] -= w
    amg = smoothed_aggregation(a.astype(np.float32), theta=0.1,
                               coarse_size=60)
    rng = np.random.default_rng(9)
    b = rng.normal(size=n).astype(np.float32)
    z, info = amg.solve(jnp.asarray(b), tol=1e-5)
    assert int(info["iters"]) <= 30
    np.testing.assert_allclose(a.astype(np.float32) @ np.asarray(z), b,
                               atol=2e-3)


def test_amg_3d_poisson_converges():
    """3D 7-point Poisson (a 101^3 robustness operator, shrunk to 16^3
    for the suite): iteration count must stay in the same single-digit
    band as 2D — SA is dimension-agnostic."""
    from tpusparse.testing.generators import stencil_csr

    side = 16
    n = side ** 3
    c = stencil_csr((side, side, side))
    amg = smoothed_aggregation(c, coarse_size=100)
    sizes = [l.n for l in amg.levels]
    assert sizes[0] == n and len(sizes) >= 2
    rng = np.random.default_rng(5)
    b = rng.normal(size=n).astype(np.float32)
    z, info = amg.solve(jnp.asarray(b), tol=1e-5)
    assert int(info["iters"]) <= 12
    sp = c.to_scipy().tocsr().astype(np.float64)
    r = sp @ np.asarray(z).astype(np.float64) - b.astype(np.float64)
    assert np.linalg.norm(r) <= 1e-3 * np.linalg.norm(b)


def test_amg_block_mode_engages_and_converges():
    # 1-D chain (tridiagonal): bandwidth 1 <= 2*block_size, so auto picks
    # block strips — on a chain, index strips ARE graph neighborhoods
    # diag 2.01 keeps cond ~400: the pure chain's cond ~n^2 makes fp32
    # recurrence-vs-true residual drift exceed the 1e-3 check
    n = 8192
    a = np.zeros((n, n), np.float32)
    a[np.arange(n), np.arange(n)] = 2.01
    a[np.arange(n - 1), np.arange(1, n)] = -1.0
    a[np.arange(1, n), np.arange(n - 1)] = -1.0
    amg = smoothed_aggregation(CsrMatrix.from_dense(a))
    assert amg.levels[0].kind == "block"
    assert amg.levels[0].pt is None and amg.levels[0].p.ndim == 2
    rng = np.random.default_rng(21)
    b = rng.normal(size=n).astype(np.float32)
    zb, ib = amg.solve(jnp.asarray(b), tol=1e-5)
    assert int(ib["iters"]) <= 20
    np.testing.assert_allclose(a @ np.asarray(zb), b, atol=1e-3)
    # a 2-D lattice must NOT 1-D block-route (strip semicoarsening stalls
    # CG); auto stays greedy (grid mode is an explicit setup-time opt-in)
    a2 = _laplacian_2d(64)
    assert smoothed_aggregation(
        CsrMatrix.from_dense(a2)).levels[0].kind == "packed"
    with pytest.raises(ValueError, match="aggregation"):
        smoothed_aggregation(a2, aggregation="pairwise")


def test_amg_grid_mode_matches_greedy_and_respects_boundaries():
    # odd-dimension lattice: boundary aggregates have 2/1 members; the
    # carrier-free reshape transfers must reproduce exact P0 weighting
    n_side = 96
    a = _laplacian_2d(n_side)
    csr = CsrMatrix.from_dense(a)
    amg = smoothed_aggregation(csr, aggregation="grid")
    assert amg.levels[0].kind == "grid"
    assert amg.levels[0].shape2d == (n_side, n_side, 3)
    rng = np.random.default_rng(11)
    b = rng.normal(size=n_side * n_side).astype(np.float32)
    z, info = amg.solve(jnp.asarray(b), tol=1e-5)
    assert int(info["iters"]) <= 12
    np.testing.assert_allclose(
        a.astype(np.float64) @ np.asarray(z, np.float64), b, atol=1e-3)
    # explicit grid request on a non-lattice matrix must fail loudly
    rng_m = np.random.default_rng(3)
    dense = rng_m.normal(size=(256, 256)).astype(np.float32)
    spd = dense @ dense.T + 256 * np.eye(256, dtype=np.float32)
    with pytest.raises(ValueError, match="lattice"):
        smoothed_aggregation(spd, aggregation="grid", coarse_size=64)


def _lattice(r, c):
    from scipy import sparse as ssp

    tr = ssp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(r, r))
    tc = ssp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(c, c))
    return (ssp.kron(ssp.eye(r), tc) + ssp.kron(tr, ssp.eye(c))).tocsr()


def test_detect_grid_narrow_lattices():
    # review r2: candidate strides had a 2h+2 floor, so a 5000x6 grid
    # decomposed at c=10 (wrong neighborhoods) and 512x8 not at all
    from tpusparse.amg import _detect_grid

    assert _detect_grid(_lattice(5000, 6)) == 6
    assert _detect_grid(_lattice(512, 8)) == 8
    assert _detect_grid(_lattice(64, 64)) == 64          # wide unchanged
    assert _detect_grid(_lattice(48, 100)) == 100


def test_detect_grid_divisor_neighbor_tiebreak():
    # advisor r2: when (C+1) divides n the max-based score tied and picked
    # C+1, wrapping aggregates across row boundaries. The sum-based score
    # (4 for the true C vs 6 for C+1 on a 5-point stencil) resolves it.
    from tpusparse.amg import _detect_grid

    assert _detect_grid(_lattice(12, 11)) == 11
    assert _detect_grid(_lattice(16, 15)) == 15
    assert _detect_grid(_lattice(32, 31)) == 31


def test_auto_mode_keeps_thin_lattices_off_block_strips():
    # review r2: 512x12 passed the bw gate and took 1-D strips
    # (semicoarsening, 9 CG iters vs 5 greedy). The gate now spots 2-D
    # structure (detected stride + offset gap). A contiguous narrow band
    # (no gap) still takes the strip fast path.
    from scipy import sparse as ssp

    a = _lattice(512, 12).astype(np.float32)
    amg = smoothed_aggregation(CsrMatrix.from_scipy(a))
    assert amg.levels[0].kind == "packed", amg.levels[0].kind   # greedy

    band = ssp.diags([np.ones(6143)], [1], shape=(6144, 6144))
    band = (band + band.T + 4 * ssp.eye(6144)).tocsr().astype(np.float32)
    amg_band = smoothed_aggregation(CsrMatrix.from_scipy(band))
    assert amg_band.levels[0].kind == "block", amg_band.levels[0].kind


def test_coarsening_stall_raises_not_densifies():
    # review r2: a theta that drops every connection left the full-size
    # matrix at the coarse level and np.linalg.inv(toarray()) followed —
    # for 1M unknowns that is a ~4 TB host densify. Must refuse loudly.
    a = _laplacian_2d(96)                     # 9216 > the stall guard
    with pytest.raises(ValueError, match="stalled"):
        smoothed_aggregation(CsrMatrix.from_dense(a), theta=0.9)


@pytest.mark.parametrize("mode", ["greedy", "grid"])
def test_amg_save_load_roundtrip(tmp_path, mode):
    # the preconditioner is the expensive artifact (setup >> solve);
    # save/load must reproduce the V-cycle bitwise-or-near and solve
    # identically across packed-carrier (greedy) and carrier-free (grid)
    # hierarchies
    from tpusparse.amg import SmoothedAggregationAMG

    a = _laplacian_2d(48)                     # 2304 unknowns, multi-level
    amg = smoothed_aggregation(CsrMatrix.from_dense(a), aggregation=mode)
    p = str(tmp_path / f"amg_{mode}.npz")
    amg.save(p)
    back = SmoothedAggregationAMG.load(p)

    assert len(back.levels) == len(amg.levels)
    for l0, l1 in zip(amg.levels, back.levels):
        assert (l0.n, l0.nnz, l0.fmt, l0.kind, l0.shape2d) == \
            (l1.n, l1.nnz, l1.fmt, l1.kind, l1.shape2d)
    assert (back.theta, back.degree, back.ratio, back.omega) == \
        (amg.theta, amg.degree, amg.ratio, amg.omega)

    rng = np.random.default_rng(31)
    b = rng.normal(size=a.shape[0]).astype(np.float32)
    v0 = np.asarray(amg(jnp.asarray(b)))
    v1 = np.asarray(back(jnp.asarray(b)))
    np.testing.assert_allclose(v1, v0, atol=1e-6 * np.abs(v0).max())
    z, info = back.solve(jnp.asarray(b), tol=1e-5)
    np.testing.assert_allclose(a @ np.asarray(z), b, atol=1e-3)
    assert int(info["iters"]) <= 12

    with pytest.raises(ValueError, match="checkpoint"):
        np.savez(str(tmp_path / "junk.npz"), x=np.zeros(3))
        SmoothedAggregationAMG.load(str(tmp_path / "junk.npz"))


def test_auto_theta_spectrum_detection():
    """theta='auto' (the default) resolves from the coupling spectrum:
    0 on isotropic operators, the inter-mode gap on anisotropic ones."""
    from tpusparse.amg import _auto_theta
    from tpusparse.testing.generators import stencil_csr

    iso = stencil_csr((32, 32)).to_scipy().tocsr()
    assert _auto_theta(iso) == 0.0
    for axis in (0, 1):
        an = stencil_csr((32, 32), eps=100.0,
                         eps_axis=axis).to_scipy().tocsr()
        t = _auto_theta(an)
        # strong s ~ 0.5, weak s ~ 0.005 -> geometric mean ~ 0.05,
        # anywhere in the gap semicoarsens correctly
        assert 0.02 <= t <= 0.25, t


def test_amg_anisotropic_default_args_converge():
    """eps=100 anisotropy must solve in single-digit iterations with NO
    theta argument (the r3 verdict: theta=0.08 rescued it 33-42 -> 8
    iters 'but only if the user knows to pass it')."""
    from tpusparse.testing.generators import stencil_csr

    for axis in (0, 1):
        c = stencil_csr((64, 64), eps=100.0, eps_axis=axis)
        amg = smoothed_aggregation(c, coarse_size=100)
        assert amg.theta > 0.0          # auto-detected, recorded
        b = np.random.default_rng(11).normal(size=c.shape[0]) \
            .astype(np.float32)
        z, info = amg.solve(jnp.asarray(b), tol=1e-6)
        # 64^2's iteration floor is ~11-12 for ANY theta (0.08 also reads
        # 12); at 512^2 auto-theta reads 8 CG iterations on both axes —
        # the <= 10 criterion. theta=0 reads 34 here — 15 cleanly
        # separates detected-vs-not
        assert int(info["iters"]) <= 15, (axis, int(info["iters"]))
        # the eps=100 operator has ||A|| ~ 200x the isotropic case, so an
        # absolute-residual check miscalibrates; the contract is relative
        a = c.to_scipy().astype(np.float64)
        r = a @ np.asarray(z, np.float64) - b
        # fp32 V-cycle CG true-residual drift on a kappa-heavy operator:
        # the recurrence hits tol=1e-6 but the true relres floors ~3e-4
        assert np.linalg.norm(r) / np.linalg.norm(b) <= 1e-3
