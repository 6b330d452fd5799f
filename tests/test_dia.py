"""DIA diagonal format (formats/dia.py) + banded routing."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tests.conftest import assert_close
from tpusparse.formats.csr import CsrMatrix
from tpusparse.formats.dia import DiaMatrix
from tpusparse.testing import generators, reference


@pytest.fixture(scope="module")
def banded():
    # non-square, band crossing both edges, plus far off-diagonals
    a = generators.random_sparse_matrix(384, 320, density=0.9, seed=101)
    mask = np.zeros_like(a, dtype=bool)
    ii, jj = np.indices(a.shape)
    d = ii - jj
    for off in (-130, -2, -1, 0, 1, 3, 257):
        mask |= d == off
    return np.where(mask, a, 0).astype(np.float32)


def test_round_trip(banded):
    m = DiaMatrix.from_dense(banded)
    np.testing.assert_array_equal(m.to_dense(), banded)
    assert m.nnz == np.count_nonzero(banded)
    assert len(m.offsets) <= 7
    assert all(isinstance(d, int) for d in m.offsets)


def test_spmv_spmm_match_oracle(banded):
    m = DiaMatrix.from_dense(banded)
    x = generators.random_sparse_vector(384, density=0.5, seed=102)
    assert_close(m.spmv(jnp.asarray(x)), reference.sgemv_cpu(x, banded),
                 name="dia spmv")
    xb = generators.random_sparse_batch(5, 384, density=0.5, seed=103)
    assert_close(m.spmm(jnp.asarray(xb)),
                 (np.asarray(xb, np.float64)
                  @ banded.astype(np.float64)).astype(np.float32),
                 name="dia spmm")
    # spmv() on a 2-D x delegates to spmm
    assert m.spmv(jnp.asarray(xb)).shape == (5, 320)


def test_jit_and_pytree(banded):
    m = DiaMatrix.from_dense(banded)
    x = jnp.asarray(generators.random_sparse_vector(384, density=0.5,
                                                    seed=104))

    @jax.jit
    def f(fmt, v):
        return fmt.spmv(v)

    assert_close(f(m, x), m.spmv(x), name="dia jit")
    leaves, treedef = jax.tree_util.tree_flatten(m)
    assert len(leaves) == 1
    m2 = jax.tree_util.tree_unflatten(treedef, leaves)
    assert m2.offsets == m.offsets


def test_from_csr_no_densify_and_duplicates():
    # duplicates in COO sum, like every other packer
    rows = np.array([0, 0, 5, 9])
    cols = np.array([0, 0, 5, 3])
    vals = np.array([1.0, 2.0, 4.0, -1.0], np.float32)
    c = CsrMatrix.from_coo(12, 10, rows, cols, vals)
    m = DiaMatrix.from_csr(c)
    d = m.to_dense()
    assert d[0, 0] == 3.0 and d[5, 5] == 4.0 and d[9, 3] == -1.0


def test_max_diags_guard():
    a = generators.random_sparse_matrix(256, 256, density=0.5, seed=105)
    with pytest.raises(ValueError, match="diagonals"):
        DiaMatrix.from_csr(CsrMatrix.from_dense(a), max_diags=16)


def test_auto_routes_banded_to_dia(banded):
    from tpusparse.formats.auto import auto_format, matrix_stats, \
        matrix_stats_csr

    s_d = matrix_stats(banded)
    c = CsrMatrix.from_dense(banded)
    s_c = matrix_stats_csr(c)
    assert s_d["n_diags"] == s_c["n_diags"] == 7
    assert isinstance(auto_format(banded), DiaMatrix)
    assert isinstance(auto_format(c), DiaMatrix)
    # a uniform-random matrix must NOT route to DIA
    rnd = generators.random_sparse_matrix(256, 256, density=0.5, seed=106)
    assert not isinstance(auto_format(rnd), DiaMatrix)


def test_save_load(tmp_path, banded):
    from tpusparse.formats import io

    m = DiaMatrix.from_dense(banded)
    p = str(tmp_path / "dia.npz")
    io.save(p, m)
    m2 = io.load(p)
    assert isinstance(m2, DiaMatrix)
    assert m2.offsets == m.offsets
    np.testing.assert_array_equal(np.asarray(m2.vals), np.asarray(m.vals))


def test_empty_matrix():
    c = CsrMatrix.from_coo(64, 64, np.zeros(0, np.int64),
                           np.zeros(0, np.int64), np.zeros(0, np.float32))
    m = DiaMatrix.from_csr(c)
    y = m.spmv(jnp.ones(64))
    np.testing.assert_array_equal(np.asarray(y), np.zeros(64, np.float32))


def test_cg_on_dia_laplacian():
    """The solver workload that motivated the format (a 2-D Laplacian)."""
    from tests.test_solve import _laplacian_2d
    from tpusparse.formats.auto import auto_format
    from tpusparse.solve import cg

    a = _laplacian_2d(16)
    m = auto_format(CsrMatrix.from_dense(a))
    assert isinstance(m, DiaMatrix)
    rng = np.random.default_rng(107)
    z_true = rng.normal(size=256).astype(np.float32)
    b = jnp.asarray((a.astype(np.float64) @ z_true).astype(np.float32))
    z, info = cg(m, b, tol=1e-5)
    np.testing.assert_allclose(np.asarray(z), z_true, atol=5e-3)


@pytest.fixture(scope="module")
def banded_sq():
    # square, band within +-n/D so the halo partition applies at D=8
    a = generators.random_sparse_matrix(512, 512, density=0.9, seed=108)
    mask = np.zeros_like(a, dtype=bool)
    ii, jj = np.indices(a.shape)
    d = ii - jj
    for off in (-63, -5, 0, 1, 33):
        mask |= d == off
    return np.where(mask, a, 0).astype(np.float32)


@pytest.mark.parametrize("partition", ["halo", "n"])
def test_sharded_spmv_spmm(banded_sq, partition):
    from tpusparse.parallel.mesh import make_mesh
    from tpusparse.parallel.sparse import dia_spmm_sharded

    m = DiaMatrix.from_dense(banded_sq)
    mesh = make_mesh({"n": 8}, jax.devices()[:8])
    x = generators.random_sparse_vector(512, density=0.5, seed=109)
    assert_close(dia_spmm_sharded(m, jnp.asarray(x), mesh, partition),
                 reference.sgemv_cpu(x, banded_sq),
                 name=f"dia sharded spmv [{partition}]")
    xb = generators.random_sparse_batch(3, 512, density=0.5, seed=110)
    assert_close(dia_spmm_sharded(m, jnp.asarray(xb), mesh, partition),
                 (np.asarray(xb, np.float64)
                  @ banded_sq.astype(np.float64)).astype(np.float32),
                 name=f"dia sharded spmm [{partition}]")


def test_sharded_guards(banded, banded_sq):
    from tpusparse.parallel.mesh import make_mesh
    from tpusparse.parallel.sparse import dia_spmm_sharded

    mesh = make_mesh({"n": 8}, jax.devices()[:8])
    # non-square operator has no aligned slabs
    with pytest.raises(ValueError, match="square"):
        dia_spmm_sharded(DiaMatrix.from_dense(banded), jnp.ones(384), mesh)
    # band wider than the 64-element slab cannot halo at D=8
    wide = np.zeros((512, 512), np.float32)
    ii = np.arange(382)
    wide[ii + 130, ii] = 1.0
    with pytest.raises(ValueError, match="halo"):
        dia_spmm_sharded(DiaMatrix.from_dense(wide), jnp.ones(512), mesh)
    # ... but the replicated-X partition still handles it
    y = dia_spmm_sharded(DiaMatrix.from_dense(wide), jnp.ones(512), mesh,
                         partition="n")
    assert_close(y, reference.sgemv_cpu(np.ones(512, np.float32), wide),
                 name="dia sharded wide [n]")


def test_sharded_nondivisible(banded_sq):
    """n not divisible by D: zero-column padding covers it."""
    from tpusparse.parallel.mesh import make_mesh
    from tpusparse.parallel.sparse import dia_spmm_sharded

    a = banded_sq[:500, :500].copy()
    m = DiaMatrix.from_dense(a)
    mesh = make_mesh({"n": 8}, jax.devices()[:8])
    x = generators.random_sparse_vector(500, density=0.5, seed=111)
    for partition in ("halo", "n"):
        assert_close(dia_spmm_sharded(m, jnp.asarray(x), mesh, partition),
                     reference.sgemv_cpu(x, a),
                     name=f"dia sharded 500 [{partition}]")


def test_native_autodiff(banded):
    """DIA needs no custom VJP: spmv is static slices + FMAs, so jax.grad
    flows through natively — both d/dx and d/dvals (the trainable-banded
    case) against the dense closed forms."""
    m = DiaMatrix.from_dense(banded)
    x = jnp.asarray(generators.random_sparse_vector(384, density=0.5,
                                                    seed=112))
    g = jnp.asarray(np.random.default_rng(113).normal(
        size=320).astype(np.float32))

    dx = jax.grad(lambda v: jnp.vdot(g, m.spmv(v)))(x)
    assert_close(dx, reference.sgemv_cpu(np.asarray(g), banded.T),
                 name="dia d/dx")

    def loss_vals(vals):
        m2 = DiaMatrix(m.offsets, vals, m.shape, m.nnz)
        return jnp.vdot(g, m2.spmv(x))

    dvals = jax.grad(loss_vals)(jnp.asarray(m.vals))
    # dL/dvals[i, c] = g[c] * x[c + d_i]  (zero where the diagonal exits)
    xp = np.pad(np.asarray(x), m._x_pad())
    lo = m._x_pad()[0]
    for i, off in enumerate(m.offsets):
        want = np.asarray(g) * xp[off + lo:off + lo + 320]
        ii = np.arange(320)
        want[(ii + off < 0) | (ii + off >= 384)] = 0.0
        got = np.array(dvals[i])
        got[(ii + off < 0) | (ii + off >= 384)] = 0.0
        np.testing.assert_allclose(got, want, atol=1e-4)


# ---------------------------- symmetric storage -----------------------------


@pytest.fixture(scope="module")
def sym_banded():
    # bitwise-symmetric band: build upper half, mirror exactly
    rng = np.random.default_rng(112)
    n = 512
    a = np.zeros((n, n), dtype=np.float32)
    ii, jj = np.indices(a.shape)
    d = ii - jj
    for off in (0, 1, 5, 33):
        band = (d == off)
        vals = rng.normal(size=int(band.sum())).astype(np.float32)
        a[band] = vals
    # bands above sit on ii - jj == off >= 0 (lower triangle); mirror the
    # strictly-lower part up so the result is bitwise symmetric
    return (a + np.tril(a, -1).T).astype(np.float32)


def test_sym_pack_detects_and_halves(sym_banded):
    m = DiaMatrix.from_dense(sym_banded)
    assert m.sym and all(d >= 0 for d in m.offsets)
    full = DiaMatrix.from_dense(sym_banded, symmetric=False)
    assert not full.sym
    assert m.device_bytes() * 2 > full.device_bytes() >= \
        m.device_bytes() * 2 - m.shape[1] * 4  # k_half = (k+1)/2
    np.testing.assert_array_equal(m.to_dense(), sym_banded)
    x = generators.random_sparse_vector(512, density=0.6, seed=113)
    assert_close(m.spmv(jnp.asarray(x)),
                 reference.sgemv_cpu(x, sym_banded), name="sym dia spmv")
    xb = generators.random_sparse_batch(3, 512, density=0.6, seed=114)
    assert_close(m.spmm(jnp.asarray(xb)),
                 (np.asarray(xb, np.float64)
                  @ sym_banded.astype(np.float64)).astype(np.float32),
                 name="sym dia spmm")


def test_sym_pack_guards(banded, sym_banded):
    # asymmetric: auto keeps full storage, symmetric=True raises
    m = DiaMatrix.from_dense(banded)
    assert not m.sym
    with pytest.raises(ValueError, match="symmetric"):
        DiaMatrix.from_dense(banded[:320, :320], symmetric=True)
    # approximately-but-not-bitwise symmetric must stay full
    almost = sym_banded + np.triu(
        np.full_like(sym_banded, 1e-3) * (sym_banded != 0), 1)
    assert not DiaMatrix.from_dense(almost).sym


def test_sym_grad_ties_mirror(sym_banded):
    # d/dvals through sym storage accumulates BOTH mirror contributions:
    # the parametrization is the tied upper band, so SGD preserves symmetry
    m = DiaMatrix.from_dense(sym_banded)
    x = jnp.asarray(generators.random_sparse_vector(512, density=0.6,
                                                    seed=115))
    g = jnp.asarray(np.random.default_rng(116).normal(
        size=512).astype(np.float32))

    def loss(vals):
        mm = DiaMatrix(m.offsets, vals, m.shape, m.nnz, sym=True)
        return jnp.vdot(mm.spmv(x), g)

    got = jax.grad(loss)(jnp.asarray(m.vals))
    # closed form: dL/dvals_d[c] = x[c+d] g[c] + x[c-d] g[c+d] (tied)
    xs = np.asarray(x, np.float64)
    gs = np.asarray(g, np.float64)
    n = 512
    for i, d in enumerate(m.offsets):
        want = np.zeros(n)
        want[:n - d] += xs[d:] * gs[:n - d]
        if d > 0:
            want[:n - d] += xs[:n - d] * gs[d:]
        mask = np.asarray(m.vals[i]) != 0
        np.testing.assert_allclose(np.asarray(got[i])[mask], want[mask],
                                   atol=1e-4)


@pytest.mark.parametrize("partition", ["halo", "n"])
def test_sym_sharded_matches_oracle(sym_banded, partition):
    from tpusparse.parallel.mesh import make_mesh
    from tpusparse.parallel.sparse import dia_spmm_sharded

    m = DiaMatrix.from_dense(sym_banded)
    assert m.sym
    mesh = make_mesh({"n": 8}, jax.devices()[:8])
    x = generators.random_sparse_vector(512, density=0.5, seed=117)
    assert_close(dia_spmm_sharded(m, jnp.asarray(x), mesh, partition),
                 reference.sgemv_cpu(x, sym_banded),
                 name=f"sym dia sharded [{partition}]")
    xb = generators.random_sparse_batch(3, 512, density=0.5, seed=118)
    assert_close(dia_spmm_sharded(m, jnp.asarray(xb), mesh, partition),
                 (np.asarray(xb, np.float64)
                  @ sym_banded.astype(np.float64)).astype(np.float32),
                 name=f"sym dia sharded spmm [{partition}]")


def test_sym_widens_auto_routing():
    # symmetric halves DIA bytes, so the router admits banded structure
    # at half the per-diagonal fill (0.4 -> 0.2 effective threshold)
    from tpusparse.formats.auto import auto_format, matrix_stats, \
        matrix_stats_csr

    rng = np.random.default_rng(120)
    n = 512
    a = np.zeros((n, n), dtype=np.float32)
    ii, jj = np.indices(a.shape)
    d = ii - jj
    for off in (0, 1, 5, 33):
        band = (d == off) & (rng.random((n, n)) < (1.0 if off == 0
                                                   else 0.25))
        a[band] = rng.normal(size=int(band.sum())).astype(np.float32)
    sym = (a + np.tril(a, -1).T).astype(np.float32)

    s = matrix_stats(sym)
    assert s["diag_sym"]
    assert matrix_stats_csr(CsrMatrix.from_dense(sym))["diag_sym"]
    # fill/diag ~ (n + 6*0.25n)/(7n) ~ 0.36: fails the 0.4 full-storage
    # guard, passes the halved one
    assert s["nnz"] < 0.4 * s["n_diags"] * n
    routed = auto_format(sym)
    assert isinstance(routed, DiaMatrix) and routed.sym
    assert isinstance(auto_format(CsrMatrix.from_dense(sym)), DiaMatrix)

    # the asymmetric twin at identical fill must NOT get the discount
    asym = np.array(sym)
    lower = np.tril(asym, -1)
    asym = asym - lower + 2.0 * lower            # break bitwise symmetry
    sa = matrix_stats(asym)
    assert not sa["diag_sym"]
    assert not isinstance(auto_format(asym.astype(np.float32)), DiaMatrix)


def test_sym_sharded_wide_band_desym_fallback():
    # mirror reads reaching past the immediate neighbor slab (dmax=40 >
    # n_loc=32 at n=256/D=8) cannot ride the single edge-strip ppermute:
    # the sharded path must materialize full storage and stay correct
    # (was: silent corruption / trace-time crash)
    from tpusparse.parallel.mesh import make_mesh
    from tpusparse.parallel.sparse import dia_spmm_sharded

    rng = np.random.default_rng(121)
    n = 256
    a = np.zeros((n, n), dtype=np.float32)
    ii, jj = np.indices(a.shape)
    for off in (0, 1, 40):
        band = (ii - jj) == off
        a[band] = rng.normal(size=int(band.sum())).astype(np.float32)
    a = (a + np.tril(a, -1).T).astype(np.float32)
    m = DiaMatrix.from_dense(a)
    assert m.sym
    np.testing.assert_array_equal(m.desym().to_dense(), a)
    mesh = make_mesh({"n": 8}, jax.devices()[:8])
    x = generators.random_sparse_vector(n, density=0.6, seed=122)
    assert_close(dia_spmm_sharded(m, jnp.asarray(x), mesh, "n"),
                 reference.sgemv_cpu(x, a), name="sym dia sharded wide [n]")
    with pytest.raises(ValueError, match="band too wide"):
        dia_spmm_sharded(m, jnp.asarray(x), mesh, "halo")


def test_sym_true_rejects_non_square():
    rect = np.zeros((4, 6), dtype=np.float32)
    rect[0, 1] = 1.0
    with pytest.raises(ValueError, match="square"):
        DiaMatrix.from_dense(rect, symmetric=True)


def test_sym_save_load(tmp_path, sym_banded):
    from tpusparse.formats import io

    m = DiaMatrix.from_dense(sym_banded)
    p = tmp_path / "sym.npz"
    io.save(p, m)
    m2 = io.load(p)
    assert m2.sym and m2.offsets == m.offsets
    np.testing.assert_array_equal(np.asarray(m2.vals), np.asarray(m.vals))
