"""Sharded AMG: GSPMD placement of grid/block hierarchies.

The reference has no multi-device story (SURVEY.md §2.4); this is the
north-star extension applied to the solver stack: grid/block hierarchies
over DIA/dense operators are pure-XLA programs, so `amg.shard(mesh)`'s
placement hints are all jit needs to partition the whole V-cycle — DIA
halo collective-permutes, shard-local reshape transfers, psum dots.
"""

import numpy as np
import pytest
from scipy import sparse as ssp

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tpusparse.amg import _amg_apply, smoothed_aggregation
from tpusparse.formats.csr import CsrMatrix


def _laplacian_2d(side: int) -> ssp.csr_matrix:
    t = ssp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(side, side))
    return (ssp.kron(ssp.eye(side), t)
            + ssp.kron(t, ssp.eye(side))).tocsr().astype(np.float32)


def _mesh() -> Mesh:
    return Mesh(np.array(jax.devices()), ("n",))


def test_sharded_grid_amg_matches_unsharded():
    side = 48                      # n = 2304 = 8 x 288 (6 lattice rows/dev)
    a = _laplacian_2d(side)
    amg = smoothed_aggregation(CsrMatrix.from_scipy(a), aggregation="grid")
    mesh = _mesh()
    sh = amg.shard(mesh)
    # fine-level leaves landed column-sharded
    assert sh.levels[0].a.vals.sharding.spec == P(None, "n")
    assert sh.levels[0].dinv.sharding.spec == P("n")

    b_h = np.random.default_rng(0).normal(size=a.shape[0]).astype(np.float32)
    b = jax.device_put(jnp.asarray(b_h), NamedSharding(mesh, P("n")))
    z, info = sh.solve(b, tol=1e-5)
    assert z.sharding.spec == P("n")           # output stays sharded
    np.testing.assert_allclose(
        a.astype(np.float64) @ np.asarray(z, np.float64), b_h, atol=1e-3)
    z0, info0 = amg.solve(jnp.asarray(b_h), tol=1e-5)
    assert int(info["iters"]) == int(info0["iters"])
    np.testing.assert_allclose(np.asarray(z), np.asarray(z0), atol=1e-5)


def test_sharded_vcycle_keeps_fine_level_halo_sharded():
    # the partitioned V-cycle must not all-gather a fine-level vector:
    # DIA's +-offset slices become halo collective-permutes; gathers are
    # allowed only at the (tiny) coarse-level boundaries
    side = 48
    a = _laplacian_2d(side)
    n = a.shape[0]
    mesh = _mesh()
    sh = smoothed_aggregation(
        CsrMatrix.from_scipy(a), aggregation="grid").shard(mesh)
    b = jax.device_put(jnp.zeros(n, jnp.float32), NamedSharding(mesh, P("n")))
    txt = _amg_apply.lower(sh, b).compile().as_text()
    assert "collective-permute" in txt
    assert f"f32[{n}]{{0}} all-gather" not in txt


def test_sharded_block_amg_1d_chain():
    n = 4096                                    # auto -> block on the chain
    t = ssp.diags([-1.0, 2.0, -1.0], [-1, 0, 1],
                  shape=(n, n)).tocsr().astype(np.float32)
    amg = smoothed_aggregation(CsrMatrix.from_scipy(t))
    assert amg.levels[0].kind == "block"
    mesh = _mesh()
    sh = amg.shard(mesh)
    b_h = np.random.default_rng(1).normal(size=n).astype(np.float32)
    b = jax.device_put(jnp.asarray(b_h), NamedSharding(mesh, P("n")))
    z, info = sh.solve(b, tol=1e-5)
    # the 1-D chain's cond ~ n^2 ~ 1.6e7 caps fp32 CG around relres 2e-3
    # sharded and unsharded alike, and fp reassociation in the psum dots
    # legitimately lands on a different same-quality near-solution —
    # assert residual QUALITY matches, not solution values
    z0, info0 = amg.solve(jnp.asarray(b_h), tol=1e-5)
    assert int(info["iters"]) == int(info0["iters"])

    def relres(zz):
        r = t.astype(np.float64) @ np.asarray(zz, np.float64) - b_h
        return float(np.linalg.norm(r) / np.linalg.norm(b_h))

    assert relres(z) <= max(2.0 * relres(z0), 1e-5)


def test_sharded_amg_rejects_packed_carriers():
    # greedy hierarchies hold packed carriers GSPMD placement cannot split
    a = _laplacian_2d(64)
    amg = smoothed_aggregation(CsrMatrix.from_scipy(a))
    assert amg.levels[0].kind == "packed"
    with pytest.raises(ValueError, match="grid"):
        amg.shard(_mesh())


def test_sharded_greedy_amg_unstructured():
    """Greedy/Vanek hierarchies shard via contiguous ragged-SELL column
    shards built at setup (smoothed_aggregation(mesh=...)) — the r2
    verdict's 'unstructured problems cannot shard' gap. Same iteration
    count and solution quality as the unsharded build on a Delaunay FEM
    graph Laplacian (a matrix grid/block modes cannot take)."""
    from tpusparse.testing import generators

    c = generators.mesh_csr(48, 48, seed=4)      # 2304-node FEM Laplacian
    mesh = _mesh()
    sh = smoothed_aggregation(c, dense_cutoff=512, mesh=mesh)
    assert any(l.fmt == "rsell-shard" for l in sh.levels), \
        [(l.n, l.fmt) for l in sh.levels]
    lev0 = sh.levels[0]
    assert lev0.a.vals.sharding.spec == P("n")   # shard axis = dim 0
    assert lev0.p.n_shards == 8 and lev0.pt.n_shards == 8

    b = np.random.default_rng(1).uniform(-1, 1, c.shape[0]) \
        .astype(np.float32)
    z, info = sh.solve(jnp.asarray(b), tol=1e-6)

    h0 = smoothed_aggregation(c, dense_cutoff=512)
    z0, info0 = h0.solve(jnp.asarray(b), tol=1e-6)
    assert int(info["iters"]) == int(info0["iters"])

    sp = c.to_scipy().astype(np.float64)

    def relres(zz):
        r = sp @ np.asarray(zz, np.float64) - b
        return float(np.linalg.norm(r) / np.linalg.norm(b))

    assert relres(z) <= max(2.0 * relres(z0), 1e-5)

    # sharded hierarchies must refuse persistence with a clear pointer
    with pytest.raises(ValueError, match="unsharded"):
        sh.save("/tmp/_should_not_exist.npz")
