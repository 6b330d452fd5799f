"""Seeded, reproducible sparse data generators.

Gap-closing vs the reference (SURVEY.md §4): the reference draws from an
unseeded ``std::random_device`` (tester.cpp:107-108) so no run is reproducible,
and only supports one distribution — uniform(-1, 1) values with i.i.d. ~50%
Bernoulli sparsity in both A and X (tester.cpp:103-121, 151-167). We keep that
as ``distribution="uniform"`` and add skewed workloads that exercise the
binned/adaptive scheduler:

- ``powerlaw``: per-output-column nnz follows a Zipf-like law (a few very
  dense columns, a long tail of nearly-empty ones).
- ``banded``: nonzeros concentrated in a diagonal band (halo-exchange-friendly).
- ``blocks``: block-structured sparsity (BSR's best case).
"""

from __future__ import annotations

import numpy as np


def _rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(seed)


def random_sparse_vector(m: int, density: float = 0.5, seed: int = 0,
                         dtype=np.float32) -> np.ndarray:
    """X: (m,) with uniform(-1,1) values, i.i.d. Bernoulli(density) support."""
    rng = _rng(seed ^ 0x5EED)
    vals = rng.uniform(-1.0, 1.0, size=m)
    mask = rng.random(m) < density
    return (vals * mask).astype(dtype)


def random_sparse_batch(batch: int, m: int, density: float = 0.5, seed: int = 0,
                        dtype=np.float32) -> np.ndarray:
    """X: (batch, m) — the SpMM extension (multi-column X, BASELINE.json)."""
    rng = _rng(seed ^ 0xBA7C4)
    vals = rng.uniform(-1.0, 1.0, size=(batch, m))
    mask = rng.random((batch, m)) < density
    return (vals * mask).astype(dtype)


def random_sparse_matrix(m: int, n: int, density: float = 0.5, seed: int = 0,
                         distribution: str = "uniform",
                         dtype=np.float32, **kw) -> np.ndarray:
    """A: (m, n) dense ndarray with the requested sparsity structure.

    Dense output on purpose: converters ingest dense (like every reference
    converter ctor takes ``float* matrix``, e.g. wsp.cpp:3) and the dense
    array doubles as the oracle operand.
    """
    rng = _rng(seed)
    vals = rng.uniform(-1.0, 1.0, size=(m, n))
    if distribution == "uniform":
        mask = rng.random((m, n)) < density
    elif distribution == "powerlaw":
        mask = _powerlaw_mask(rng, m, n, density, alpha=kw.get("alpha", 1.2))
    elif distribution == "banded":
        mask = _banded_mask(rng, m, n, density, bandwidth=kw.get("bandwidth", None))
    elif distribution == "blocks":
        mask = _block_mask(rng, m, n, density, block=kw.get("block", 128))
    else:
        raise ValueError(f"unknown distribution: {distribution!r}")
    a = vals * mask
    # Avoid exactly-zero stored values inside the support: a value that is 0.0
    # by chance would make dense<->format round-trips ambiguous.
    a = np.where(mask & (a == 0.0), 1e-3, a)
    return a.astype(dtype)


def random_sparse_csr(m: int, n: int, density: float = 0.5, seed: int = 0,
                      distribution: str = "uniform", dtype=np.float32,
                      **kw) -> "CsrMatrix":
    """A as ``CsrMatrix`` generated WITHOUT materializing the dense array —
    the no-densify ingestion fixture (a 50k x 50k matrix is 10 GB dense).

    Positions are drawn with replacement and deduplicated, so nnz lands
    slightly below ``round(m*n*density)`` (within ~density/2 relative);
    exact-count generation would need per-column rejection loops that do not
    vectorize. Supports ``uniform`` and ``powerlaw`` (column-weighted).
    """
    from tpusparse.formats.csr import CsrMatrix

    rng = _rng(seed)
    target = int(round(m * n * density))
    if distribution == "uniform":
        pos = rng.integers(0, m * n, size=target, dtype=np.int64)
        pos = np.unique(pos)
        r, mi = pos // m, pos % m                 # r = output column
    elif distribution == "powerlaw":
        ranks = np.arange(1, n + 1, dtype=np.float64)
        w = ranks ** (-kw.get("alpha", 1.2))
        # clamp: float rounding can leave cumsum[-1] just under 1.0, and a
        # draw above it would index out of bounds
        cols = rng.permutation(n)[np.minimum(np.searchsorted(
            np.cumsum(w / w.sum()), rng.random(target)), n - 1)]
        rows = rng.integers(0, m, size=target, dtype=np.int64)
        pos = np.unique(cols.astype(np.int64) * m + rows)
        r, mi = pos // m, pos % m
    else:
        raise ValueError(
            f"random_sparse_csr supports uniform/powerlaw, not "
            f"{distribution!r}")
    vals = rng.uniform(-1.0, 1.0, size=r.size).astype(dtype)
    vals[vals == 0.0] = 1e-3                      # keep support unambiguous
    row_ptr = np.zeros(n + 1, dtype=np.int32)
    np.add.at(row_ptr, r + 1, 1)
    np.cumsum(row_ptr, out=row_ptr)
    return CsrMatrix(shape=(m, n), row_ptr=row_ptr,
                     col_idx=mi.astype(np.int32), values=vals)


# ---------------------------------------------------------------------------
# Real-topology generators: offline-reproducible constructions of
# the matrix families the i.i.d. masks above cannot imitate — graphs with
# hubs AND locality, FEM meshes, lattice stencils, bands with defects, and
# semi-structured pruned weights. These are what the router's thresholds
# must survive. All return ``CsrMatrix`` without densifying, except the
# pruned-weight families, which are dense by nature.
# ---------------------------------------------------------------------------


def rmat_csr(scale: int, edge_factor: int = 16, seed: int = 0,
             a: float = 0.57, b: float = 0.19, c: float = 0.19,
             symmetric: bool = False, dtype=np.float32) -> "CsrMatrix":
    """R-MAT (recursive-matrix / Kronecker) graph adjacency: n = 2^scale
    nodes, ~n*edge_factor edges. The Graph500 parameters (0.57, 0.19, 0.19)
    give the hub-plus-locality degree skew real web/social/netlist graphs
    have — a few super-connected columns and a heavy diagonal-ish mass —
    which i.i.d. and per-column-powerlaw masks both miss (hubs correlate
    across rows AND columns here). Vectorized quadrant descent; duplicate
    edges are merged, so nnz lands slightly under n*edge_factor."""
    from tpusparse.formats.csr import CsrMatrix

    rng = _rng(seed ^ 0x514A7)
    n = 1 << scale
    ne = n * edge_factor
    rows = np.zeros(ne, dtype=np.int64)
    cols = np.zeros(ne, dtype=np.int64)
    for level in range(scale):
        u = rng.random(ne)
        top = u < (a + b)                      # row bit stays 0
        # column bit drawn conditionally in one pass: P(col=1 | top) =
        # b/(a+b), P(col=1 | bottom) = d/(c+d) with d = 1-a-b-c
        v = rng.random(ne)
        d = 1.0 - a - b - c
        col_bit = np.where(top, v < b / (a + b), v < d / (c + d))
        rows |= (~top).astype(np.int64) << level
        cols |= col_bit.astype(np.int64) << level
    if symmetric:
        rows, cols = np.concatenate([rows, cols]), np.concatenate([cols, rows])
    pos = np.unique(rows * n + cols)
    r, ci = pos // n, pos % n
    vals = rng.uniform(-1.0, 1.0, size=r.size).astype(dtype)
    vals[vals == 0.0] = 1e-3
    return CsrMatrix.from_coo(n, n, r, ci, vals)


def stencil_csr(dims: tuple[int, ...], points: int | None = None,
                eps: float = 1.0, eps_axis: int = 0, seed: int = 0,
                dtype=np.float32) -> "CsrMatrix":
    """Lattice stencil operator on a row-major grid of shape ``dims`` —
    5-point (2D) / 7-point (3D) when ``points`` is None, or the full
    (2*halo+1)^ndim box with ``points`` in {9, 27}. ``eps`` scales the
    couplings along ``eps_axis``: eps != 1 is the anisotropic-diffusion
    operator where plain smoothed aggregation is known to degrade (the AMG
    robustness workload). SPD by construction: diag = sum of |off-diag|
    couplings + 1e-3. O(nnz) build, never densified."""
    from tpusparse.formats.csr import CsrMatrix

    nd = len(dims)
    n = int(np.prod(dims))
    if points is None or points == {2: 5, 3: 7}.get(nd):
        offsets = []
        for ax in range(nd):
            e = np.zeros(nd, dtype=np.int64)
            e[ax] = 1
            offsets += [tuple(e), tuple(-e)]
    elif (nd, points) in ((2, 9), (3, 27)):
        from itertools import product

        offsets = [o for o in product((-1, 0, 1), repeat=nd)
                   if any(o)]
    else:
        raise ValueError(f"unsupported stencil: dims={dims} points={points}")

    idx = np.arange(n, dtype=np.int64).reshape(dims)
    coords = np.unravel_index(np.arange(n, dtype=np.int64), dims)
    rows_l, cols_l, vals_l = [], [], []
    diag = np.full(n, 1e-3, dtype=np.float64)
    for off in offsets:
        # coupling strength: product over axes of (eps if moving along
        # eps_axis else 1); corners get geometric-mean-like weights
        w = float(np.prod([eps if (ax == eps_axis and o != 0) else 1.0
                           for ax, o in enumerate(off)]))
        src = [slice(max(0, -o), dims[ax] - max(0, o))
               for ax, o in enumerate(off)]
        dst = [slice(max(0, o), dims[ax] - max(0, -o))
               for ax, o in enumerate(off)]
        r = idx[tuple(src)].ravel()
        ci = idx[tuple(dst)].ravel()
        rows_l.append(r)
        cols_l.append(ci)
        vals_l.append(np.full(r.size, -w, dtype=np.float64))
        np.add.at(diag, r, w)
    rows_l.append(np.arange(n, dtype=np.int64))
    cols_l.append(np.arange(n, dtype=np.int64))
    vals_l.append(diag)
    return CsrMatrix.from_coo(
        n, n, np.concatenate(rows_l), np.concatenate(cols_l),
        np.concatenate(vals_l).astype(dtype))


def mesh_csr(nx: int, ny: int, seed: int = 0, jitter: float = 0.35,
             dtype=np.float32) -> "CsrMatrix":
    """Unstructured-FEM-style operator: Delaunay triangulation of a
    jittered (nx, ny) point cloud, assembled as the graph Laplacian of the
    triangulation edges (SPD). Irregular node degrees (typ. 4-9) and a
    bandwidth that wanders with the triangulation — the classic
    unstructured-mesh workload no lattice detector should fire on."""
    from scipy.spatial import Delaunay

    from tpusparse.formats.csr import CsrMatrix

    rng = _rng(seed ^ 0xDE1A)
    gx, gy = np.meshgrid(np.arange(nx, dtype=np.float64),
                         np.arange(ny, dtype=np.float64), indexing="ij")
    pts = np.stack([gx.ravel(), gy.ravel()], axis=1)
    pts += rng.uniform(-jitter, jitter, size=pts.shape)
    tri = Delaunay(pts)
    s = tri.simplices                            # (nt, 3)
    e = np.concatenate([s[:, [0, 1]], s[:, [1, 2]], s[:, [0, 2]]])
    e = np.unique(np.sort(e, axis=1), axis=0)
    n = pts.shape[0]
    rows = np.concatenate([e[:, 0], e[:, 1]]).astype(np.int64)
    cols = np.concatenate([e[:, 1], e[:, 0]]).astype(np.int64)
    deg = np.bincount(rows, minlength=n).astype(np.float64)
    r = np.concatenate([rows, np.arange(n, dtype=np.int64)])
    ci = np.concatenate([cols, np.arange(n, dtype=np.int64)])
    v = np.concatenate([-np.ones(rows.size), deg + 1e-3]).astype(dtype)
    return CsrMatrix.from_coo(n, n, r, ci, v)


def banded_defects_csr(n: int, bandwidth: int = 16,
                       defect_density: float = 1e-3, seed: int = 0,
                       dtype=np.float32) -> "CsrMatrix":
    """Banded operator plus sparse long-range 'defect' couplings (circuit /
    perturbed-physics style). The defects give the matrix O(n) distinct
    diagonals at negligible nnz — a pure-DIA router that only counts
    diagonals would store the whole n x n; the structural fill guard must
    catch it."""
    from tpusparse.formats.csr import CsrMatrix

    rng = _rng(seed ^ 0xBADE)
    rows_l, cols_l = [np.arange(n, dtype=np.int64)], [np.arange(n, dtype=np.int64)]
    for off in range(1, bandwidth + 1):
        r = np.arange(n - off, dtype=np.int64)
        rows_l += [r, r + off]
        cols_l += [r + off, r]
    nd = int(round(n * n * defect_density))
    pos = np.unique(rng.integers(0, n * n, size=nd, dtype=np.int64))
    rows_l.append(pos // n)
    cols_l.append(pos % n)
    rows = np.concatenate(rows_l)
    cols = np.concatenate(cols_l)
    pos = np.unique(rows * n + cols)
    r, ci = pos // n, pos % n
    vals = rng.uniform(-1.0, 1.0, size=r.size).astype(dtype)
    vals[vals == 0.0] = 1e-3
    return CsrMatrix.from_coo(n, n, r, ci, vals)


def nm_pruned_matrix(m: int, n: int, n_keep: int = 2, group: int = 4,
                     seed: int = 0, dtype=np.float32) -> np.ndarray:
    """N:M semi-structured pruned weight matrix (e.g. 2:4): in every
    ``group`` consecutive entries along the contraction axis (rows of A,
    the input dim of ``Y = X @ A``), exactly ``n_keep`` survive. This is
    the sparsity modern accelerator pruning recipes emit; its per-window
    nnz is perfectly uniform (w = W_dense * n_keep/group exactly), the
    friendliest case for flat SELL."""
    if m % group:
        raise ValueError(f"m={m} not a multiple of group={group}")
    rng = _rng(seed ^ 0x2424)
    vals = rng.uniform(-1.0, 1.0, size=(m, n)).astype(dtype)
    scores = rng.random((m // group, group, n))
    rank = np.argsort(np.argsort(scores, axis=1), axis=1)
    mask = (rank < n_keep).reshape(m, n)
    a = vals * mask
    a[mask & (a == 0.0)] = 1e-3
    return a.astype(dtype)


def block_pruned_matrix(m: int, n: int, block: int = 128,
                        keep_frac: float = 0.3, fill: float = 0.5,
                        seed: int = 0, dtype=np.float32) -> np.ndarray:
    """Block-pruned weights: ``keep_frac`` of (block x block) tiles survive,
    each with i.i.d. ``fill`` interior density — the structured-pruning
    (and MoE-ish expert-block) weight family TCSR's two-tier storage is
    built for."""
    rng = _rng(seed ^ 0xB10C)
    bm, bn = -(-m // block), -(-n // block)
    blocks = rng.random((bm, bn)) < keep_frac
    if not blocks.any():
        blocks.flat[int(rng.integers(bm * bn))] = True
    mask = np.kron(blocks, np.ones((block, block), dtype=bool))[:m, :n]
    mask &= rng.random((m, n)) < fill
    vals = rng.uniform(-1.0, 1.0, size=(m, n))
    a = vals * mask
    a = np.where(mask & (a == 0.0), 1e-3, a)
    return a.astype(dtype)


def _powerlaw_mask(rng, m, n, density, alpha):
    # Per output column j (columns of A are the "rows" of the contraction,
    # SURVEY.md §0), target nnz ∝ (j+1)^-alpha, scaled to hit global density.
    ranks = np.arange(1, n + 1, dtype=np.float64)
    weights = ranks ** (-alpha)
    weights *= (density * m * n) / weights.sum()
    col_nnz = np.minimum(np.round(weights).astype(np.int64), m)
    cols = rng.permutation(n)  # do not correlate density with column index
    mask = np.zeros((m, n), dtype=bool)
    for j, target in zip(cols, col_nnz):
        if target > 0:
            mask[rng.choice(m, size=target, replace=False), j] = True
    return mask


def _banded_mask(rng, m, n, density, bandwidth):
    if bandwidth is None:
        bandwidth = max(1, int(density * (m + n) / 2))
    rows = np.arange(m)[:, None]
    cols = np.arange(n)[None, :]
    diag = np.abs(rows * (n / m) - cols)
    band = diag <= bandwidth
    # within the band, thin out to hit requested density approximately
    keep = min(1.0, density * m * n / max(band.sum(), 1))
    return band & (rng.random((m, n)) < keep)


def _block_mask(rng, m, n, density, block):
    bm, bn = -(-m // block), -(-n // block)
    blocks = rng.random((bm, bn)) < density
    if density > 0 and not blocks.any():
        # small grids can draw zero active blocks, producing an all-zero
        # "test matrix" that makes correctness checks vacuous
        blocks.flat[int(rng.integers(bm * bn))] = True
    return np.kron(blocks, np.ones((block, block), dtype=bool))[:m, :n]
