"""Smoothed-aggregation algebraic multigrid.

The heaviest canonical consumer of a fast SpMV is a multigrid-preconditioned
Krylov solve: every smoother application, residual, restriction and
prolongation IS a sparse matvec, so the whole V-cycle inherits the format
speeds. This module follows the classic smoothed aggregation construction
(Vanek/Mandel/Brezina '96) with the library's device-shaped choices:

- **Setup is host-side** (numpy/scipy, float64): aggregation, tentative +
  Jacobi-smoothed prolongators, Galerkin triple products. One-time cost,
  like every converter in ``formats/``.
- **The cycle is device-side and fully jittable**: each level's operator,
  restriction ``P`` and prolongation ``Pᵀ`` are packed formats
  (``auto_format`` / ``RsellMatrix.from_csr`` — no densify at any size),
  smoothing is the Chebyshev polynomial smoother (pure SpMVs — no
  Gauss-Seidel triangular sweeps, which are sequential and hostile to a
  wide vector machine; see ``solve.chebyshev_preconditioner`` for the
  rationale), and the coarsest level is a precomputed dense inverse (one
  small matmul at HIGHEST precision).
- **The hierarchy is a registered pytree**, so the preconditioner rides
  through ``jax.jit`` as an ARGUMENT: its arrays are runtime parameters,
  never trace-time constants: closure-captured level matrices would be
  serialized into the program as constants, and eager ``lax.while_loop``
  around fresh closures retraced every ``solve`` call.
  ``amg(r)`` / ``amg.solve(b)`` dispatch through module-level ``jax.jit``
  entry points keyed on the pytree structure: one compile per hierarchy
  shape, ~ms replays after.
- **Symmetric by construction** (identical polynomial pre/post smoothers
  ``p(D⁻¹A)D⁻¹ = D^{-1/2} p(D^{-1/2}AD^{-1/2}) D^{-1/2}``, Galerkin coarse
  operators, exact coarse solve), so the V-cycle is a valid ``m_inv`` for
  ``solve.cg``.

Operator convention matches the library (``fmt.spmv(v) == Aᵀ v``); AMG
requires symmetric ``A``, where that is ``A v``. The reference has no
counterpart (it stops at the kernel benchmark); this is north-star scope,
like ``solve``/``eig``.
"""

from __future__ import annotations

from functools import partial
from typing import Any

import numpy as np

import jax
import jax.numpy as jnp

from tpusparse.formats.csr import CsrMatrix


def _auto_theta(sp) -> float:
    """Strength-spectrum anisotropy detection (theta="auto"): pick the
    drop tolerance from the distribution of normalized
    couplings s_ij = |a_ij| / sqrt(a_ii a_jj) instead of making the user
    know it. Isotropic operators have a unimodal spectrum (5-point
    Laplacian: every s = 1/4) -> theta 0, the standard SA default.
    Anisotropic operators are BIMODAL (eps=100 5-point: strong s ~ 0.5,
    weak s ~ 0.005 in a 50:50 mix) and theta must fall between the modes
    to semicoarsen along the strong direction. Rule: with S = median
    per-row strongest coupling, call entries below S/4 the weak cluster;
    when that cluster holds >= 25% of the off-diagonals AND its median
    sits a decade below S (clear bimodality, not a fat tail), return
    S/4 — the same divisor that defined the cluster — clipped to
    [0.02, 0.25] (the useful band: 0.08 took eps=100 from 33-42 to 8 CG
    iterations). O(nnz),
    recomputed per level.

    Why S/4 and not the geometric mean of the cluster medians (an earlier
    rule): anisotropy SURVIVES one semicoarsening
    pass (a 3x stripe pass reduces the eps=100 ratio by ~9, not to 1),
    and on coarse levels the smoothed prolongator's Galerkin fill floods
    the weak cluster with ~1e-4 junk couplings — measured at 512^2
    axis 1, level 1: weak median collapses 0.005 -> 2e-4 while the
    strong mode stays at 0.458, so the geometric mean fell to the 0.02
    clip floor and over-aggregated 6x where pinned 0.08 still
    semicoarsened 3x (16 vs 8 CG iterations). S/4 tracks the strong
    mode down the hierarchy and is immune to how much junk the fill
    adds below it."""
    n = sp.shape[0]
    indptr, indices, data = sp.indptr, sp.indices, np.abs(sp.data)
    diag = np.abs(sp.diagonal()) + 1e-300
    rows = np.repeat(np.arange(n), np.diff(indptr))
    off = indices != rows
    if not off.any():
        return 0.0
    s = data[off] / np.sqrt(diag[rows[off]] * diag[indices[off]])
    row_max = np.zeros(n)
    np.maximum.at(row_max, rows[off], s)
    strong_typ = float(np.median(row_max[row_max > 0]))
    if strong_typ <= 0:
        return 0.0
    weak = s[s < strong_typ / 4]
    if weak.size < 0.25 * s.size:
        return 0.0
    weak_typ = float(np.median(weak))
    if weak_typ > strong_typ / 10:
        return 0.0
    return float(np.clip(strong_typ / 4, 0.02, 0.25))


def _aggregate(sp, theta: float,
               use_native: bool | None = None) -> tuple[np.ndarray, int]:
    """Standard aggregation (Vanek '96 3-pass) on the strength graph
    ``|a_ij| >= theta * sqrt(a_ii * a_jj)``. Returns (agg ids, n_agg).
    Greedy over node order, so inherently sequential — the C++ fast path
    (native/converters.cpp ``amg_aggregate``, bit-identical, asserted in
    tests) cuts the 1M-node setup loop from ~minutes to ~1 s."""
    n = sp.shape[0]
    indptr, indices, data = sp.indptr, sp.indices, np.abs(sp.data)
    diag = np.abs(sp.diagonal()) + 1e-300
    if use_native is not False:
        from tpusparse import native

        res = native.amg_aggregate(indptr, indices, data, diag, theta)
        if res is not None:
            return res
    # strength mask per stored entry (off-diagonal, above threshold)
    rows = np.repeat(np.arange(n), np.diff(indptr))
    strong = (indices != rows) & \
        (data >= theta * np.sqrt(diag[rows] * diag[indices]) + 1e-300)

    agg = np.full(n, -1, np.int64)
    next_id = 0
    # pass 1: seed aggregates from fully-unaggregated strong neighborhoods
    for i in range(n):
        if agg[i] != -1:
            continue
        sl = slice(indptr[i], indptr[i + 1])
        nbrs = indices[sl][strong[sl]]
        if (agg[nbrs] == -1).all():
            agg[i] = next_id
            agg[nbrs] = next_id
            next_id += 1
    # pass 2: attach leftovers to the strongest adjacent aggregate
    # (decided against the pass-1 state so attachments don't chain)
    pass1 = agg.copy()
    for i in range(n):
        if agg[i] != -1:
            continue
        sl = slice(indptr[i], indptr[i + 1])
        nbrs = indices[sl][strong[sl]]
        w = data[sl][strong[sl]]
        hit = pass1[nbrs] != -1
        if hit.any():
            agg[i] = pass1[nbrs[hit][np.argmax(w[hit])]]
    # pass 3: remaining nodes form aggregates of what's left around them
    for i in range(n):
        if agg[i] != -1:
            continue
        sl = slice(indptr[i], indptr[i + 1])
        nbrs = indices[sl][strong[sl]]
        grp = np.concatenate([[i], nbrs[agg[nbrs] == -1]])
        agg[grp] = next_id
        next_id += 1
    return agg, next_id


def _lmax_dinv_a(sp, dinv: np.ndarray, iters: int = 20,
                 seed: int = 0) -> float:
    """Power-iteration estimate of lambda_max(D^-1 A) (host, float64)."""
    rng = np.random.default_rng(seed)
    v = rng.normal(size=sp.shape[0])
    v /= np.linalg.norm(v)
    lam = 1.0
    for _ in range(iters):
        w = dinv * (sp @ v)
        lam = np.linalg.norm(w)
        if lam == 0.0:
            return 1.0
        v = w / lam
    return float(lam)


def _dbg(msg: str) -> None:
    """Setup-stage timing prints, gated by TPUSPARSE_AMG_DEBUG=1 (the
    heavy stages — Galerkin products, packing, upload — are otherwise
    invisible on 1M-unknown hierarchies)."""
    import os
    import time

    if os.environ.get("TPUSPARSE_AMG_DEBUG"):
        print(f"[amg {time.strftime('%H:%M:%S')}] {msg}", flush=True)


_GRID_HALO = 4       # max stencil half-width accepted as "still a lattice"


def _detect_grid(sp) -> int | None:
    """Row stride ``C`` when ``sp`` is a lattice stencil on a row-major
    ``(R, C)`` grid — every nonzero offset decomposes as ``a + b*C`` with
    ``|a|, |b| <= _GRID_HALO`` — else None. Accepting a halo (not just
    the 5/9-point pattern) matters because Galerkin coarse operators grow:
    a 5-point fine stencil under 3x3 smoothed aggregation coarsens to a
    ~9-point, then wider, lattice stencil; detection must recurse down
    the hierarchy or deeper levels fall back to packed sparse carriers
    (the 512^2 level's 25-point stencil would otherwise go greedy and pay
    for packing RSELL prolongators)."""
    n = sp.shape[0]
    if sp.nnz == 0:
        return None
    rows = np.repeat(np.arange(n), np.diff(sp.indptr))
    offs = np.unique(sp.indices - rows)
    pos = offs[offs > _GRID_HALO]
    if pos.size == 0:
        return None
    h = _GRID_HALO
    # Candidates bracket the smallest beyond-halo offset; NO lower floor —
    # a narrow lattice (C <= 2h+1) is real (review r2: a 5000x6 grid was
    # mis-decomposed at c=10 and a 512x8 grid not detected at all). The
    # |a| bound tightens to the balanced residue (c-1)//2 so narrow-c
    # decompositions stay unique, and among valid candidates the one with
    # the tightest stencil wins. Tightness is the SUM of |a|+|b| over all
    # offsets (ties to the larger c): on a 5-point stencil the true C
    # scores 4 while C+1 scores 6, so the true row stride wins even when
    # (C+1) divides n — the max-based score tied there and mis-picked C+1
    # (advisor r2: 12x11 grids aggregated across row boundaries, costing
    # one extra CG iteration).
    best = None
    for c in range(max(int(pos.min()) - h, 2), int(pos.min()) + h + 1):
        if n % c or n // c < 4:
            continue
        b = np.rint(offs / c).astype(np.int64)
        a = offs - b * c
        if np.abs(a).max() <= min(h, (c - 1) // 2) and np.abs(b).max() <= h:
            score = (int(np.abs(a).sum() + np.abs(b).sum()), -c)
            if best is None or score < best[0]:
                best = (score, c)
    return best[1] if best else None


def _apply(op, v):
    """``v -> v @ op`` for a dense device array or a packed format."""
    if isinstance(op, jax.Array):
        # HIGHEST: an fp32 matmul may otherwise run in TF32
        return jnp.dot(v, op, precision=jax.lax.Precision.HIGHEST)
    return op.spmv(v)


@jax.tree_util.register_pytree_node_class
class _ShardedOp:
    """A level operator (or prolongator carrier) as CONTIGUOUS ragged-SELL
    column shards over a device mesh — the carrier that lets greedy/Vanek
    hierarchies shard (``shard()`` alone cannot place the unstructured
    problems AMG exists for).

    Tree leaves are the per-shard chunk streams, device_put with
    ``NamedSharding(mesh, P('n'))`` on their shard axis (dim 0) at
    construction; the mesh rides the static aux (hashable). ``spmv``
    matches the packed-format protocol ``_apply`` dispatches on, so
    V-cycles and solves are oblivious to the sharding: each apply is one
    shard_map over the resident shards, and GSPMD inserts the gather when
    the column-sharded result feeds the next replicated input.

    ``assignment='contiguous'`` (formats/rsell.py) is load-balanced enough
    for Galerkin operators (near-uniform degrees) and — unlike
    balance/sorted — needs no output permutation, whose one-hot unpermute
    plan is O(n^2/128) bytes and pathological at AMG level sizes.
    """

    def __init__(self, cj, ct, idx, vals, group_map, shape, padded, nnz,
                 mesh):
        self.cj, self.ct, self.idx, self.vals = cj, ct, idx, vals
        self.group_map = group_map
        self.shape, self.padded, self.nnz = shape, padded, nnz
        self.mesh = mesh
        self.perm_plan = None          # contiguous shards: already in order

    @property
    def n_shards(self) -> int:
        return self.cj.shape[0]

    def tree_flatten(self):
        return ((self.cj, self.ct, self.idx, self.vals, self.group_map),
                (self.shape, self.padded, self.nnz, self.mesh))

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, *aux)

    @classmethod
    def from_scipy(cls, sp, mesh) -> "_ShardedOp":
        from jax.sharding import NamedSharding, PartitionSpec

        from tpusparse.formats.rsell import rsell_shard_pack

        csr = CsrMatrix.from_scipy(sp.astype(np.float32))
        shards = rsell_shard_pack(csr, mesh.shape["n"],
                                  assignment="contiguous")
        spec = NamedSharding(mesh, PartitionSpec("n"))

        def put(a):
            return jax.device_put(jnp.asarray(a), spec)

        return cls(put(shards.cj), put(shards.ct), put(shards.idx),
                   put(shards.vals), put(shards.group_map), shards.shape,
                   shards.padded, int(shards.nnz), mesh)

    def spmv(self, v):
        from tpusparse.parallel.sparse import rsell_spmm_sharded

        return rsell_spmm_sharded(self, v, self.mesh)

    def device_bytes(self) -> int:
        return sum(a.nbytes for a in (self.cj, self.ct, self.idx,
                                      self.vals))

    def __repr__(self) -> str:
        return (f"_ShardedOp(shape={self.shape}, nnz={self.nnz}, "
                f"D={self.n_shards})")


@jax.tree_util.register_pytree_node_class
class _Level:
    """One hierarchy level. Pytree: arrays/formats are leaves (runtime
    jit arguments), sizes and format names are static aux.

    ``kind``: how grid transfers run on device.
    - ``"packed"``: ``p``/``pt`` are packed sparse carriers of the
      smoothed prolongator (greedy Vanek aggregates — arbitrary graphs).
    - ``"block"``: aggregates are CONSECUTIVE index blocks, so the
      tentative ``P0`` is a reshape + weighted sum (``p`` holds only the
      ``(nc, s)`` weight table; ``pt`` is None).
    - ``"grid"``: the level is a detected row-major R x C lattice
      (``shape2d = (R, C, s)``); aggregates are s x s spatial blocks, so
      ``P0ᵀ`` is a strided reshape-sum over the (R, C) view and ``P0``
      the matching broadcast (``p`` holds the per-fine-node weights
      ``1/sqrt(|agg|)``; ``pt`` is None). No sparse carrier, no gather: slot
      formats pad a ~2-nnz-per-row prolongator 10-16x through the 8-slot
      chunk quantum, while the reshape-sum is a fused XLA vector pass.

    "block" and "grid" apply the SMOOTHED transfers through the identity
    ``Pᵀr = P0ᵀ(r − (ω/λ)A d⁻¹r)`` / ``Pe = (I − (ω/λ)d⁻¹A) P0e`` — one
    extra apply of the level operator that is ALREADY packed (DIA on
    banded levels), instead of a separate sparse carrier.
    """

    def __init__(self, a, p, pt, dinv, lmax, n, nnz, fmt, kind="packed",
                 shape2d=None):
        self.a, self.p, self.pt = a, p, pt
        self.dinv, self.lmax = dinv, lmax
        self.n, self.nnz, self.fmt, self.kind = n, nnz, fmt, kind
        self.shape2d = shape2d

    def tree_flatten(self):
        return ((self.a, self.p, self.pt, self.dinv, self.lmax),
                (self.n, self.nnz, self.fmt, self.kind, self.shape2d))

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, *aux)

    @property
    def apply_a(self):
        """``v -> A v`` for this level's operator (dense or packed)."""
        return partial(_apply, self.a)


@jax.tree_util.register_pytree_node_class
class SmoothedAggregationAMG:
    """One V-cycle per ``__call__`` — a symmetric positive definite
    approximation of ``A⁻¹``, ready to drop in as ``m_inv`` for
    ``solve.cg`` (or used standalone: ``solve(b)``).

    Build with :func:`smoothed_aggregation`. The object is a pytree;
    ``amg(r)``/``amg.solve(b)`` run through cached module-level ``jax.jit``
    entry points, and the object can also be passed straight into user
    ``jit``/``shard_map`` code like any packed format.
    """

    def __init__(self, levels: tuple, coarse_inv: jnp.ndarray,
                 theta: float, degree: int, ratio: float,
                 omega: float = 4.0 / 3.0):
        self.levels = tuple(levels)
        self.coarse_inv = coarse_inv
        self.theta = theta
        self.degree = degree
        self.ratio = ratio
        self.omega = omega

    def tree_flatten(self):
        return ((self.levels, self.coarse_inv),
                (self.theta, self.degree, self.ratio, self.omega))

    @classmethod
    def tree_unflatten(cls, aux, children):
        levels, coarse_inv = children
        return cls(levels, coarse_inv, *aux)

    # -- stats ---------------------------------------------------------
    @property
    def operator_complexity(self) -> float:
        return sum(l.nnz for l in self.levels) / max(self.levels[0].nnz, 1)

    @property
    def grid_complexity(self) -> float:
        return sum(l.n for l in self.levels) / max(self.levels[0].n, 1)

    def __repr__(self) -> str:
        tag = {"block": "|blk", "grid": "|grid"}
        rows = ", ".join(
            f"{l.n}({l.fmt}{tag.get(l.kind, '')},"
            f"nnz={l.nnz})" for l in self.levels)
        return (f"SmoothedAggregationAMG(levels=[{rows}], "
                f"op_cx={self.operator_complexity:.2f}, "
                f"grid_cx={self.grid_complexity:.2f}, "
                f"degree={self.degree})")

    # -- the cycle -----------------------------------------------------
    def _smooth(self, lev: _Level, r: jnp.ndarray) -> jnp.ndarray:
        """Chebyshev smoother z ~ A⁻¹ r targeting [lmax/ratio, 1.05 lmax]
        of D⁻¹A (same recurrence as solve.chebyshev_preconditioner,
        inlined so the coefficients come from pytree leaves)."""
        lmax = 1.05 * lev.lmax
        lmin = lev.lmax / self.ratio
        theta = (lmax + lmin) / 2.0
        delta = (lmax - lmin) / 2.0
        sigma = theta / delta
        v = lev.dinv * r
        rho = 1.0 / sigma
        d = v / theta
        z = d
        res = v - lev.dinv * _apply(lev.a, z)
        for _ in range(self.degree - 1):
            rho_new = 1.0 / (2.0 * sigma - rho)
            d = (rho_new * rho) * d + (2.0 * rho_new / delta) * res
            z = z + d
            res = res - lev.dinv * _apply(lev.a, d)
            rho = rho_new
        return z

    def _p0t(self, lev: _Level, v: jnp.ndarray) -> jnp.ndarray:
        """``P0ᵀ v`` — weighted aggregate reduction, carrier-free."""
        if lev.kind == "grid":
            R, C, s = lev.shape2d
            g = (v * lev.p).reshape(R, C)
            if R % s or C % s:
                g = jnp.pad(g, ((0, -R % s), (0, -C % s)))
            return g.reshape(-(-R // s), s, -(-C // s), s) \
                    .sum(axis=(1, 3)).reshape(-1)
        w0 = lev.p                       # block: (nc, s) weight table
        v = jnp.pad(v, (0, w0.shape[0] * w0.shape[1] - lev.n))
        return (v.reshape(w0.shape) * w0).sum(axis=1)

    def _p0(self, lev: _Level, e: jnp.ndarray) -> jnp.ndarray:
        """``P0 e`` — weighted aggregate broadcast, carrier-free."""
        if lev.kind == "grid":
            R, C, s = lev.shape2d
            rc, cc = -(-R // s), -(-C // s)
            u = jnp.broadcast_to(e.reshape(rc, 1, cc, 1), (rc, s, cc, s))
            return u.reshape(s * rc, s * cc)[:R, :C].reshape(-1) * lev.p
        return (e[:, None] * lev.p).reshape(-1)[: lev.n]

    def _restrict(self, lev: _Level, r: jnp.ndarray) -> jnp.ndarray:
        if lev.kind == "packed":
            return _apply(lev.p, r)
        # Pᵀ r = P0ᵀ (r − (ω/λ) A d⁻¹ r)
        rs = r - (self.omega / lev.lmax) * _apply(lev.a, lev.dinv * r)
        return self._p0t(lev, rs)

    def _prolong(self, lev: _Level, e: jnp.ndarray) -> jnp.ndarray:
        if lev.kind == "packed":
            return _apply(lev.pt, e)
        # P e = (I − (ω/λ) d⁻¹ A) P0 e
        u = self._p0(lev, e)
        return u - (self.omega / lev.lmax) * (lev.dinv * _apply(lev.a, u))

    def _cycle(self, li: int, r: jnp.ndarray) -> jnp.ndarray:
        lev = self.levels[li]
        if li == len(self.levels) - 1:               # coarsest: exact solve
            return jnp.dot(r, self.coarse_inv,
                           precision=jax.lax.Precision.HIGHEST)
        x = self._smooth(lev, r)                     # pre-smooth (zero guess)
        rc = self._restrict(lev, r - _apply(lev.a, x))
        x = x + self._prolong(lev, self._cycle(li + 1, rc))
        return x + self._smooth(lev, r - _apply(lev.a, x))   # post-smooth

    def __call__(self, r: jnp.ndarray) -> jnp.ndarray:
        return _amg_apply(self, jnp.asarray(r))

    def solve(self, b, x0=None, *, tol: float = 1e-5, atol: float = 0.0,
              maxiter: int | None = None):
        """AMG-preconditioned CG on the finest operator (one jitted
        program per hierarchy structure — replays are pure device time)."""
        return _amg_solve(self, jnp.asarray(b),
                          None if x0 is None else jnp.asarray(x0),
                          tol, atol, maxiter)

    def shard(self, mesh, axis: str = "n") -> "SmoothedAggregationAMG":
        """Multi-chip placement: a copy of the hierarchy with every
        n-sized leaf sharded slab-wise over ``mesh`` axis ``axis``
        (indivisible/coarse leaves replicated).

        This is pure GSPMD — no shard_map, no hand-written collectives.
        ``grid``/``block`` hierarchies over DIA or dense level operators
        lower to XLA ops only (statically shifted slices, reshape-sums,
        matmuls), so these placement hints are all jit needs to partition
        the entire V-cycle/solve: DIA's ±offset slices become halo
        ``collective-permute``s (comm ∝ bandwidth, not n), grid
        transfers stay shard-local up to aggregate-boundary exchanges,
        and CG dot products become ``psum``s. Levels whose n is not
        divisible by the mesh axis (small coarse grids) replicate; GSPMD
        inserts the gather at the transfer boundary automatically.

        Greedy (``"packed"``) levels carry packed-format operators and
        prolongator carriers with no n-sized axis to split — build with
        ``aggregation="grid"``/``"block"`` (lattices / narrow bands,
        exactly the structures AMG fits best) for sharded solves, or
        raise ``dense_cutoff`` so carriers stay dense.
        """
        from jax.sharding import NamedSharding, PartitionSpec

        from tpusparse.formats.dia import DiaMatrix

        d = mesh.shape[axis]
        rep = NamedSharding(mesh, PartitionSpec())

        def place(lev: _Level) -> _Level:
            if any(isinstance(o, _ShardedOp)
                   for o in (lev.a, lev.p, lev.pt)):
                # greedy level built with setup(mesh=...): operator and
                # carrier shards were device_put with explicit shardings
                # at construction — only the level vectors need placing
                # (replicated: every shard reads the whole input vector)
                def put_v(x):
                    return x if isinstance(x, _ShardedOp) \
                        else jax.tree_util.tree_map(
                            lambda l: jax.device_put(l, rep), x)

                return _Level(put_v(lev.a), put_v(lev.p), put_v(lev.pt),
                              put_v(lev.dinv), put_v(lev.lmax),
                              lev.n, lev.nnz, lev.fmt, lev.kind,
                              lev.shape2d)
            ok_op = isinstance(lev.a, (jax.Array, DiaMatrix))
            ok_tr = lev.kind in ("grid", "block") or all(
                c is None or isinstance(c, jax.Array)
                for c in (lev.p, lev.pt))
            if not (ok_op and ok_tr):
                raise ValueError(
                    f"level n={lev.n} ({lev.fmt}|{lev.kind}) holds "
                    "packed operators/carriers with no n-sized axis to "
                    "place; build greedy hierarchies SHARDED from the "
                    "start with smoothed_aggregation(..., mesh=mesh) "
                    "(ragged-SELL column shards), or use "
                    "aggregation='grid'/'block' (or raise dense_cutoff) "
                    "for this post-hoc GSPMD placement")

            def put(x):
                if x.ndim and x.shape[-1] == lev.n and lev.n % d == 0:
                    spec = PartitionSpec(*([None] * (x.ndim - 1)), axis)
                    return jax.device_put(x, NamedSharding(mesh, spec))
                return jax.device_put(x, rep)

            return jax.tree_util.tree_map(put, lev)

        return SmoothedAggregationAMG(
            tuple(place(l) for l in self.levels),
            jax.device_put(self.coarse_inv, rep),
            self.theta, self.degree, self.ratio, self.omega)

    # -- persistence ---------------------------------------------------
    def save(self, path) -> None:
        """Persist the whole hierarchy to one ``.npz``. Setup —
        aggregation, Galerkin products, packing, upload: seconds at 1M
        unknowns against a solve of milliseconds — amortizes across
        processes; ``load`` restores a solve-ready preconditioner for
        upload-time only. Packed-format carriers round-trip through
        ``formats.io.encode``; dense levels, grid/block transfer
        metadata, and smoother constants ride the manifest. Save the
        un-sharded hierarchy (``load`` places on the default device;
        re-apply ``shard(mesh)`` after loading)."""
        from tpusparse.formats import io as _io

        if any(isinstance(o, _ShardedOp) for lev in self.levels
               for o in (lev.a, lev.p, lev.pt)):
            raise ValueError(
                "sharded hierarchies (setup(mesh=...)) are not saveable: "
                "persist the unsharded build and re-setup with mesh")
        arrays: dict[str, np.ndarray] = {}
        man_levels = []
        for i, lev in enumerate(self.levels):
            comps = {}
            for name in ("a", "p", "pt", "dinv"):
                obj = getattr(lev, name)
                if obj is None:
                    comps[name] = ("none",)
                elif isinstance(obj, (jax.Array, np.ndarray)):
                    arrays[f"L{i}_{name}"] = np.asarray(obj)
                    comps[name] = ("arr",)
                else:
                    kind, aux_r, dtypes_r, arrs = _io.encode(obj)
                    for j, a in enumerate(arrs):
                        arrays[f"L{i}_{name}_{j}"] = a
                    comps[name] = ("fmt", kind, aux_r, dtypes_r, len(arrs))
            man_levels.append(dict(
                n=lev.n, nnz=lev.nnz, fmt=lev.fmt, kind=lev.kind,
                shape2d=lev.shape2d,
                lmax=None if lev.lmax is None else float(lev.lmax),
                comps=comps))
        manifest = dict(version=1,
                        params=(float(self.theta), int(self.degree),
                                float(self.ratio), float(self.omega)),
                        levels=man_levels)
        np.savez_compressed(path, manifest=np.asarray(repr(manifest)),
                            coarse_inv=np.asarray(self.coarse_inv),
                            **arrays)

    @classmethod
    def load(cls, path) -> "SmoothedAggregationAMG":
        """Restore a hierarchy saved by :meth:`save` — see there."""
        import ast

        from tpusparse.formats import io as _io

        z = np.load(path, allow_pickle=False)
        if "manifest" not in z.files:
            raise ValueError(f"{path}: not a tpusparse AMG checkpoint")
        man = ast.literal_eval(str(z["manifest"]))
        if not isinstance(man, dict) or man.get("version") != 1:
            raise ValueError(f"{path}: unsupported AMG checkpoint version")
        levels = []
        for i, lm in enumerate(man["levels"]):
            vals = {}
            for name in ("a", "p", "pt", "dinv"):
                tag = lm["comps"][name]
                if tag[0] == "none":
                    vals[name] = None
                elif tag[0] == "arr":
                    vals[name] = jax.device_put(
                        jnp.asarray(z[f"L{i}_{name}"]))
                else:
                    _, kind, aux_r, dtypes_r, n_arr = tag
                    arrs = [z[f"L{i}_{name}_{j}"] for j in range(n_arr)]
                    fmt = _io.decode(kind, aux_r, dtypes_r, arrs,
                                     where=f"{path}[L{i}.{name}]")
                    vals[name] = jax.device_put(fmt)
            lmax = None if lm["lmax"] is None else jnp.float32(lm["lmax"])
            shape2d = lm["shape2d"]
            levels.append(_Level(
                vals["a"], vals["p"], vals["pt"], vals["dinv"], lmax,
                lm["n"], lm["nnz"], lm["fmt"], lm["kind"],
                None if shape2d is None else tuple(shape2d)))
        th, dg, ra, om = man["params"]
        return cls(tuple(levels),
                   jax.device_put(jnp.asarray(z["coarse_inv"])),
                   th, dg, ra, om)


@jax.jit
def _amg_apply(amg: SmoothedAggregationAMG, r: jnp.ndarray) -> jnp.ndarray:
    return amg._cycle(0, r)


@partial(jax.jit, static_argnames=("tol", "atol", "maxiter"))
def _amg_solve(amg, b, x0, tol, atol, maxiter):
    from tpusparse.solve import cg

    return cg(amg.levels[0].apply_a, b, x0, tol=tol, atol=atol,
              maxiter=maxiter, m_inv=lambda r: amg._cycle(0, r))


def _pack(sp, dense_cutoff: int, square: bool):
    """Pack a host scipy matrix as ``v -> v @ sp``: dense device array
    below the cutoff, else a packed format (auto-routed for the square
    level operators; RSELL for the tall/thin prolongators, whose nnz live
    in a thin diagonal band of tiles — per-tile ragged widths skip the
    empty ones, where one global SELL width would stream the whole
    ``(m/128) x (n/128)`` tile grid at max width)."""
    m, n = sp.shape
    if max(m, n) <= dense_cutoff:
        return jnp.asarray(sp.toarray().astype(np.float32)), "dense"
    from tpusparse.formats.auto import auto_format
    from tpusparse.formats.rsell import RsellMatrix, rsell_pack_csr

    _dbg(f"  _pack {sp.shape}: converting to CsrMatrix")
    csr = CsrMatrix.from_scipy(sp.astype(np.float32))
    _dbg(f"  _pack {sp.shape}: packing format")
    if square:
        fmt = auto_format(csr)
    else:
        # prolongators are tall/thin with nnz in a thin band of tiles:
        # RSELL's contiguous chunk stream skips the empty tiles.
        # sort=False: the band IS the locality — the SELL-sigma column
        # sort would scatter it across tiles, and its n-sized unpermute
        # plan is pathological at 1M fine columns.
        fmt = RsellMatrix(**rsell_pack_csr(csr, sort=False))
    _dbg(f"  _pack {sp.shape}: {type(fmt).__name__} built, uploading")
    # device-resident leaves: the hierarchy is passed INTO jit as an
    # argument each call, and host leaves would re-upload every time
    fmt = jax.device_put(fmt)
    _dbg(f"  _pack {sp.shape}: upload done")
    return fmt, type(fmt).__name__


def smoothed_aggregation(a, *, theta: float | str = "auto", degree: int = 2,
                         ratio: float = 8.0, coarse_size: int = 400,
                         max_levels: int = 12, omega: float = 4.0 / 3.0,
                         dense_cutoff: int = 2048,
                         aggregation: str = "auto", block_size: int = 8,
                         grid_block: int = 3, sym_tol: float = 1e-6,
                         mesh=None) -> SmoothedAggregationAMG:
    """Build a smoothed-aggregation AMG hierarchy for symmetric ``a``.

    ``a`` — ``CsrMatrix``, scipy sparse, or dense ndarray (SPD system
    matrix). ``theta`` — strength-of-connection drop tolerance. The
    default ``"auto"`` detects anisotropy from the normalized coupling
    spectrum per level (``_auto_theta``): unimodal spectra (isotropic
    operators) resolve to 0 — the standard SA default, every stored
    off-diagonal kept — while bimodal spectra resolve to the gap between
    the modes. Background: at eps=100 (512^2, both orientations)
    theta=0 converges in 33-42 CG iterations vs 7 isotropic, while
    theta~0.08 restores 8 iterations by semicoarsening along the strong
    direction — at ~2.8x operator complexity (1.34 -> 3.7-3.8), the
    standard SA trade; ``"auto"``
    makes that trade without the user knowing the knob. Pass a float to
    pin it (0 reproduces the old default behavior). ``degree`` —
    Chebyshev smoother degree; each V-cycle costs ~``2 * degree + 2``
    SpMVs per level. ``ratio`` — the smoother targets
    ``[lmax/ratio, 1.05 * lmax]`` of ``D⁻¹A`` (the aggressive-smoothing
    convention; coarse grids handle the rest). ``omega`` — prolongator
    Jacobi damping, ``P = (I - omega/lmax * D⁻¹A) P_tent``.
    Levels coarser than ``dense_cutoff`` switch from packed formats to
    dense device matmuls; ``coarse_size`` caps the hierarchy with a
    precomputed dense inverse.

    ``aggregation`` — per-level transfer strategy (see ``_Level``):
    ``"greedy"`` (Vanek 3-pass + packed sparse prolongator carriers),
    ``"grid"`` (detected row-major R x C lattice; aggregates =
    ``grid_block`` x ``grid_block`` spatial blocks — default 3, the
    Vanek aggregate diameter; transfers = strided reshape-sums + one
    extra apply of the level operator — no carriers, no gathers),
    ``"block"``
    (aggregates = ``block_size`` consecutive indices; transfers become
    reshapes the same way), or ``"auto"``: block on levels whose
    bandwidth is within ``2 * block_size`` (chain/ODE stencils, where
    index strips ARE graph neighborhoods), greedy elsewhere — including
    detected lattices, where greedy's packed carriers avoid grid's extra
    operator applies; pass ``aggregation="grid"`` explicitly to trade
    V-cycle/solve time for faster setup. Wider non-lattice bands must
    stay greedy: 1-D strips on a 2-D grid's band semicoarsen one
    direction only and CG iterations blow up 6 -> 61 (1024^2 Laplacian).

    ``mesh`` — build a MULTI-CHIP hierarchy: greedy levels larger than
    ``dense_cutoff`` pack their operator AND prolongator carriers as
    contiguous ragged-SELL column shards over ``mesh`` axis ``"n"``
    (``_ShardedOp``), so unstructured problems shard too — grid/block
    levels keep their pure-XLA transfers and get GSPMD placement, exactly
    as ``shard()`` does. Sharding must happen at setup for greedy because
    the packed carriers cannot be re-split afterwards (the host
    CSR is gone); ``shard(mesh)`` remains the post-hoc path for
    grid/block hierarchies. Sharded hierarchies are not ``save()``-able —
    persist the unsharded build and re-setup with ``mesh``.
    """
    from scipy import sparse as ssp

    from tpusparse.utils import enable_compile_cache

    enable_compile_cache()     # hierarchies compile many programs; cache them
    if isinstance(a, CsrMatrix):
        sp = a.to_scipy().tocsr().astype(np.float64)
    elif ssp.issparse(a):
        sp = a.tocsr().astype(np.float64)
    else:
        sp = ssp.csr_matrix(np.asarray(a, np.float64))
    if sp.shape[0] != sp.shape[1]:
        raise ValueError(f"AMG needs a square matrix, got {sp.shape}")
    asym = abs(sp - sp.T)
    if asym.nnz and asym.max() > sym_tol * max(abs(sp).max(), 1e-300):
        raise ValueError("AMG requires a symmetric matrix "
                         f"(max|A - A.T| = {asym.max():.3g})")
    if aggregation not in ("auto", "greedy", "block", "grid"):
        raise ValueError(f"aggregation must be auto|greedy|block|grid, "
                         f"got {aggregation!r}")

    levels: list[_Level] = []
    theta_resolved = None if theta == "auto" else float(theta)
    while sp.shape[0] > coarse_size and len(levels) < max_levels - 1:
        n = sp.shape[0]
        diag = sp.diagonal()
        dinv_h = 1.0 / np.where(np.abs(diag) > 1e-300, diag, 1.0)
        lmax = _lmax_dinv_a(sp, dinv_h)

        mode = aggregation
        grid_c = _detect_grid(sp) if mode == "grid" else None
        if mode == "auto":
            rows = np.repeat(np.arange(n), np.diff(sp.indptr))
            bw = int(np.abs(sp.indices - rows).max()) if sp.nnz else 0
            # auto stays GREEDY on detected lattices: its packed carriers
            # avoid grid mode's extra per-level operator applies — grid's
            # win is setup time, an explicit opt-in. 1-D block
            # strips are graph-local ONLY on truly narrow bands
            # (chains/ODE stencils): on a 2-D grid's bw=side band,
            # strips semicoarsen one direction and CG iterations blow
            # up 6 -> 61 (measured, 1024^2 Laplacian)
            if n >= 4096 and bw <= 2 * block_size:
                # thin 2-D lattices pass the bandwidth gate but must NOT
                # take 1-D strips (semicoarsening: a 512x12 grid measured
                # 9 CG iters under strips vs 5 greedy — review r2). A
                # detected row stride plus a GAP in the offset set is 2-D
                # structure; contiguous narrow bands (chains, ODE
                # stencils) keep the strip fast path.
                offs = np.unique(sp.indices - rows)
                contiguous = offs.size == int(offs.max() - offs.min()) + 1
                if not contiguous and _detect_grid(sp) is not None:
                    mode = "greedy"
                else:
                    mode = "block"
            else:
                mode = "greedy"
        shape2d = None
        if mode == "grid":
            if grid_c is None:
                raise ValueError("aggregation='grid' but no row-major "
                                 "lattice structure detected")
            gs = grid_block
            shape2d = (n // grid_c, grid_c, gs)
            r0, c0 = np.divmod(np.arange(n), grid_c)
            cc = -(-grid_c // gs)
            agg = (r0 // gs) * cc + (c0 // gs)
            n_agg = (-(-shape2d[0] // gs)) * cc
        elif mode == "block":
            agg = np.arange(n) // block_size
            n_agg = int(agg[-1]) + 1
        else:
            lvl_theta = _auto_theta(sp) if theta == "auto" else theta
            if theta_resolved is None:
                theta_resolved = lvl_theta       # finest greedy level's pick
            agg, n_agg = _aggregate(sp, lvl_theta)
            if n_agg >= n:        # aggregation stalled (all singletons)
                break
        # tentative prolongator: unit-normalized aggregate indicators
        counts = np.bincount(agg, minlength=n_agg).astype(np.float64)
        p0 = ssp.csr_matrix(
            (1.0 / np.sqrt(counts[agg]), (np.arange(n), agg)),
            shape=(n, n_agg))
        # Jacobi smoothing: P = (I - omega/lmax D^-1 A) P0
        da = ssp.diags(dinv_h * (omega / max(lmax, 1e-30))) @ sp
        p = (p0 - da @ p0).tocsr()

        _dbg(f"level n={n}: aggregated ({mode}), packing A")
        shard_lvl = mesh is not None and mode == "greedy" \
            and n > dense_cutoff
        if shard_lvl:
            a_op, fmt_name = _ShardedOp.from_scipy(sp, mesh), "rsell-shard"
        else:
            a_op, fmt_name = _pack(sp, dense_cutoff, square=True)
        _dbg(f"level n={n}: A packed ({fmt_name})")
        dinv_d = jnp.asarray(dinv_h.astype(np.float32))
        if mode == "grid":
            # device transfers need only the per-fine-node weights: 2x2
            # spatial aggregates are strided reshapes over the (R, C) view
            wf = (1.0 / np.sqrt(counts[agg])).astype(np.float32)
            levels.append(_Level(
                a_op, jnp.asarray(wf), None, dinv_d, jnp.float32(lmax),
                n, sp.nnz, fmt_name, kind="grid", shape2d=shape2d))
        elif mode == "block":
            # device transfers need only the (nc, s) weight table: block
            # aggregates are row-major contiguous, so the flat per-node
            # weights fill it directly
            w0 = np.zeros((n_agg, block_size), np.float32)
            w0.ravel()[:n] = (1.0 / np.sqrt(counts[agg])).astype(np.float32)
            levels.append(_Level(
                a_op, jnp.asarray(w0), None, dinv_d, jnp.float32(lmax),
                n, sp.nnz, fmt_name, kind="block"))
        else:
            if shard_lvl:
                # carriers shard over their OUTPUT columns: P over the
                # coarse ids, Pt over the fine ids — each apply is one
                # shard_map, vectors stay replicated between levels
                p_op = _ShardedOp.from_scipy(p, mesh)
                _dbg(f"level n={n}: P sharded")
                pt_op = _ShardedOp.from_scipy(p.T.tocsr(), mesh)
                _dbg(f"level n={n}: Pt sharded")
            else:
                p_op, _ = _pack(p, dense_cutoff, square=False)
                _dbg(f"level n={n}: P packed")
                pt_op, _ = _pack(p.T.tocsr(), dense_cutoff, square=False)
                _dbg(f"level n={n}: Pt packed")
            levels.append(_Level(
                a_op, p_op, pt_op, dinv_d, jnp.float32(lmax),
                n, sp.nnz, fmt_name))
        sp = (p.T @ sp @ p).tocsr()
        _dbg(f"level n={n}: Galerkin product done (next n={sp.shape[0]})")

    if sp.shape[0] > max(4 * coarse_size, 8192):
        # aggregation stalled (e.g. theta dropped every connection as
        # weak, or max_levels hit early) — refuse rather than densify +
        # O(n^3)-invert an arbitrarily large remainder on the host
        raise ValueError(
            f"coarsening stalled at n={sp.shape[0]:,} (coarse_size="
            f"{coarse_size}): every node became a singleton or max_levels"
            f"={max_levels} ran out. Lower theta (strength threshold), "
            f"raise max_levels, or raise coarse_size.")
    a_op, fmt_name = _pack(sp, dense_cutoff, square=True)
    levels.append(_Level(a_op, None, None, None, None, sp.shape[0], sp.nnz,
                         fmt_name))
    # coarse inverse, float64 on host then cast; applied as v @ inv(A)
    # (symmetric, so the row-vector convention needs no transpose)
    coarse_inv = jnp.asarray(np.linalg.inv(sp.toarray()).astype(np.float32))
    # self.theta is always a float (save() stores it positionally): for
    # "auto" record the finest greedy level's resolved pick (0.0 when no
    # greedy level ran — grid/block hierarchies never threshold)
    out = SmoothedAggregationAMG(
        tuple(levels), coarse_inv,
        theta_resolved if theta_resolved is not None else 0.0,
        degree, ratio, omega)
    if mesh is not None:
        # place the non-greedy remainder (grid/block levels, dense tails,
        # vectors, coarse inverse); _ShardedOp levels pass through
        out = out.shard(mesh)
    return out
