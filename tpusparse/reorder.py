"""Bandwidth-reduction reordering: reverse Cuthill-McKee (RCM).

Banded systems rarely ARRIVE banded: mesh/graph numbering is arbitrary, so
the nonzeros of a physically-1D/2D-local operator land scattered across
thousands of diagonals and ``auto_format`` routes them to SELL/RSELL. A
symmetric permutation ``B[i, j] = A[p[i], p[j]]`` from RCM recovers the
band, unlocking the DIA fast path (statically-shifted streams).

The reference has no reordering (its tester generates uniform random
matrices, tester.cpp:103-121); this is a beyond-reference extension in the
direction its TCSR/band-oriented formats point.

Applying ``p`` is an n-scale gather; keep it off the per-SpMV path. The
supported pattern is therefore **two-space**:

    csr_b, p = reorder.rcm(csr)          # once, host-side, O(nnz)
    fmt = auto_format(csr_b)             # now routes to DIA
    z_b, info = solve.cg(fmt, b[p])      # every iteration in B-space
    z = reorder.unpermute_vector(z_b, p) # once

For small n (<= ~16K) where a caller genuinely needs same-space serving,
``kernels/permute.py``'s static permutation applies; its one-hot planes
are O(n^2/128) bytes, so it does not scale to solver-sized n.
"""

from __future__ import annotations

import numpy as np

from tpusparse.formats.csr import CsrMatrix

__all__ = ["bandwidth_csr", "rcm", "banded_after_rcm",
           "inverse_permutation", "permute_vector", "unpermute_vector"]


def bandwidth_csr(csr) -> int:
    """Max ``|i - j|`` over stored entries — the half-bandwidth. O(nnz),
    never densifies (storage is CSR of A.T; offsets ``col_idx - r`` are
    the same diagonal ids ``matrix_stats_csr`` counts)."""
    if csr.nnz == 0:
        return 0
    r = np.repeat(np.arange(csr.shape[1], dtype=np.int64), csr.row_nnz)
    return int(np.abs(csr.col_idx.astype(np.int64) - r).max())


def rcm(csr: CsrMatrix) -> tuple[CsrMatrix, np.ndarray]:
    """Reverse Cuthill-McKee on the symmetrized pattern of square ``A``.

    Returns ``(csr_b, p)`` with ``B[i, j] = A[p[i], p[j]]``; for the
    library's op ``y = x @ A`` that means ``(x @ A)[p] == (x[p] @ B)`` —
    solve/serve entirely in B-space and un-permute once (module docstring).
    Nonsymmetric patterns are handled (scipy symmetrizes internally when
    ``symmetric_mode=False``), so convection-diffusion bands qualify.
    """
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    m, n = csr.shape
    if m != n:
        raise ValueError(f"rcm needs a square matrix, got {csr.shape}")
    s = csr.to_scipy().tocsr()
    p = np.asarray(reverse_cuthill_mckee(s, symmetric_mode=False),
                   dtype=np.int64)
    b = s[p][:, p]
    return CsrMatrix.from_scipy(b), p


def banded_after_rcm(
        csr: CsrMatrix) -> tuple[CsrMatrix, np.ndarray] | None:
    """Run RCM and keep it only if the reordered system passes the router's
    DIA rule (formats/auto.py: <= 512 distinct diagonals and diagonal
    storage within 1.25x of 5-bytes-per-nnz) — i.e. the permutation
    actually buys the DIA fast path. Returns ``(csr_b, p)`` or ``None``.

    Note the gate is diagonal-COUNT, not bandwidth: RCM gives a 2-D
    Laplacian bandwidth ~sqrt(n) but spreads its 5 nnz/row over ~2 sqrt(n)
    distinct offsets — DIA would stream ~40x the nnz bytes, so the helper
    correctly declines there (natural 2-D numbering, with its exact 5
    offsets, is already DIA's case without reordering). RCM pays off on
    dense-band operators: high-order 1-D stencils, banded covariance,
    scrambled tridiagonal families.
    """
    csr_b, p = rcm(csr)
    m, n = csr_b.shape
    r = np.repeat(np.arange(n, dtype=np.int64), csr_b.row_nnz)
    k = int(np.unique(csr_b.col_idx.astype(np.int64) - r).size)
    if 0 < k <= 512 and 4 * k * n <= 1.25 * 5 * csr_b.nnz:
        return csr_b, p
    return None


def inverse_permutation(p: np.ndarray) -> np.ndarray:
    inv = np.empty_like(np.asarray(p))
    inv[p] = np.arange(len(p))
    return inv


def permute_vector(v, p):
    """``v`` in A-space -> B-space (``out[i] = v[p[i]]``). Host numpy or
    device jnp both work; call at setup time, not per step."""
    return v[np.asarray(p)]


def unpermute_vector(v, p):
    """``v`` in B-space -> A-space (``out[p[i]] = v[i]``)."""
    return v[inverse_permutation(np.asarray(p))]
