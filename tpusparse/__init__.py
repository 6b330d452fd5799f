"""tpusparse — a sparse SpMV/SpMM library in JAX for NVIDIA GPUs.

A from-scratch re-design of the capability surface of the reference CUDA
study ``PACTHEMAN123/spMV-test`` (see SURVEY.md): the operation is
``Y = X @ A`` with ``X: (M,)`` or ``(B, M)``, ``A: (M, N)`` sparse, fp32 by
default (reference README.md:29-36, test/main.cpp:4).

Layers:

- ``tpusparse.formats``   — host-side converters (CSR/COO ingestion, ELL,
  SELL, BSR block-sparse, binned scheduling, ...), replacing the
  reference's C++ converter classes (matrix_csr.cpp, wsp.cpp, awsp.cpp, ...).
- ``tpusparse.kernels``   — the device products (plain XLA forms),
  replacing the 14 CUDA kernels (naive.cu, wsp.cu, asp.cu, awsp.cu,
  awsp_ref.cu, ...).
- ``tpusparse.ops``       — the public dispatch surface (spmv / spmm).
- ``tpusparse.autodiff``  — differentiable ``y = x @ A`` (custom VJP via a
  transpose-packed format; no reference counterpart — JAX-native value).
- ``tpusparse.parallel``  — mesh / collectives / partitioned multi-chip SpMV
  (no reference counterpart).
- ``tpusparse.prune``     — dense->sparse pruning strategies (magnitude,
  N:M structured, block) shaped by what the packed formats reward.
- ``tpusparse.nn``        — Flax layer (``SparseLinear``) over the trainable
  twin-layout path.
- ``tpusparse.reorder``   — RCM bandwidth reduction (scrambled bands -> DIA routing)
- ``tpusparse.solve``     — jittable iterative solvers (CG, BiCGStab, GMRES) over any packed
  format.
- ``tpusparse.eig``       — jittable Lanczos eigensolver (extremal pairs,
  spectrum bounds feeding the Chebyshev preconditioner).
- ``tpusparse.amg``       — smoothed-aggregation algebraic multigrid
  (host-side setup, jittable symmetric V-cycle of packed-format SpMVs).
- ``tpusparse.testing``   — seeded generators, dense oracle, tolerance
  harness, replacing SparseSgemvTester (tester.cpp).
- ``tpusparse.bench``     — timing, roofline accounting, reports, replacing
  TIME_KERNEL (kernel.hpp:31-48) and profile.sh.
- ``tpusparse.native``    — C++ fast-path converters (ctypes), parity with the
  reference's native host layer.
"""

__version__ = "0.1.0"

from tpusparse.ops import spmv, spmm  # noqa: F401
from tpusparse.config import SpmvConfig  # noqa: F401
from tpusparse.formats.auto import auto_format, matrix_stats, matrix_stats_csr  # noqa: F401
from tpusparse.autodiff import (linear_map, linear_map_sharded,  # noqa: F401
                                trainable_linear, trainable_linear_sharded)
from tpusparse.prune import (magnitude_prune, nm_prune,  # noqa: F401
                             block_prune)
from tpusparse.graph import normalized_adjacency  # noqa: F401
