"""Configuration for workloads and kernel selection.

The reference hard-codes everything — problem size (test/main.cpp:4), sparsity
(tester.cpp:106,154), kernel registry (tester.cpp:54-63). SURVEY.md §5 mandates
a real config system instead: dataclass + CLI (tpusparse/cli.py).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence


@dataclasses.dataclass
class SpmvConfig:
    """One benchmark/test workload: ``Y = X @ A``, A is (M, N), X is (B, M)."""

    m: int = 4096                 # contraction dim (reference M, test/main.cpp:4)
    n: int = 4096                 # output dim (reference N)
    batch: int = 1                # SpMM batch (1 == SpMV); extension over reference
    density: float = 0.5          # nnz fraction in A (reference ~0.5, tester.cpp:106)
    x_density: float = 0.5        # nnz fraction in X (reference ~0.5, tester.cpp:154)
    distribution: str = "uniform"  # uniform | powerlaw | banded | blocks
    seed: int = 0                 # reference was unseeded (tester.cpp:107) — a bug we fix
    dtype: str = "float32"
    kernels: Sequence[str] = ("dense_xla",)
    atol: float = 1e-3            # reference tolerance (tester.cpp:75)

    # format tuning knobs
    block_m: int = 512            # bitmap-ELL block along contraction dim

    def __post_init__(self):
        if self.m % 8 or self.n % 128:
            raise ValueError(
                f"M must be a multiple of 8 and N of 128 (packed tiles); "
                f"got M={self.m}, N={self.n} (pad inputs or change sizes)"
            )
