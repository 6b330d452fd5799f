#!/usr/bin/env python
"""Headline benchmark: canonical reference workload on one GPU.

Workload = the reference's only config: Y = X @ A, fp32, M=N=4096, ~50%
sparsity in A and X (test/main.cpp:4, tester.cpp:106,154). Prints ONE JSON
line. ``vs_baseline`` is speedup over the dense cuBLAS baseline through XLA
(cublas.cu:33) on the same card — the reference's own
headline comparison (its tester races sparse kernels against cublas,
tester.cpp:54-63).
"""

from __future__ import annotations

import json


def main() -> None:
    from tpusparse.bench.suite import headline

    result = headline()
    print(json.dumps(result))


if __name__ == "__main__":
    main()
