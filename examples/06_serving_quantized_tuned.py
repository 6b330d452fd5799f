"""Serving lane: reduced-precision value storage.

A serving deployment packs its weight matrices once and multiplies them
millions of times, so it can afford a one-time quantization:
``dtype='int8'`` stores 2 bytes/slot (vs fp32's 5) with per-output-column
scales; ``dtype=bfloat16`` is the middle lane. Accumulation stays fp32
either way; the error is outside the library's 1e-3 contract (~ max|v|/254
* sqrt(col nnz) * E|x| for int8), which serving workloads routinely accept.

Run: python examples/06_serving_quantized_tuned.py [--cpu]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

if "--cpu" in sys.argv:
    import jax

    jax.config.update("jax_platforms", "cpu")

import numpy as np

from tpusparse.formats.sell import SellMatrix
from tpusparse.testing import generators


def main():
    m = n = 2048
    a = generators.random_sparse_matrix(m, n, density=0.25, seed=0)
    x = generators.random_sparse_vector(m, density=0.5, seed=1)
    y_fp64 = (x.astype(np.float64) @ a.astype(np.float64))

    for dtype, label in [(None, "fp32"), ("bfloat16", "bf16"),
                         ("int8", "int8 + per-column scales")]:
        fmt = SellMatrix.from_dense(a, dtype=dtype)
        y = np.asarray(fmt.spmv(x))
        err = float(np.max(np.abs(y - y_fp64)))
        print(f"{label:>26}: {fmt.device_bytes() / 1e6:5.1f} MB, "
              f"max|err| {err:.2e}")

    fmt = SellMatrix.from_dense(a, dtype="int8")
    print("serving call:", np.asarray(fmt.spmv(x))[:4])


if __name__ == "__main__":
    main()
