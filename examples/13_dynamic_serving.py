"""Dynamic activation sparsity: serving a changing X with zero host cost.

The reference's headline kernels skip x==0 work per call with no
preprocessing (asp.cu:20-27, awsp.cu:95-107). Here the skip is
window-group-granular, and the plan (which groups are live) is computed
ON DEVICE under jit — activity mask and compacted group ids are XLA ops,
padded to one static length with an all-zero group:

    y = fmt.spmv(x, plan="device")     # one compile, X free to change

No device->host sync, no per-pattern replanning, no recompilation when
the activation PATTERN changes (only the layout shape is baked). This is
the serving loop the reference enables implicitly on SIMT, without host
replanning over the device->host round trip.

Run: python examples/13_dynamic_serving.py [--cpu]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

if "--cpu" in sys.argv:
    import jax

    jax.config.update("jax_platforms", "cpu")

import jax
import jax.numpy as jnp
import numpy as np

from tpusparse.formats.awsp import AwspMatrix
from tpusparse.testing import generators

M = N = 1024
G = 2                       # windows per activation group
LIVE_GROUPS = 2             # groups live per serving step


def main():
    a = generators.random_sparse_matrix(M, N, density=0.4, seed=3)
    fmt = AwspMatrix.from_dense(a, g=G)
    ng, span = fmt.n_groups, G * 128
    print(f"packed: {fmt!r} ({ng} activation groups)")

    # the serving step: jit once, plan computed on device inside the trace
    @jax.jit
    def step(f, x):
        return f.spmv(x, plan="device")

    rng = np.random.default_rng(7)
    for t in range(4):
        # a different sparse activation pattern every step (e.g. routing)
        live = rng.choice(ng, size=LIVE_GROUPS, replace=False)
        x = np.zeros(M, np.float32)
        for gi in live:
            x[gi * span:(gi + 1) * span] = rng.uniform(-1, 1, span)

        y = np.asarray(step(fmt, jnp.asarray(x)))
        err = np.max(np.abs(y - x @ a))
        print(f"step {t}: live groups {sorted(live.tolist())} -> "
              f"max|err| {err:.2e} (zero host planning)")
        assert err <= 1e-3

    print("ok: one compile served every pattern")


if __name__ == "__main__":
    main()
