"""1-device-mesh overhead check on the card.

One card cannot measure multi-card scaling, but it CAN ground the
comm model's compute-side inputs: run the SHARDED code paths (shard_map
lowering, specs, padding, reassembly) on a 1-device mesh and assert the
per-call device time matches the unsharded kernel within the documented
contention jitter. Any systematic shard_map overhead would poison every
row of the analytic comm model (bench/commmodel.py); this is the only
hardware grounding a single card can produce.

Covers the three carrier families the model leans on: SELL (flagship
n-partition), DIA (stencil halo), TCSR (tiered n-partition).

Run: ``python -m tpusparse.bench.shard_overhead [--quick]``.
"""

from __future__ import annotations

import json
import sys
from typing import Any

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from tpusparse.bench.roofline import format_bytes
from tpusparse.bench.runner import device_time, run_id
from tpusparse.testing import generators


def _pair(name, fmt, run_unsharded, run_sharded, x, nbytes, nnz, quick,
          verbose=True) -> dict[str, Any]:
    kw = dict(k1=2, k2=5, reps=2) if quick else {}
    r0 = device_time(run_unsharded, fmt, x, name=f"{name} unsharded",
                     bytes_moved=nbytes, nnz=nnz, **kw)
    r1 = device_time(run_sharded, fmt, x, name=f"{name} sharded@1",
                     bytes_moved=nbytes, nnz=nnz, **kw)
    ratio = r1.seconds / r0.seconds
    if verbose:
        print(f"  {r0}\n  {r1}  -> ratio {ratio:.3f}", file=sys.stderr)
    return dict(unsharded_us=round(r0.seconds * 1e6, 1),
                sharded_us=round(r1.seconds * 1e6, 1),
                ratio=round(ratio, 3))


def run(quick: bool = False, verbose: bool = True) -> dict[str, Any]:
    from tpusparse.formats.dia import DiaMatrix
    from tpusparse.formats.sell import SellMatrix
    from tpusparse.formats.tcsr import TcsrMatrix
    from tpusparse.parallel.sparse import (dia_spmm_sharded,
                                           sell_spmm_sharded,
                                           tcsr_shard_pack,
                                           tcsr_spmm_sharded)

    mesh = Mesh(np.array(jax.devices()[:1]), ("n",))
    out: dict[str, Any] = dict(run=run_id(), devices=1)

    # SELL on the canonical workload
    m = n = 4096
    a = generators.random_sparse_matrix(m, n, density=0.5, seed=5)
    x = generators.random_sparse_vector(m, density=0.5, seed=5)
    s = SellMatrix.from_dense(a)
    out["sell"] = _pair(
        "sell", s, lambda f, xx: f.spmv(xx),
        lambda f, xx: sell_spmm_sharded(f, xx, mesh, "n"),
        x, format_bytes(s), s.nnz, quick, verbose)

    # DIA on a banded operator (halo partition degenerates to no comm at
    # D=1 but still runs the mirrored-edge shard_map body)
    c = generators.stencil_csr((64, 64) if quick else (512, 512))
    d = DiaMatrix.from_csr(c)
    xd = generators.random_sparse_vector(c.shape[0], density=0.5, seed=6)
    out["dia"] = _pair(
        "dia", d, lambda f, xx: f.spmv(xx),
        lambda f, xx: dia_spmm_sharded(f, xx, mesh, "halo"),
        xd, format_bytes(d), c.nnz, quick, verbose)

    # TCSR on the 35%-tiles / 40%-fill blocks workload ()
    rng = np.random.default_rng(7)
    keep = rng.random((m // 128, n // 128)) < 0.35
    keep.flat[0] = True
    mask = np.kron(keep, np.ones((128, 128), bool)) & \
        (rng.random((m, n)) < 0.4)
    ab = (rng.uniform(-1, 1, (m, n)) * mask).astype(np.float32)
    ab = np.where(mask & (ab == 0), 1e-3, ab).astype(np.float32)
    t = TcsrMatrix.from_dense(ab)
    packed = tcsr_shard_pack(ab, 1)
    xb = generators.random_sparse_vector(m, density=0.5, seed=7)

    def run_t_sharded(_f, xx):
        return tcsr_spmm_sharded(packed, xx, mesh)

    out["tcsr"] = _pair(
        "tcsr", t, lambda f, xx: f.spmv(xx), run_t_sharded,
        xb, format_bytes(t), t.nnz, quick, verbose)

    worst = max(v["ratio"] for v in out.values() if isinstance(v, dict)
                and "ratio" in v)
    out["worst_ratio"] = worst
    return out


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--quick", action="store_true")
    p.add_argument("--json", default=None,
                   help="write the record to this JSON file")
    args = p.parse_args(argv)
    rec = run(quick=args.quick)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rec, f, indent=1)
    print(json.dumps(rec, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
