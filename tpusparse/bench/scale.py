"""GB-scale unstructured run: the 'large synthetic matrix' config taken to
>= 1 GB of packed format bytes.

One 262144^2 powerlaw matrix at d ~ 2e-3 (~137 M nnz):

- host generation wall-time (no-densify generator),
- O(nnz) statistics + the router's pick,
- converter wall-time (native C++ fast path vs numpy recorded by the
  converter itself),
- ONE host->device upload, timed (paid once per process by design),
- SpMV device time via the slope runner (bytes_moved passed so the
  ms-scale product gets the median-of-slopes guard) + roofline %,
- a Krylov-iteration chain (per-iteration device time at scale),
- a trainable_linear fwd+bwd step (tied twin layouts at GB scale).

Run: ``python -m tpusparse.bench.scale [--m 262144] [--density 2e-3]``.
Emits one JSON record; small shapes via --m for CPU smoke tests.

At the default config the matrix touches 99.2% of its 4.19M 128^2 tiles
at d_eff ~ 8e-4, so every slot format floors at the 8-slot chunk quantum
— tens of GB predicted. When the prediction exceeds the device-memory
budget the run records that law as a ``cliff`` row instead of packing;
such matrices need the multi-chip partitions (parallel/sparse.py).
"""

from __future__ import annotations

import json
import sys
import time
from typing import Any

import numpy as np

import jax
import jax.numpy as jnp


def _wall(fn, *a, **kw):
    t0 = time.perf_counter()
    out = fn(*a, **kw)
    return out, time.perf_counter() - t0


def run(m: int = 262144, density: float = 2e-3, seed: int = 42,
        train: bool = True, hbm_budget: int | None = None,
        verbose: bool = True, quick: bool = False,
        train_k2: int | None = None) -> dict[str, Any]:
    """``quick``: tiny chains for CPU smoke tests (times meaningless).
    ``hbm_budget``: packs predicted past this are recorded as a
    quantum-floor cliff instead of attempted (default: three quarters of
    the device's ``bytes_limit``, leaving headroom for X/Y/replica
    bookkeeping; unbounded on a device that reports no limit)."""
    if hbm_budget is None:
        mem = jax.devices()[0].memory_stats()
        hbm_budget = int(0.75 * mem["bytes_limit"]) \
            if mem and "bytes_limit" in mem else sys.maxsize
    from tpusparse.bench.roofline import format_bytes, roofline_fraction
    from tpusparse.bench.runner import chain_device_time, device_time, run_id
    from tpusparse.formats.auto import (auto_format, matrix_stats_csr,
                                        predicted_bytes, route)
    from tpusparse.testing import generators

    def log(msg):
        if verbose:
            print(msg, file=sys.stderr, flush=True)

    rec: dict[str, Any] = dict(run=run_id(), m=m, n=m, density=density)

    csr, t_gen = _wall(generators.random_sparse_csr, m, m, density,
                       seed=seed, distribution="powerlaw")
    rec["nnz"] = int(csr.nnz)
    rec["gen_s"] = round(t_gen, 1)
    log(f"generated {csr.nnz:,} nnz in {t_gen:.1f}s")

    stats, t_stats = _wall(matrix_stats_csr, csr)
    routed = route(m, m, stats)
    rec["stats_s"] = round(t_stats, 1)
    rec["routed"] = routed
    log(f"stats in {t_stats:.1f}s -> routed to {routed}")

    # Quantum-floor guard: when the matrix touches nearly every 128^2
    # tile at low per-tile fill, every slot format floors at 5120 B x
    # touched tiles. Packing past the budget is not a benchmark, it is an
    # OOM; record the law and the multi-chip pointer instead
    # (parallel/sparse.py shards the same pack at ~pred/D bytes per chip).
    pred = predicted_bytes(m, m, stats, routed, csr=csr)
    rec["predicted_gb"] = round(pred / 1e9, 2)
    if pred > hbm_budget:
        ntile = ((m + 127) // 128) ** 2
        rec["cliff"] = "quantum_floor"
        rec["touched_tile_frac"] = round(1 - stats["empty_block_frac"], 4)
        rec["floor_law"] = (
            f"slot formats >= round_up(w_tile,8) x 640 B per touched "
            f"128^2 tile; {rec['touched_tile_frac']:.1%} of {ntile:,} "
            f"tiles touched -> {pred/1e9:.1f} GB predicted for "
            f"'{routed}' > {hbm_budget/1e9:.0f} GB memory budget; this "
            f"regime needs the multi-chip partitions")
        log(f"CLIFF: {rec['floor_law']}")
        return rec

    fmt, t_pack = _wall(auto_format, csr, stats=stats)
    nbytes = format_bytes(fmt)
    rec["pack_s"] = round(t_pack, 1)
    rec["format"] = type(fmt).__name__
    rec["format_gb"] = round(nbytes / 1e9, 3)
    log(f"packed {type(fmt).__name__}: {nbytes/1e9:.2f} GB in {t_pack:.1f}s")

    # ONE upload, synced by touching a scalar of every leaf
    def upload():
        dev = jax.tree_util.tree_map(
            lambda leaf: jax.device_put(jnp.asarray(leaf)), fmt)
        for leaf in jax.tree_util.tree_leaves(dev):
            jnp.asarray(leaf).ravel()[0].block_until_ready()
        _ = float(sum(jnp.sum(leaf[..., :1].astype(jnp.float32))
                      for leaf in jax.tree_util.tree_leaves(dev)))
        return dev

    dev_fmt, t_up = _wall(upload)
    rec["upload_s"] = round(t_up, 1)
    log(f"uploaded once in {t_up:.1f}s "
        f"({nbytes / 1e6 / max(t_up, 1e-9):.1f} MB/s)")

    x = np.random.default_rng(seed).uniform(-1, 1, m).astype(np.float32)

    dt_kw = dict(k1=2, k2=5, reps=2) if quick else {}
    r = device_time(lambda f, xx: f.spmv(xx), dev_fmt, x,
                    name=f"scale-spmv[{type(fmt).__name__}]",
                    bytes_moved=nbytes, nnz=csr.nnz, **dt_kw)
    rec["spmv_us"] = round(r.seconds * 1e6, 1)
    rec["spmv_roofline"] = round(roofline_fraction(nbytes, r.seconds), 3)
    rec["spmv_gnnz_s"] = round(csr.nnz / r.seconds / 1e9, 2)
    log(f"  {r} | roofline {rec['spmv_roofline']:.0%}")

    # Krylov per-iteration cost at scale: a chained spmv+axpy step moves
    # exactly the memory traffic of one CG iteration minus the dots (a
    # REAL cg() needs a symmetric operator — a second symmetrized pack +
    # upload — for no additional information about the format at scale).
    def chain_of(k):
        @jax.jit
        def runk(f, xx):
            v = xx
            for _ in range(k):
                y = f.spmv(v)
                v = xx + (jnp.sum(y) * 1e-37).astype(xx.dtype)
                # y has length n=m here (square), feed it back scaled
                v = v + 1e-6 * y
            return jnp.sum(v)

        return runk

    rk = chain_device_time(chain_of, dev_fmt,
                           jax.device_put(jnp.asarray(x)),
                           name="scale-iter", bytes_moved=nbytes,
                           k1=2 if quick else 4,
                           k2=5 if quick else None,
                           reps=2 if quick else 7)
    rec["iter_us"] = round(rk.seconds * 1e6, 1)
    log(f"  per-iteration (spmv+axpy): {rk}")

    # Drain the measurement transients before the train stage: the slope
    # runs above cycled a replica pool whose buffers can still be live
    # when the twin packs upload. The pools are function-local so a GC
    # pass plus one synced op flushes the deferred deletions.
    import gc

    gc.collect()
    float(jnp.sum(jax.device_put(jnp.ones(8, jnp.float32))))

    if train:
        try:
            from tpusparse.autodiff import trainable_linear

            (ap, params), t_tw = _wall(lambda: trainable_linear(csr)[:2])
            rec["twin_pack_s"] = round(t_tw, 1)

            # Size the stage from the ACTUAL twin pack before uploading
            # anything (prediction-based sizing is wrong both ways: flat-
            # SELL w_global pricing says 32768^2 cannot train, yet it
            # can). Live on-device:
            # params (vals+vals_t) + their grads + the structure planes
            # + the already-uploaded SpMV pack + x/y. A recorded gate is
            # a RESULT (what fits single-chip); the sharded step
            # (autodiff.trainable_linear_sharded, in the 8-device
            # dryrun) is the supported path past it.
            def _tree_bytes(t):
                return sum(np.asarray(l).nbytes
                           for l in jax.tree_util.tree_leaves(t))

            twin_b = _tree_bytes(params)
            statics_b = _tree_bytes(ap.statics)
            train_need = 2 * twin_b + statics_b + nbytes
            rec["train_operands_gb"] = round(train_need / 1e9, 3)
            if train_need > hbm_budget:
                rec["train_gate"] = (
                    f"params {twin_b/1e9:.1f} + grads {twin_b/1e9:.1f} "
                    f"+ structure planes {statics_b/1e9:.1f} + uploaded "
                    f"pack {nbytes/1e9:.1f} = {train_need/1e9:.1f} GB "
                    f"live > {hbm_budget/1e9:.0f} GB operand budget "
                    f"(device memory minus runtime reserve/AD "
                    f"workspace); "
                    f"use trainable_linear_sharded on a mesh")
                log(f"  train step gated: {rec['train_gate']}")
                return rec

            # Closed-over structure planes would lower as INLINE stablehlo
            # constants (over 100 MB of HLO at 8192^2). Thread them as
            # runtime arguments instead — uploaded once, program size
            # flat (autodiff._trainable_from_pack statics).
            x_j = jnp.asarray(x)
            statics_d = jax.tree_util.tree_map(jax.device_put, ap.statics)

            def chain_tr(k):
                @jax.jit
                def runk(p, xx, st):
                    v = xx
                    for _ in range(k):
                        loss, dp = jax.value_and_grad(
                            lambda pp: (ap(pp, v, statics=st) ** 2).sum()
                        )(p)
                        v = xx + (loss * 1e-37).astype(xx.dtype)
                    return loss

                return runk

            p0 = jax.tree_util.tree_map(
                lambda l: jax.device_put(jnp.asarray(l)), params)
            # k2 pinned small: the auto rule (span >= 10 ms) would unroll
            # 168 value_and_grad iterations — at GB scale that program is
            # huge and multiplies live AD temps.
            rt = chain_device_time(chain_tr, p0,
                                   jax.device_put(x_j), statics_d,
                                   name="scale-train-step",
                                   bytes_moved=3 * nbytes,
                                   k1=2,
                                   k2=train_k2 or (4 if quick else 10),
                                   reps=2 if quick else 7)
            rec["train_us"] = round(rt.seconds * 1e6, 1)
            log(f"  fwd+bwd step: {rt}")
        except Exception as e:          # OOM / unsupported at this scale
            rec["train_error"] = f"{type(e).__name__}: {e}"[:300]
            log(f"  train step failed: {rec['train_error']}")

    return rec


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--m", type=int, default=262144)
    p.add_argument("--density", type=float, default=2e-3)
    p.add_argument("--no-train", action="store_true")
    p.add_argument("--train-k2", type=int, default=None,
                   help="unrolled train-chain length (smaller = smaller "
                        "program)")
    p.add_argument("--json", default=None,
                   help="append the record to this JSON list file")
    args = p.parse_args(argv)
    rec = run(m=args.m, density=args.density, train=not args.no_train,
              train_k2=args.train_k2)
    if args.json:
        import os
        recs = []
        if os.path.exists(args.json):
            with open(args.json) as f:
                recs = json.load(f)
        recs = [r for r in recs if (r.get("m"), r.get("density"))
                != (rec["m"], rec["density"])]
        recs.append(rec)
        with open(args.json, "w") as f:
            json.dump(recs, f, indent=1)
    print(json.dumps(rec, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
