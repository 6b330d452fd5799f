"""Dynamic-activation serving bench: pricing the per-call x==0 skip.

The reference's headline kernels skip x==0 work per call with zero host
preprocessing (asp.cu:20-27, awsp.cu:95-107, awsp_ref.cu:96). tpusparse has
three ways to serve a changing-X loop, and this bench measures all of them
on the card so the trade is measured, not claimed:

- ``dynamic``  — the device-side plan (kernels/awsp_spmv.py
  ``device_group_plan``): activity mask and compacted ids are XLA ops,
  padded to one static length with the zero group. One compile per
  layout, zero host cost, X may change every step.
- ``static``   — the host-exact plan reused across steps: the lower bound,
  valid only when the activation PATTERN is fixed.
- ``full``     — the no-skip plan (every group visited): what a user pays
  if they ignore activation sparsity.
- ``replan``   — host-side exact replanning each step: fetch X (device ->
  host sync), numpy plan, dispatch. The honest price of host planning
  when patterns churn.
- ``dense``    — dense baseline under the same changing-X chain.

The chained variants go through ``chain_device_time``: X cycles an
on-device pool of DIFFERENT activation patterns (same live fraction), and
the data-chain multiplies by (1 + eps) rather than adding eps so the zero
pattern survives the chaining (an additive eps would wake every group and
silently disable the skip being measured).

Run: ``python -m tpusparse.bench.dynamic [--quick] [--json PATH]``.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Any

import numpy as np

import jax
import jax.numpy as jnp

from tpusparse.bench.runner import chain_device_time
from tpusparse.bench.roofline import roofline_fraction

_LANES = 128


def _awsp_case(m: int, n: int, d: float, g: int, seed: int = 11):
    from tpusparse.formats.awsp import AwspMatrix

    rng = np.random.default_rng(seed)
    a = rng.uniform(-1.0, 1.0, size=(m, n)).astype(np.float32)
    a *= rng.uniform(size=(m, n)) < d
    return a, AwspMatrix.from_dense(a, g=g)


def _x_pool(m: int, ng: int, span: int, live: float, patterns: int,
            seed: int = 7, batch: int = 1) -> list[np.ndarray]:
    """``patterns`` dense-valued X arrays, each live in a DIFFERENT random
    ``ceil(live*ng)`` subset of the ng activation groups. ``batch > 1``
    stacks rows sharing the pattern (structured activation sparsity —
    e.g. expert-block routing — is structured ACROSS the batch; i.i.d.
    per-row patterns would union to everything live and no skip exists
    for any method, the reference's included)."""
    rng = np.random.default_rng(seed)
    k = max(1, int(round(live * ng)))
    pool = []
    for _ in range(patterns):
        groups = rng.choice(ng, size=k, replace=False)
        x = np.zeros((batch, m), dtype=np.float32)
        for gi in groups:
            lo = gi * span
            x[:, lo:min(lo + span, m)] = rng.uniform(
                -1.0, 1.0, size=(batch, min(span, m - lo)))
        pool.append(x[0] if batch == 1 else x)
    return pool


def _chain(call, n_reps: int):
    """chain_of factory: k steps cycling (A-replica, X-pattern) pairs with
    coprime cycle lengths so the same pair recurs only every lcm steps
    (defeats cache residency of the skip-visited slice). The chain scales X
    by (1 + eps): zeros stay zero (additive chaining would activate every
    group and disable the skip under test)."""

    def chain_of(k: int):
        @jax.jit
        def run(a_reps, x_pool):
            y = call(a_reps[0], x_pool[0])
            for i in range(1, k):
                eps = (jnp.sum(y) * 1e-37).astype(jnp.float32)
                y = call(a_reps[i % n_reps], x_pool[i % len(x_pool)]
                         * (1.0 + eps))
            return jnp.sum(y)

        return run

    return chain_of


def _replicate_fmt(fmt, copies: int) -> list:
    base = jax.tree_util.tree_map(lambda l: jax.device_put(jnp.asarray(l)),
                                  fmt)
    reps = [base]
    for _ in range(copies - 1):
        reps.append(jax.tree_util.tree_map(jnp.copy, base))
    return reps


def _measure_chain(name, call, fmt, x_pool, *, step_bytes, replicas,
                   verbose=True, k1=8, k2=None, reps=7):
    a_reps = _replicate_fmt(fmt, replicas)
    xs = [jax.device_put(jnp.asarray(x)) for x in x_pool]
    r = chain_device_time(_chain(call, replicas), a_reps, xs, name=name,
                          bytes_moved=int(step_bytes), k1=k1, k2=k2,
                          reps=reps)
    if verbose:
        print(f"  {r}", file=sys.stderr)
    return r


def _price_host_replan(awsp, x_pool, steps: int = 24) -> float:
    """Wall seconds per step of a host-planned serving loop: X lives on
    device (a previous layer's output), the host fetches it back (a
    sync), builds the exact plan, dispatches. Returns median per-step
    wall time — round-trip-dominated by construction, which is the point
    being priced."""
    xs = [jax.device_put(jnp.asarray(x)) for x in x_pool]
    # warm every distinct active-count compile first (steady-state serving)
    for x in xs:
        xh = np.asarray(jax.device_get(x))
        y = awsp.spmv(x, plan=awsp.plan(xh))
    float(jnp.sum(y))
    times = []
    for i in range(steps):
        x = xs[i % len(xs)]
        t0 = time.perf_counter()
        xh = np.asarray(jax.device_get(x))          # the per-step sync
        plan = awsp.plan(xh)
        y = awsp.spmv(x, plan=plan)
        _ = float(jnp.sum(y))                        # result consumed
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]


def run_awsp(m=4096, n=4096, d=0.5, g=2, live=0.25, patterns=5,
             quick=False, verbose=True, batch=1) -> dict[str, Any]:
    """AWSP serving rows: dynamic vs static-oracle vs full vs dense vs
    host-replan, one live fraction. ``batch > 1``: the SpMM win-region
    row — all methods see the same batched pattern-churning X."""
    from tpusparse.kernels.dense import dense_xla

    a_dense, awsp = _awsp_case(m, n, d, g)
    ng, span = awsp.n_groups, g * _LANES
    pool = _x_pool(m, ng, span, live, patterns, batch=batch)

    def _product(fmt, x, plan):
        return fmt.spmv(x, plan=plan) if batch == 1 \
            else fmt.spmm(x, plan=plan)

    # correctness gate before paying any chained compile: the dynamic path
    # must match the dense product on the real chip, not just interpret mode
    y_dyn = np.asarray(jax.device_get(_product(awsp, jnp.asarray(pool[0]),
                                               "device")))
    y_ref = pool[0] @ a_dense
    err = float(np.max(np.abs(y_dyn - y_ref)))
    if err > 1e-3:
        raise AssertionError(f"dynamic path wrong on device: max err {err}")
    if verbose:
        print(f"  dynamic-path hardware check: max|err|={err:.2e}",
              file=sys.stderr)

    nb, gtot, w, lanes = awsp.vals.shape
    full_bytes = nb * (gtot - g) * w * lanes * 5     # all real groups
    k_act = max(1, int(round(live * ng)))
    # + the B-scaled X/Y vector traffic: at small live
    # fractions and batch > 1 the (B, m) X and (B, n) Y reads/writes are
    # a visible share of the step's bytes and must size the slope chain
    xy_bytes = batch * (m + n) * 4
    act_bytes = nb * k_act * g * w * lanes * 5 + xy_bytes
    reps_full = max(6, -(-640_000_000 // full_bytes))
    reps_act = max(6, min(20, -(-640_000_000 // act_bytes)))
    kw = dict(k1=2, k2=5, reps=2) if quick else {}
    if quick:
        reps_full, reps_act = 4, 6

    rows: dict[str, Any] = {}

    def dyn(fmt, x):
        return _product(fmt, x, "device")

    rows["dynamic"] = _measure_chain(
        f"awsp dynamic live={live} B={batch}", dyn, awsp, pool,
        step_bytes=act_bytes, replicas=reps_act, verbose=verbose, **kw)

    static_plan = jnp.asarray(awsp.plan(pool[0]))

    def stat(fmt, x):
        return _product(fmt, x, static_plan)

    rows["static"] = _measure_chain(
        "awsp static-oracle (fixed pattern)", stat, awsp, [pool[0]],
        step_bytes=act_bytes, replicas=reps_act, verbose=verbose, **kw)

    full_plan = jnp.asarray(awsp._full_plan())

    def full(fmt, x):
        return _product(fmt, x, full_plan)

    rows["full"] = _measure_chain(
        "awsp full (no skip)", full, awsp, pool,
        step_bytes=full_bytes, replicas=reps_full, verbose=verbose, **kw)

    def dense_call(fmt, x):
        return dense_xla(fmt, x)

    rows["dense"] = _measure_chain(
        "dense_xla (changing X)", dense_call, jnp.asarray(a_dense), pool,
        step_bytes=m * n * 4, replicas=4 if quick else 10,
        verbose=verbose, **kw)

    replan_s = _price_host_replan(awsp, pool, steps=4 if quick else 24) \
        if batch == 1 else None
    if verbose and replan_s is not None:
        print(f"  host-replan serving loop: {replan_s * 1e3:.1f} ms/step",
              file=sys.stderr)

    return dict(
        kind="awsp", m=m, n=n, d=d, g=g, ng=ng, live=live, batch=batch,
        act_bytes=act_bytes, full_bytes=full_bytes,
        us={k: round(r.seconds * 1e6, 1) for k, r in rows.items()},
        roofline={k: round(roofline_fraction(
            act_bytes if k in ("dynamic", "static") else
            (full_bytes if k == "full" else m * n * 4), r.seconds), 3)
            for k, r in rows.items()},
        replan_ms=None if replan_s is None else round(replan_s * 1e3, 2),
        err=err,
    )


def run_awsp_sweep(m=4096, n=4096, d=0.5, g=2, lives=(0.0625, 0.25, 0.5,
                                                      1.0),
                   quick=False, verbose=True) -> list[dict[str, Any]]:
    """live-fraction sweep of the dynamic path only: shows time tracking
    active bytes (the skip working on device) and the dynamic-plan
    overhead at live=1 vs the static full plan."""
    a_dense, awsp = _awsp_case(m, n, d, g)
    ng, span = awsp.n_groups, g * _LANES
    nb, gtot, w, lanes = awsp.vals.shape
    out = []
    for live in lives:
        pool = _x_pool(m, ng, span, live, patterns=5)
        k_act = max(1, int(round(live * ng)))
        act_bytes = nb * k_act * g * w * lanes * 5
        reps = max(6, min(20, -(-640_000_000 // act_bytes)))
        kw = dict(k1=2, k2=5, reps=2) if quick else {}
        if quick:
            reps = 5

        def dyn(fmt, x):
            return fmt.spmv(x, plan="device")

        r = _measure_chain(f"awsp dynamic live={live}", dyn, awsp, pool,
                           step_bytes=act_bytes, replicas=reps,
                           verbose=verbose, **kw)
        out.append(dict(live=live, us=round(r.seconds * 1e6, 1),
                        act_bytes=act_bytes,
                        roofline=round(roofline_fraction(act_bytes,
                                                         r.seconds), 3)))
    return out


def run_asp(m=4096, n=4096, d=0.5, live=0.25, patterns=5, quick=False,
            verbose=True, batch=1) -> dict[str, Any]:
    """ASP (dense A, window-granular skip) dynamic vs full vs static.

    ``batch > 1`` is the batched-SpMM win region: ASP's active windows
    are multiplied as dense (span, n) blocks, so unlike the gather formats
    its time is ~B-independent — the dense-tiles-plus-skip carrier the
    ``expect_batch`` routing law points at."""
    from tpusparse.kernels.asp_spmv import AspMatrix
    from tpusparse.kernels.dense import dense_xla

    rng = np.random.default_rng(13)
    a = rng.uniform(-1.0, 1.0, size=(m, n)).astype(np.float32)
    a *= rng.uniform(size=(m, n)) < d
    asp = AspMatrix.from_dense(a)
    nt = m // _LANES
    pool = _x_pool(m, nt, _LANES, live, patterns, batch=batch)

    def _product(fmt, x, plan):
        return fmt.spmv(x, plan=plan) if batch == 1 \
            else fmt.spmm(x, plan=plan)

    y_dyn = np.asarray(jax.device_get(_product(asp, jnp.asarray(pool[0]),
                                               "device")))
    err = float(np.max(np.abs(y_dyn - pool[0] @ a)))
    if err > 1e-3:
        raise AssertionError(f"asp dynamic wrong on device: max err {err}")
    if verbose:
        print(f"  asp dynamic hardware check: max|err|={err:.2e}",
              file=sys.stderr)

    k_act = max(1, int(round(live * nt)))
    act_bytes = k_act * _LANES * asp.a_pad.shape[1] * 4
    full_bytes = m * n * 4
    if batch > 1:
        # X/Y traffic scales with B while A does not; negligible at the
        # default 4096^2/B=8 but keeps roofline fractions honest at small
        # m/n or large B.
        xy_bytes = batch * (m + n) * 4
        act_bytes += xy_bytes
        full_bytes += xy_bytes
    reps_act = max(6, min(20, -(-640_000_000 // act_bytes)))
    reps_full = max(6, -(-640_000_000 // full_bytes))
    kw = dict(k1=2, k2=5, reps=2) if quick else {}
    if quick:
        reps_act, reps_full = 5, 4

    rows = {}

    def dyn(fmt, x):
        return _product(fmt, x, "device")

    rows["dynamic"] = _measure_chain(
        f"asp dynamic live={live} B={batch}", dyn, asp, pool,
        step_bytes=act_bytes, replicas=reps_act, verbose=verbose, **kw)

    static_plan = asp.plan(pool[0])

    def stat(fmt, x):
        return _product(fmt, x, static_plan)

    rows["static"] = _measure_chain(
        "asp static-oracle", stat, asp, [pool[0]],
        step_bytes=act_bytes, replicas=reps_act, verbose=verbose, **kw)

    full_plan = asp._full_plan()

    def full(fmt, x):
        return _product(fmt, x, full_plan)

    rows["full"] = _measure_chain(
        "asp full (no skip)", full, asp, pool,
        step_bytes=full_bytes, replicas=reps_full, verbose=verbose, **kw)

    if batch > 1:      # the win-region comparison needs dense under churn
        def dense_call(fmt, x):
            return dense_xla(fmt, x)

        rows["dense"] = _measure_chain(
            f"dense_xla (changing X) B={batch}", dense_call,
            jnp.asarray(a), pool, step_bytes=full_bytes,
            replicas=4 if quick else 10, verbose=verbose, **kw)

    return dict(kind="asp", m=m, n=n, d=d, live=live, batch=batch,
                act_bytes=act_bytes, full_bytes=full_bytes,
                us={k: round(r.seconds * 1e6, 1) for k, r in rows.items()},
                err=err)


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--quick", action="store_true")
    p.add_argument("--json", default=None,
                   help="append the records to this JSON list file")
    p.add_argument("--parts", default="awsp,sweep,asp")
    p.add_argument("--batch", type=int, default=1,
                   help="awsp part batch size (records under awsp_b{B})")
    args = p.parse_args(argv)
    from tpusparse.bench.gallery import run_id

    out: dict[str, Any] = dict(run=run_id())
    parts = args.parts.split(",")
    if "awsp" in parts:
        key = "awsp" if args.batch == 1 else f"awsp_b{args.batch}"
        out[key] = run_awsp(quick=args.quick, batch=args.batch)
    if "sweep" in parts:
        out["sweep"] = run_awsp_sweep(quick=args.quick)
    if "asp" in parts:
        key = "asp" if args.batch == 1 else f"asp_b{args.batch}"
        out[key] = run_asp(quick=args.quick, batch=args.batch)
    if args.json:
        old = {}
        if os.path.exists(args.json):
            with open(args.json) as f:
                old = json.load(f)
        old.update(out)
        with open(args.json, "w") as f:
            json.dump(old, f, indent=1)
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
