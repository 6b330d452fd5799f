"""Analytic chip-to-chip comm-volume / overlap model for the sharded
partitions.

A virtual-CPU mesh validates programs, not hardware scaling (bench/
scaling.py note). This model is the quantitative bridge: for each partition
it derives, from first principles, the per-call memory-bound compute time
and the link bytes per chip, and the resulting weak-scaling efficiency —
and the collective KINDS it assumes are asserted against the actually-
lowered sharded programs in tests/test_commmodel.py, so the model describes
the code, not a sketch.

Per-chip times for a (m, n) fp32 workload sharded D ways, weak scaling
(per-chip slab fixed at (m, n)):

- ``n``  (output shard): X replicated, Y lands sharded — zero steady-state
  link traffic. efficiency = 1.
- ``m``  (contraction shard): each chip computes a FULL-width partial Y and
  psums it. Link bytes/chip for a ring all-reduce of Y: 2*(D-1)/D * |Y|
  where |Y| = B * n * 4 (the m-partition's output is replicated, so |Y| is
  the global output). NOT overlapped (the psum follows the local product).
- ``ring`` (both sharded): D steps; the first D-1 overlap one X-chunk
  ppermute (|X|/D bytes) with one band's local compute (compute/D), the
  last consumes its band with no send (the implementations skip the
  unread final shift). step = max(compute/D, chunk/link);
  call = (D-1)*step + compute/D.

The model intentionally charges NO latency/setup constants — it is an
upper bound on efficiency and a lower bound on comm cost. Rates come from
the published-peaks table (bench/roofline.py): on the H100 the cards of a
host are joined all to all by NVLink at 450 GB/s each way, so a ring step
uses one such link.
"""

from __future__ import annotations

import dataclasses

from tpusparse.bench.roofline import PEAKS

_H100 = PEAKS["NVIDIA H100 80GB HBM3"]
HBM_GBPS = _H100["hbm_gbps"]
LINK_GBPS = _H100["link_gbps"]


@dataclasses.dataclass
class CommEstimate:
    partition: str
    compute_s: float          # per-call local memory-bound compute time
    link_bytes: int           # link bytes per chip per call
    comm_s: float             # un-overlapped comm time
    call_s: float             # modeled per-call wall time
    efficiency: float         # weak-scaling efficiency vs 1 chip
    collectives: tuple[str, ...]   # stablehlo ops the partition must lower to

    def __str__(self) -> str:
        return (f"[{self.partition}] compute {self.compute_s * 1e6:.0f} us"
                f" + link {self.link_bytes / 1e6:.2f} MB"
                f" -> {self.call_s * 1e6:.0f} us/call,"
                f" weak efficiency {self.efficiency * 100:.0f}%")


def comm_model(partition: str, *, m: int, n: int, batch: int = 1,
               n_devices: int = 8, format_bytes: int | None = None,
               halo: int = 0, vals_halo: int = 0,
               lowering: float = 1.0,
               hbm_gbps: float = HBM_GBPS,
               link_gbps: float = LINK_GBPS) -> CommEstimate:
    """Weak-scaling estimate: every chip holds an (m, n) fp32 slab (or
    ``format_bytes`` of a packed format) and the global problem grows with
    ``n_devices``. ``halo`` (elements, hl + hr) sizes the ``halo``
    partition's edge exchange (DIA stencil: ``sum of max|offset| both
    ways``), the only partition whose link bytes are independent of BOTH
    the slab size and D. ``vals_halo`` (elements) adds the symmetric-DIA
    vals edge strip (one extra ppermute per call) — batch-independent,
    still ∝ bandwidth only. ``lowering`` multiplies the compute term with
    a measured 1-device shard_map overhead (bench/shard_overhead.py), the
    correction for edge selects and padding that pure byte counting
    misses; 1.0 until it is measured."""
    slab = format_bytes if format_bytes is not None else m * n * 4
    compute = lowering * slab / (hbm_gbps * 1e9)
    d = n_devices
    if partition == "n":
        link = 0
        call = compute
        coll: tuple[str, ...] = ()
    elif partition == "m":
        y_bytes = batch * n * 4            # full-width replicated output
        link = int(2 * (d - 1) / d * y_bytes)
        comm = link / (link_gbps * 1e9)
        call = compute + comm              # psum follows the product
        coll = ("all-reduce",)
    elif partition == "ring":
        chunk = batch * m * 4              # one X window-shard per step
        step = max(compute / d, chunk / (link_gbps * 1e9))
        link = int((d - 1) * chunk)         # the last band skips its send
        call = (d - 1) * step + compute / d
        coll = ("collective-permute",)
    elif partition == "halo":
        # DIA stencil: two ppermutes move only the band edges, then the
        # k shifted FMAs are purely local. Comm ∝ bandwidth, not m or D.
        link = int((batch * halo + vals_halo) * 4)
        comm = link / (link_gbps * 1e9)
        call = compute + comm              # halos precede the local FMAs
        coll = ("collective-permute",) if (halo or vals_halo) else ()
    else:
        raise ValueError(f"unknown partition {partition!r}")
    comm_s = link / (link_gbps * 1e9)
    return CommEstimate(partition=partition, compute_s=compute,
                        link_bytes=link, comm_s=comm_s, call_s=call,
                        efficiency=compute / call if call else 1.0,
                        collectives=coll)


def train_model(*, m: int, n: int, batch: int = 1, n_devices: int = 8,
                format_bytes: int | None = None,
                hbm_gbps: float = HBM_GBPS,
                link_gbps: float = LINK_GBPS) -> CommEstimate:
    """Weak-scaling estimate for the FULL sharded training step
    (autodiff.trainable_linear_sharded): forward output-shard (no comm) +
    d/dx through the transpose under the dual contraction-shard (one
    all-reduce of the (B, m) activation cotangent) + two comm-free
    value-gradient products. Per-chip memory work is ~4 format passes
    (fwd, dx, dvals, dvals_t — each streams ~the slab's bytes)."""
    slab = format_bytes if format_bytes is not None else m * n * 4
    compute = 4 * slab / (hbm_gbps * 1e9)
    d = n_devices
    dx_bytes = batch * m * 4               # replicated activation cotangent
    link = int(2 * (d - 1) / d * dx_bytes)
    comm = link / (link_gbps * 1e9)
    call = compute + comm                  # the psum follows the dx product
    return CommEstimate(partition="train", compute_s=compute,
                        link_bytes=link, comm_s=comm, call_s=call,
                        efficiency=compute / call if call else 1.0,
                        collectives=("all-reduce",))


def report(m: int = 4096, n: int = 4096, batch: int = 1,
           device_counts: tuple[int, ...] = (2, 4, 8, 16),
           format_bytes: int | None = None) -> str:
    lines = [f"comm model: per-chip slab {m}x{n} fp32"
             f"{'' if format_bytes is None else f' ({format_bytes/1e6:.1f} MB packed)'},"
             f" B={batch}, memory {HBM_GBPS:.0f} GB/s, link "
             f"{LINK_GBPS:.0f} GB/s each way (data-sheet figures)"]
    for d in device_counts:
        for p in ("n", "m", "ring"):
            e = comm_model(p, m=m, n=n, batch=batch, n_devices=d,
                           format_bytes=format_bytes)
            lines.append(f"D={d:3d} {e}")
        # DIA stencil halo at a representative band (max|offset| 512/side)
        eh = comm_model("halo", m=m, n=n, batch=batch, n_devices=d,
                        format_bytes=format_bytes, halo=1024,
                        vals_halo=3 * 512)
        lines.append(f"D={d:3d} {eh}")
        t = train_model(m=m, n=n, batch=batch, n_devices=d,
                        format_bytes=format_bytes)
        lines.append(f"D={d:3d} {t}")
    return "\n".join(lines)


if __name__ == "__main__":
    print(report())
