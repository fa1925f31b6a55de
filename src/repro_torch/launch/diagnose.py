"""Dry-run diagnostics (the JAX package's ``launch/diagnose.py``): trace
one (arch x shape) step on the production mesh and print its top per-op
records by bytes (a call's bytes x calls), beside the per-device flops,
HBM bytes and wire bytes (the `launch.op_cost` cost model).

  PYTHONPATH=src python -m repro_torch.launch.diagnose --arch qwen3-14b \
      --shape prefill_32k [--multi-pod] [--top 25]

Importing it imports `repro_torch.launch.dryrun`, which sets up the
512-rank fake world: run it in a process of its own.
"""

from __future__ import annotations

import argparse

from repro_torch.launch import dryrun, op_cost
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.shapes import SHAPES
from repro_torch.sharding.rules import BASELINE_RULES

__all__ = ["top_traffic", "main"]


def top_traffic(cost: op_cost.OpCost, top: int = 25):
    """The ``top`` records by bytes (a call's bytes x calls): (bytes,
    calls, op, result shape)."""
    rows = [(r["bytes"], r["count"], r["op"], r["shape"])
            for r in cost.records]
    rows.sort(key=lambda r: r[0], reverse=True)
    return rows[:top]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args(argv)

    mesh = make_production_mesh(multi_pod=args.multi_pod)
    cost = dryrun.trace(args.arch, args.shape, mesh, BASELINE_RULES)[0]
    print(f"flops/dev {cost.flops:.3g}  hbm {cost.hbm_bytes / 2**30:.1f} GiB"
          f"  wire {cost.wire_bytes / 2**30:.2f} GiB")
    print(f"{'GiB*calls':>10} {'calls':>6}  op / shape")
    for b, n, op, shape in top_traffic(cost, args.top):
        print(f"{b / 2**30:10.2f} {n:6d}  {op:28s} {shape[:60]}")


if __name__ == "__main__":
    main()
