"""Find a cell's knee once, by a sweep on the card: one set-up, then one
window a rate, each printing what it completed and how its queue grew.

    python3 ttbench/sweep.py --workload <cell> --rates 4,6,8 --seconds 20

The knee is the highest rate whose queue (requests due but not yet on a
lane) stays bounded through the window.  The benchmark itself never
searches: a cell's traffic file holds the rate this sweep chose.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

from ttbench import harness  # noqa: E402


def queue_at(run, t) -> int:
    due = sum(1 for r in run.reqs if r["arrival"] <= t)
    on_lane = sum(1 for rec in run.records.values()
                  if rec.admitted is not None and rec.admitted <= t)
    return due - on_lane


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("sweep: needs a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = harness.Cell(ROOT, args.workload)
    laps = []
    prog = harness.setup(cell, args.seed, device, laps)
    base = dict(cell.mix)
    for rate in [float(r) for r in args.rates.split(",")]:
        cell.mix = dict(base, rate=rate)
        run = harness.serve_window(cell, prog, args.seconds, args.seed,
                                   False, check=False)
        e2e = harness.end_to_end(run)
        w = args.seconds
        out_tok = sum(r["max_tokens"] for r in run.reqs) / w
        done = sum(1 for rec in run.records.values()
                   if rec.status == "completed")
        chunked = sum(1 for s in run.steps if s.chunk)
        print(json.dumps({
            "workload": args.workload, "rate": rate,
            "due": len(run.reqs), "completed": done,
            "offered_tokens_per_s": out_tok,
            "tokens_per_s": e2e["tokens_per_s"],
            "ttft_p50_ms": e2e["_ttft_p50_ms"],
            "ttft_p95_ms": e2e["ttft_p95_ms"],
            "itl_p50_ms": e2e["_itl_p50_ms"],
            "itl_p95_ms": e2e["itl_p95_ms"],
            "steps": len(run.steps), "chunk_steps": chunked,
            "queue": [queue_at(run, f * w) for f in (0.25, 0.5, 0.75,
                                                      1.0)]}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
