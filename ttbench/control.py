"""The readings a cell's limit is set from, on the card: for each seed,
one set-up and one window at the cell's own load, then, through the
harness's own comparison on the same sample and positions, the
program's reading and the control's (the reference on TF32-rounded
operands in the program's place), each with the verdict a run would
give it.

    python3 ttbench/control.py --workload <cell> --seeds 1,2,3 \
        --seconds 30

Prints one JSON line a seed.  The benchmark's own runs never run it.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

from ttbench import harness  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("control: needs a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = harness.Cell(ROOT, args.workload)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        prog = harness.setup(cell, seed, device, [])
        run = harness.serve_window(cell, prog, args.seconds, seed, False)
        chosen = harness.sample(run, seed)
        params, calib = prog.params, prog.calib_tokens
        del prog, run.records
        harness.stepper_gone(run)
        tables = harness.reference_tables(cell, params, calib)
        out = {"workload": args.workload, "seed": seed}
        for side in ("program", "control"):
            got = harness.judge(cell, params, tables, chosen, run.cols,
                                control=side == "control")
            correct, check = harness.verdict(cell, got)
            out[side] = {"correct": correct,
                         "served_gap": got["served_gap"],
                         "tokens": got["tokens"],
                         "requests": got["requests"],
                         "other_node": got["other_node"],
                         "nodes": got["nodes"], "ties": got["ties"],
                         "followed": got["followed"],
                         "capped": got["capped"]}
        out["limit"] = check["served_gap"]["limit"]
        out["seconds"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)
        del params
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
