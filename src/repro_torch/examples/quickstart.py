"""Quickstart: T-Tamer in 60 seconds (the JAX package's
``examples/quickstart.py``).

Calibrates a `Cascade` on a synthetic early-exit workload, builds the
paper's dynamic-index strategy (and the baselines) from the string
registry, and compares them on the lambda-weighted objective through the
one batched evaluator that also drives the serving engine
(Thm 4.5 / Thm 3.4 in action).  On the card the line solve runs through
the Bellman-backup kernel (one launch).

  PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu
  PYTHONPATH=src python -m repro_torch.examples.quickstart     # the card
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import strategy
from repro_torch.core import traces
from repro_torch.launch.serve import device_of


def main(argv=None, *, kernels: bool = True) -> dict:
    """Print the reference's lines; return every number printed.
    ``kernels=False`` solves the line with the plain backups (the card's
    check of the kernel route)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda)")
    args = ap.parse_args(argv)
    device = device_of(args.device)

    rng = np.random.default_rng(0)
    # 1. An 8-ramp early-exit workload with "overthinking" (deeper ramps
    #    are sometimes worse -> recall matters).
    losses, _, flops = traces.ee_like_traces(rng, 20_000, 8,
                                             overthink_prob=0.25)
    lam = 0.6

    # 2. Calibrate: support + Markov chain + DP tables (Alg. 2), bundled
    #    in a Cascade spec.  Tables live in the lambda-scaled domain.
    fit, ev = losses[:10_000], losses[10_000:]
    casc = strategy.Cascade.from_traces(fit, (1 - lam) * flops, k=32,
                                        lam=lam, device=device,
                                        use_kernel=kernels)
    optimum = float(casc.solve_line().value)
    print(f"online-optimal expected objective (Def. 4.2): {optimum:.4f}")
    print(f"registered strategies: {', '.join(strategy.available())}")

    # 3. Serve the eval half with every strategy (Alg. 1 = recall_index).
    #    The eval traces are pre-scaled, so strategies run with lam=1.
    ev_t = torch.as_tensor(lam * ev, dtype=torch.float32, device=device)
    runs = {
        "recall_index (T-Tamer)": strategy.make("recall_index", casc,
                                                lam=1.0),
        "tree_index (exact sigma)": strategy.make("tree_index", casc,
                                                  lam=1.0),
        "norecall_threshold=0.1": strategy.make(
            "norecall_threshold", casc, threshold=lam * 0.1, lam=1.0),
        "norecall_threshold=0.3": strategy.make(
            "norecall_threshold", casc, threshold=lam * 0.3, lam=1.0),
        "always_last (backbone)": strategy.make("always_last", casc,
                                                lam=1.0),
        "offline oracle": strategy.make("oracle", casc, lam=1.0),
    }
    print(f"{'strategy':28s} {'objective':>9s} {'explored':>8s} "
          f"{'served-node':>11s}")
    table = {}
    for name, strat in runs.items():
        r = strategy.evaluate(strat, ev_t)
        table[name] = {
            "objective": float(r.mean_total()),
            "explored": float(r.n_probed.float().mean()),
            "served_node": float(r.served_node.float().mean())}
        row = table[name]
        print(f"{name:28s} {row['objective']:9.4f} {row['explored']:8.2f} "
              f"{row['served_node']:11.2f}")
    best_heur = min(v["objective"] for n, v in table.items()
                    if "threshold" in n)
    better = 100 * (best_heur - table["recall_index (T-Tamer)"]["objective"]
                    ) / best_heur
    print(f"\nT-Tamer vs best threshold: {better:.1f}% better on the "
          f"lambda-objective")
    return {"optimum": optimum, "strategies": table,
            "better_than_threshold_pct": better}


if __name__ == "__main__":
    main()
