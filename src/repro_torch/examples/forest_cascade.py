"""Forest / multi-line cascade (§5.1, Thm C.7; the JAX package's
``examples/forest_cascade.py``): the serving platform holds two
independent cascades for the same task — a fast 2-stage line and an
accurate 3-stage line — and T-Tamer's generalized dynamic index decides,
query by query, which branch to probe next and when to stop (probing can
interleave between branches).

The forest solvers are host code in both packages (numpy), so nothing
here runs on the device; ``--device`` is taken as every example takes
it, and refused where it names a card that is not there.

  PYTHONPATH=src python -m repro_torch.examples.forest_cascade --device cpu
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core import tree_dp
from repro_torch.launch.serve import device_of


def line_dists(grid, qualities, sharp):
    """Per-node conditional loss dists of one line: better nodes put
    mass low, each node correlated with its parent."""
    k = len(grid)
    p0 = np.exp(-sharp * np.abs(grid - qualities[0]))
    p0 /= p0.sum()
    trans = []
    for q in qualities[1:]:
        t = np.zeros((k, k))
        for s in range(k):
            center = 0.6 * grid[s] + 0.4 * q
            row = np.exp(-sharp * np.abs(grid - center))
            t[s] = row / row.sum()
        trans.append(np.asarray(t))
    return p0, trans


def sample_line(rng, bins, base, p0, trans, t):
    """Draw ``t`` realizations of one line's bins into columns
    ``base ..`` of ``bins``."""
    k = len(p0)
    bins[:, base] = rng.choice(k, size=t, p=p0)
    for i, tr in enumerate(trans):
        for s in range(k):
            m = bins[:, base + i] == s
            bins[m, base + i + 1] = rng.choice(k, size=m.sum(), p=tr[s])


def main(argv=None) -> dict:
    """Print the reference's lines; return every number printed."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; the solvers are "
                    "numpy)")
    device_of(ap.parse_args(argv).device)

    rng = np.random.default_rng(0)
    k = 8
    grid = np.linspace(0.05, 1.0, k)
    # Branch A: cheap 2-stage cascade (fast, mediocre).
    # Branch B: expensive 3-stage cascade (slow, accurate).
    p0a, ta = line_dists(grid, [0.55, 0.40], sharp=6.0)
    p0b, tb = line_dists(grid, [0.50, 0.30, 0.12], sharp=6.0)
    lam = 0.75
    costs_a = (1 - lam) * np.array([0.08, 0.20])
    costs_b = (1 - lam) * np.array([0.10, 0.30, 0.55])

    forest = tree_dp.forest_from_lines([
        (p0a, ta, costs_a, grid), (p0b, tb, costs_b, grid)])
    opt = tree_dp.solve_forest_exact(forest)
    pol = tree_dp.index_policy_value(forest)
    print(f"expectimax optimum: {opt:.4f}")
    print(f"dynamic-index policy (Thm C.7): {pol:.4f} "
          f"(gap {abs(pol - opt):.2e} — provably 0)")

    # simulate on sampled realizations
    t = 4000
    bins = np.zeros((t, forest.n), np.int64)
    sample_line(rng, bins, 0, p0a, ta, t)
    sample_line(rng, bins, len(costs_a), p0b, tb, t)
    served, spent, nprobe = tree_dp.simulate_forest(forest, bins)
    simulated = float((served + spent).mean())
    probed = float(nprobe.mean())
    print(f"\nsimulated objective: {simulated:.4f} "
          f"(mean nodes probed {probed:.2f} of {forest.n})")
    print("interpretation: the index policy starts with the cheaper "
          "branch and escalates to the accurate cascade only for queries "
          "whose early losses stay high — interleaving two cascades "
          "without any hand-written routing rule.")
    return {"expectimax": float(opt), "index_policy": float(pol),
            "gap": abs(float(pol) - float(opt)), "simulated": simulated,
            "mean_probed": probed, "n_nodes": forest.n}


if __name__ == "__main__":
    main()
