"""Accuracy-latency Pareto frontier sweeps (paper §6, Figs. 4-5).

Given per-ramp calibration traces of an EE workload —
  losses  (T, n): proxy loss per ramp (1 - confidence),
  correct (T, n): does ramp i's label match the backbone's,
  flops   (n,):  incremental cost of segment i (normalized so sum == 1) —
we sweep the trade-off parameter lambda (Def. D.1 latency-aware loss
``theta = lambda * l_j + (1 - lambda) * sum_k c_k``; the paper swaps
lambda's role between §1.2 and Def. D.1 — we fix lambda as the *accuracy*
weight) and, per lambda:

  1. split traces into fit/eval halves,
  2. build a `strategy.Cascade` on the fit half (support + Markov chain
     + line DP),
  3. run every strategy from the registry on the eval half through the
     single batched ``strategy.evaluate``, recording
     (error vs backbone, normalized latency).

Error = 1 - Acc where Acc is agreement with the backbone output (§6
Metrics); latency is normalized against always running the full backbone.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch import strategy

__all__ = ["FrontierPoint", "sweep", "pareto_filter"]


@dataclasses.dataclass(frozen=True)
class FrontierPoint:
    policy: str
    lam: float
    error: float          # 1 - agreement with backbone
    latency: float        # normalized expected latency (1.0 = full model)
    objective: float      # mean theta_lambda achieved
    mean_probed: float


def _metrics(name, lam, res, correct, n) -> FrontierPoint:
    served = res.served_node.cpu().numpy()
    t = served.shape[0]
    agree = correct[np.arange(t), served]
    # explore_cost carries the (1-lam) objective weight; normalized
    # latency divides it back out (flops sum to 1 => latency in (0, 1]).
    denom = max(1.0 - lam, 1e-9)
    return FrontierPoint(
        policy=name,
        lam=float(lam),
        error=float(1.0 - agree.mean()),
        latency=float(res.explore_cost.mean()) / denom,
        objective=float(res.total.mean()),
        mean_probed=float(res.n_probed.float().mean()),
    )


def sweep(losses: np.ndarray, correct: np.ndarray, flops: np.ndarray,
          lambdas, k: int = 32,
          thresholds=(0.02, 0.05, 0.1, 0.2, 0.3, 0.5)) -> list[FrontierPoint]:
    """Run the full strategy comparison across the lambda grid."""
    t, n = losses.shape
    half = t // 2
    fit_l, ev_l = losses[:half], losses[half:]
    ev_c = correct[half:]
    out: list[FrontierPoint] = []
    for lam in lambdas:
        lam = float(lam)
        # cascade tables live in the lambda-scaled domain; the eval half
        # is pre-scaled too, so strategies run with lam=1.0 (no rescale)
        casc = strategy.Cascade.from_traces(fit_l, (1.0 - lam) * flops,
                                            k=k, lam=lam)
        scaled_ev = lam * ev_l

        def run(name: str, **kw):
            strat = strategy.make(name, casc, lam=1.0, **kw)
            return strategy.evaluate(strat, scaled_ev)

        out.append(_metrics("recall_index", lam, run("recall_index"),
                            ev_c, n))
        for thr in thresholds:
            out.append(_metrics(
                f"norecall_thr={thr}", lam,
                run("norecall_threshold", threshold=lam * thr), ev_c, n))
            out.append(_metrics(
                f"recall_thr={thr}", lam,
                run("recall_threshold", threshold=lam * thr), ev_c, n))
        out.append(_metrics("oracle", lam, run("oracle"), ev_c, n))
        out.append(_metrics("always_last", lam, run("always_last"),
                            ev_c, n))
    return out


def pareto_filter(points: list[FrontierPoint],
                  by_policy_prefix: str | None = None) -> list[FrontierPoint]:
    """Non-dominated (error, latency) subset, optionally per policy family."""
    pts = [p for p in points
           if by_policy_prefix is None or p.policy.startswith(by_policy_prefix)]
    pts = sorted(pts, key=lambda p: (p.latency, p.error))
    front: list[FrontierPoint] = []
    best_err = np.inf
    for p in pts:
        if p.error < best_err - 1e-12:
            front.append(p)
            best_err = p.error
    return front
