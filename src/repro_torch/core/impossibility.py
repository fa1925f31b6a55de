"""Theorem 3.4 construction: no-recall strategies admit no constant-factor
approximation, even with n = 2 and bounded supports.

The instance (proof sketch of Thm 3.4):

    R_1 = 1/alpha^2                 w.p. 1
    R_2 = 0 (we use eps>0 to keep Assumption 2.1)   w.p. 1 - 1/alpha
        = 1/alpha                                    w.p. 1/alpha

Any no-recall algorithm earns exactly 1/alpha^2 in expectation (stop at R_1:
pay 1/alpha^2; continue: E[R_2] = 1/alpha * 1/alpha = 1/alpha^2), while the
prophet pays E[min] = (1/alpha) * (1/alpha^2) -> ratio alpha, unbounded as
alpha grows.  ``benchmarks/impossibility`` sweeps alpha and reports the
measured ratio of the BEST no-recall policy vs OPT.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["Instance", "make_instance", "best_norecall_value",
           "offline_opt_value", "empirical_ratio"]


@dataclasses.dataclass(frozen=True)
class Instance:
    alpha: float
    r1: float
    r2_values: np.ndarray   # (2,)
    r2_probs: np.ndarray    # (2,)


def make_instance(alpha: float, eps: float = 0.0) -> Instance:
    a = float(alpha)
    return Instance(
        alpha=a,
        r1=1.0 / a**2,
        r2_values=np.array([eps, 1.0 / a]),
        r2_probs=np.array([1.0 - 1.0 / a, 1.0 / a]),
    )


def best_norecall_value(inst: Instance) -> float:
    """Expected loss of the best no-recall stopping rule.

    R_1 is deterministic, so the only choices are "stop at 1" (pay r1) or
    "always continue" (pay E[R_2]); randomization cannot beat the better
    pure rule.
    """
    e_r2 = float(inst.r2_values @ inst.r2_probs)
    return min(inst.r1, e_r2)


def offline_opt_value(inst: Instance) -> float:
    mins = np.minimum(inst.r1, inst.r2_values)
    return float(mins @ inst.r2_probs)


def empirical_ratio(inst: Instance, rng: np.random.Generator,
                    t: int = 200_000) -> tuple[float, float, float]:
    """Monte-Carlo check of the analytic ratio; returns
    (alg_value, opt_value, ratio)."""
    draws = rng.choice(inst.r2_values, size=t, p=inst.r2_probs)
    alg = min(inst.r1, float(np.mean(draws)))
    opt = float(np.mean(np.minimum(inst.r1, draws)))
    return alg, opt, alg / max(opt, 1e-300)
