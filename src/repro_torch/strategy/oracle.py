"""Offline oracle strategies (hindsight baselines, Def. 3.2 analogues).

They need the whole trace before committing to a stop point, so they
are ``online = False``: `strategy.evaluate` scans them over every node,
the state tracking the best prefix seen so far, and the serving engine
refuses them (it cannot un-run segments).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.strategy.base import State
from repro_torch.strategy.line import _as_costs, _full

__all__ = ["OracleStrategy", "OracleState"]


@dataclasses.dataclass(frozen=True)
class OracleState(State):
    pmin_val: torch.Tensor      # (B,) f32 — prefix min of scaled losses
    pmin_node: torch.Tensor     # (B,) i32 — prefix argmin (first occurrence)
    prefix_cost: torch.Tensor   # (B,) f32 — cumulative inspection cost
    best_total: torch.Tensor    # (B,) f32 — best prefix objective so far
    best_served: torch.Tensor   # (B,) i32 — served node at the best prefix
    explore_cost: torch.Tensor  # (B,) f32 — cost paid at the best prefix
    n_probed: torch.Tensor      # (B,) i32 — prefix length at the best prefix


class OracleStrategy:
    """Best stopping prefix under full foresight.

    With ``recall`` the served node is the prefix argmin (offline optimum
    with recall); without, the policy serves the node it stops at
    (``oracle_norecall``).
    """

    online = False

    def __init__(self, n_nodes: int, costs=None, recall: bool = True,
                 lam: float = 1.0):
        self.n_nodes = int(n_nodes)
        self.recall = bool(recall)
        self.lam = float(lam)
        self.costs = _as_costs(costs, self.n_nodes)

    def init(self, batch: int) -> OracleState:
        dev = self.costs.device
        inf = float("inf")
        return OracleState(
            pmin_val=_full(batch, inf, torch.float32, dev),
            pmin_node=_full(batch, 0, torch.int32, dev),
            prefix_cost=_full(batch, 0.0, torch.float32, dev),
            best_total=_full(batch, inf, torch.float32, dev),
            best_served=_full(batch, 0, torch.int32, dev),
            explore_cost=_full(batch, 0.0, torch.float32, dev),
            n_probed=_full(batch, 0, torch.int32, dev))

    def observe(self, state: OracleState, node: int, losses, active,
                aux=None):
        scaled = self.lam * losses.float()
        better = scaled < state.pmin_val
        pmin_val = torch.where(better, scaled, state.pmin_val)
        pmin_node = torch.where(better, node, state.pmin_node)
        prefix_cost = state.prefix_cost + self.costs[node]
        cand = pmin_val if self.recall else scaled
        total = cand + prefix_cost
        improve = total < state.best_total    # strict: first argmin
        best_total = torch.where(improve, total, state.best_total)
        served_here = pmin_node if self.recall else \
            torch.full_like(pmin_node, node)
        best_served = torch.where(improve, served_here, state.best_served)
        explore = torch.where(improve, prefix_cost, state.explore_cost)
        n_probed = torch.where(improve, node + 1, state.n_probed)
        # hindsight: keep scanning every node regardless of `active`
        return OracleState(pmin_val=pmin_val, pmin_node=pmin_node,
                           prefix_cost=prefix_cost, best_total=best_total,
                           best_served=best_served, explore_cost=explore,
                           n_probed=n_probed), active

    def serve(self, state: OracleState) -> torch.Tensor:
        return state.best_served
