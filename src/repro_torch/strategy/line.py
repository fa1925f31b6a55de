"""Line-topology strategies: the paper's table policy and the static
endpoints.

  * `RecallIndexStrategy` — Alg. 1 backed by the `LineTables.stop` table
    (O(1) gather per node per lane, Thm 4.5).
  * `FixedNodeStrategy`   — always_first / always_last static endpoints.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.line_dp import LineTables
from repro_torch.core.support import Support, quantize
from repro_torch.strategy.base import State

__all__ = ["RecallIndexStrategy", "FixedNodeStrategy", "RecallState",
           "FixedState"]


def _as_costs(costs, n: int, device) -> torch.Tensor:
    if costs is None:
        return torch.zeros((n,), dtype=torch.float32, device=device)
    costs = torch.as_tensor(costs, dtype=torch.float32, device=device)
    if costs.shape != (n,):
        raise ValueError(f"costs shape {tuple(costs.shape)} != ({n},)")
    return costs


@dataclasses.dataclass(frozen=True)
class RecallState(State):
    x_idx: torch.Tensor         # (B,) i32 — running-min X-axis index
    s_bin: torch.Tensor         # (B,) i32 — previous probed node's bin
    best_loss: torch.Tensor     # (B,) f32 — running min scaled loss
    best_node: torch.Tensor     # (B,) i32 — argmin node (recall target)
    explore_cost: torch.Tensor  # (B,) f32
    n_probed: torch.Tensor      # (B,) i32


class RecallIndexStrategy:
    """Alg. 1: probe while the if-stop table says continue, serve argmin."""

    online = True

    def __init__(self, tables: LineTables, support: Support | None,
                 costs=None, lam: float = 1.0):
        if support is None:
            raise ValueError("the port's RecallIndexStrategy quantizes "
                             "with its Support; pass the cascade's")
        self.tables = tables
        self.support = support
        self.lam = float(lam)
        self.n_nodes = tables.n
        self.costs = _as_costs(costs, tables.n, tables.stop.device)

    def init(self, batch: int) -> RecallState:
        dev = self.costs.device

        def full(v, dtype):
            return torch.full((batch,), v, dtype=dtype, device=dev)

        return RecallState(
            x_idx=full(self.tables.k + 1, torch.int32),
            s_bin=full(0, torch.int32),
            best_loss=full(float("inf"), torch.float32),
            best_node=full(0, torch.int32),
            explore_cost=full(0.0, torch.float32),
            n_probed=full(0, torch.int32))

    def observe(self, state: RecallState, node: int, losses, active,
                aux=None):
        scaled = self.lam * losses.float()
        b = quantize(self.support, scaled)
        explore = state.explore_cost + active * self.costs[node]
        n_probed = state.n_probed + active.to(torch.int32)
        better = active & (scaled < state.best_loss)
        best_loss = torch.where(better, scaled, state.best_loss)
        best_node = torch.where(better, node, state.best_node)
        x_idx = torch.where(active, torch.minimum(state.x_idx, b + 1),
                            state.x_idx)
        s_bin = torch.where(active, b, state.s_bin)
        # stop table for the NEXT node.  At the final node there is no
        # next row: clamp the row index explicitly (torch does not clamp
        # out-of-range gathers) — the (node + 1 < n) term forces a stop.
        row = self.tables.stop[min(node + 1, self.n_nodes - 1)]
        stop_next = row[s_bin.long(), x_idx.long()]
        cont = active & ~stop_next & (node + 1 < self.n_nodes)
        return RecallState(x_idx=x_idx, s_bin=s_bin, best_loss=best_loss,
                           best_node=best_node, explore_cost=explore,
                           n_probed=n_probed), cont

    def serve(self, state: RecallState) -> torch.Tensor:
        return state.best_node


@dataclasses.dataclass(frozen=True)
class FixedState(State):
    served: torch.Tensor
    explore_cost: torch.Tensor
    n_probed: torch.Tensor


class FixedNodeStrategy:
    """Static endpoints of the trade-off: always_first / always_last."""

    online = True

    def __init__(self, n_nodes: int, serve_node: int, costs=None,
                 lam: float = 1.0, device="cpu"):
        self.n_nodes = int(n_nodes)
        self.serve_node = int(serve_node) % self.n_nodes
        self.lam = float(lam)
        self.costs = _as_costs(costs, self.n_nodes, device)

    def init(self, batch: int) -> FixedState:
        dev = self.costs.device
        return FixedState(
            served=torch.full((batch,), self.serve_node, dtype=torch.int32,
                              device=dev),
            explore_cost=torch.zeros((batch,), dtype=torch.float32,
                                     device=dev),
            n_probed=torch.zeros((batch,), dtype=torch.int32, device=dev))

    def observe(self, state: FixedState, node: int, losses, active,
                aux=None):
        explore = state.explore_cost + active * self.costs[node]
        n_probed = state.n_probed + active.to(torch.int32)
        cont = active & (node < self.serve_node)
        return FixedState(served=state.served, explore_cost=explore,
                          n_probed=n_probed), cont

    def serve(self, state: FixedState) -> torch.Tensor:
        return state.served
