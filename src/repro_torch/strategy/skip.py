"""Skip-cascade strategy (§5.2): the transitive-closure NEXT table as a
streaming `Strategy`.

The solved `SkipTables.nxt` table stores, for every (last probed node,
previous bin, running-min X index), either STOP or the next node to
probe, possibly skipping intermediates.  Streamed over a line of nodes
in order, a lane ignores every node that is not its current target, so
the same object drives offline `strategy.evaluate` and the segment
engine (where a skipped node's readout is not consulted; whether its
backbone compute is saved too is what the edge-cost matrix encodes:
``skip_free`` for inter-model cascades, ``cumulative`` for intra-model
early exit).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.skip_dp import SkipTables
from repro_torch.core.support import Support
from repro_torch.strategy.base import State
from repro_torch.strategy.line import _bins, _full

__all__ = ["SkipRecallStrategy", "SkipState"]


@dataclasses.dataclass(frozen=True)
class SkipState(State):
    nxt_node: torch.Tensor      # (B,) i32 — next node to probe (STOP = -1)
    last: torch.Tensor          # (B,) i32 — last probed node (-1 = root)
    s_bin: torch.Tensor         # (B,) i32
    x_idx: torch.Tensor         # (B,) i32
    best_loss: torch.Tensor     # (B,) f32
    best_node: torch.Tensor     # (B,) i32
    explore_cost: torch.Tensor  # (B,) f32 — edge costs paid
    n_probed: torch.Tensor      # (B,) i32 — nodes actually probed


class SkipRecallStrategy:
    """Probe the NEXT table's target node, pay the traversed edge cost,
    serve the argmin probed node (recall)."""

    online = True
    # the walk follows a NEXT table solved from the root: it cannot be
    # pinned to a floor node mid-line
    jumps = True
    swap_attrs = ("tables", "support", "edge_costs")

    def __init__(self, tables: SkipTables, support: Support | None,
                 edge_costs, lam: float = 1.0):
        self.tables = tables
        self.support = support
        self.lam = float(lam)
        self.n_nodes = tables.n
        self.edge_costs = torch.as_tensor(edge_costs, dtype=torch.float32,
                                          device=tables.nxt.device)
        if self.edge_costs.shape != (self.n_nodes + 1, self.n_nodes + 1):
            raise ValueError(f"edge_costs shape "
                             f"{tuple(self.edge_costs.shape)} != "
                             f"({self.n_nodes + 1}, {self.n_nodes + 1})")

    def init(self, batch: int) -> SkipState:
        k = self.tables.k
        dev = self.tables.nxt.device
        # the root's decision (s is irrelevant there), kept on the device
        first = self.tables.nxt[0, 0, k + 1].repeat(batch)
        return SkipState(
            nxt_node=first,
            last=_full(batch, -1, torch.int32, dev),
            s_bin=_full(batch, 0, torch.int32, dev),
            x_idx=_full(batch, k + 1, torch.int32, dev),
            best_loss=_full(batch, float("inf"), torch.float32, dev),
            best_node=_full(batch, 0, torch.int32, dev),
            explore_cost=_full(batch, 0.0, torch.float32, dev),
            n_probed=_full(batch, 0, torch.int32, dev))

    def observe(self, state: SkipState, node: int, losses, active,
                aux=None):
        probe = active & (state.nxt_node == node)
        scaled = self.lam * losses.float()
        b = _bins(self.support, scaled, aux)
        edge = self.edge_costs[(state.last + 1).long(), node + 1]
        explore = state.explore_cost + probe * edge
        n_probed = state.n_probed + probe.to(torch.int32)
        better = probe & (scaled < state.best_loss)
        best_loss = torch.where(better, scaled, state.best_loss)
        best_node = torch.where(better, node, state.best_node)
        x_idx = torch.where(probe, torch.minimum(state.x_idx, b + 1),
                            state.x_idx)
        s_bin = torch.where(probe, b, state.s_bin)
        last = torch.where(probe, node, state.last)
        nxt_new = self.tables.nxt[node + 1][s_bin.long(), x_idx.long()]
        nxt_node = torch.where(probe, nxt_new, state.nxt_node)
        # STOP (-1) and exhausted lines both fail `nxt_node > node`
        cont = active & (nxt_node > node)
        return SkipState(nxt_node=nxt_node, last=last, s_bin=s_bin,
                         x_idx=x_idx, best_loss=best_loss,
                         best_node=best_node, explore_cost=explore,
                         n_probed=n_probed), cont

    def serve(self, state: SkipState) -> torch.Tensor:
        return state.best_node
