"""Line-topology strategies: the paper's table and index policies and the
classic early-exit baselines.

  * `RecallIndexStrategy` — Alg. 1 backed by the `LineTables.stop` table
    (O(1) gather per node per lane, Thm 4.5).
  * `TreeIndexStrategy`   — the exact dynamic index sigma(s, i) of
    Def. 4.4, the single-line member of the tree-index family (§5.1):
    probe while the running min X exceeds the next node's index.
  * `ThresholdStrategy`   — DeeBERT/BranchyNet confidence thresholds,
    with or without recall.
  * `PatienceStrategy`    — PABEE consecutive-agreement stopping (reads
    the predictions on the ``aux`` channel).
  * `FixedNodeStrategy`   — always_first / always_last static endpoints.

A table strategy built without a `Support` reads precomputed bins from
``aux`` instead of quantizing (offline evaluation on pre-binned traces);
the serving engine refuses such a strategy, since it supplies
predictions there.  The tables' last row is the last node's: at the
final node the "next" row is clamped explicitly (torch does not clamp an
out-of-range index, the JAX package's gather does), and the
``node + 1 < n`` term forces the stop.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.line_dp import LineTables
from repro_torch.core.support import Support, quantize
from repro_torch.strategy.base import State

__all__ = ["RecallIndexStrategy", "TreeIndexStrategy", "ThresholdStrategy",
           "PatienceStrategy", "FixedNodeStrategy", "RecallState",
           "TreeIndexState", "ThresholdState", "PatienceState", "FixedState"]


def _as_costs(costs, n: int, device=None) -> torch.Tensor:
    """(n,) f32 costs on ``device`` (default: the costs' own device, or
    the CPU for non-tensors); zeros when ``costs`` is None."""
    if device is None:
        device = costs.device if isinstance(costs, torch.Tensor) else "cpu"
    if costs is None:
        return torch.zeros((n,), dtype=torch.float32, device=device)
    costs = torch.as_tensor(costs, dtype=torch.float32, device=device)
    if costs.shape != (n,):
        raise ValueError(f"costs shape {tuple(costs.shape)} != ({n},)")
    return costs


def _bins(support: Support | None, scaled, aux) -> torch.Tensor:
    """Support-quantized int32 bins, or the precomputed ``aux`` bins when
    the strategy was built without a Support."""
    if support is not None:
        return quantize(support, scaled)
    if aux is None:
        raise ValueError("strategy built without a Support needs "
                         "precomputed bins on the aux channel")
    return aux.to(torch.int32)


def _full(batch: int, value, dtype, device) -> torch.Tensor:
    return torch.full((batch,), value, dtype=dtype, device=device)


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
    swap_attrs = ("tables", "support", "costs")

    def __init__(self, tables: LineTables, support: Support | None,
                 costs=None, lam: float = 1.0):
        self.tables = tables
        self.support = support
        self.lam = float(lam)
        self.n_nodes = tables.n
        self.costs = _as_costs(costs, tables.n, tables.stop.device)

    def init(self, batch: int) -> RecallState:
        dev = self.costs.device
        return RecallState(
            x_idx=_full(batch, self.tables.k + 1, torch.int32, dev),
            s_bin=_full(batch, 0, torch.int32, dev),
            best_loss=_full(batch, float("inf"), torch.float32, dev),
            best_node=_full(batch, 0, torch.int32, dev),
            explore_cost=_full(batch, 0.0, torch.float32, dev),
            n_probed=_full(batch, 0, torch.int32, dev))

    def observe(self, state: RecallState, node: int, losses, active,
                aux=None):
        scaled = self.lam * losses.float()
        b = _bins(self.support, scaled, aux)
        explore = state.explore_cost + active * self.costs[node]
        n_probed = state.n_probed + active.to(torch.int32)
        better = active & (scaled < state.best_loss)
        best_loss = torch.where(better, scaled, state.best_loss)
        best_node = torch.where(better, node, state.best_node)
        x_idx = torch.where(active, torch.minimum(state.x_idx, b + 1),
                            state.x_idx)
        s_bin = torch.where(active, b, state.s_bin)
        # stop table for the NEXT node (row clamped at the final node)
        row = self.tables.stop[min(node + 1, self.n_nodes - 1)]
        stop_next = row[s_bin.long(), x_idx.long()]
        cont = active & ~stop_next & (node + 1 < self.n_nodes)
        return RecallState(x_idx=x_idx, s_bin=s_bin, best_loss=best_loss,
                           best_node=best_node, explore_cost=explore,
                           n_probed=n_probed), cont

    def serve(self, state: RecallState) -> torch.Tensor:
        return state.best_node


@dataclasses.dataclass(frozen=True)
class TreeIndexState(State):
    s_bin: torch.Tensor
    x_val: torch.Tensor         # (B,) f32 — exact (unbinned) running min
    best_node: torch.Tensor
    explore_cost: torch.Tensor
    n_probed: torch.Tensor


class TreeIndexStrategy:
    """Exact dynamic-index policy: stop once X <= sigma(next | s).

    ``sigma`` is the off-grid indifference point the line DP recovers by
    linear interpolation (Def. 4.4); comparing the continuous running
    min against it is how the multi-line and tree index policies (§5.1,
    Thm C.7) rank branches.
    """

    online = True
    swap_attrs = ("tables", "support", "costs")

    def __init__(self, tables: LineTables, support: Support | None,
                 costs=None, lam: float = 1.0):
        self.tables = tables
        self.support = support
        self.lam = float(lam)
        self.n_nodes = tables.n
        self.costs = _as_costs(costs, tables.n, tables.sigma.device)

    def init(self, batch: int) -> TreeIndexState:
        dev = self.costs.device
        return TreeIndexState(
            s_bin=_full(batch, 0, torch.int32, dev),
            x_val=_full(batch, float("inf"), torch.float32, dev),
            best_node=_full(batch, 0, torch.int32, dev),
            explore_cost=_full(batch, 0.0, torch.float32, dev),
            n_probed=_full(batch, 0, torch.int32, dev))

    def observe(self, state: TreeIndexState, node: int, losses, active,
                aux=None):
        scaled = self.lam * losses.float()
        b = _bins(self.support, scaled, aux)
        explore = state.explore_cost + active * self.costs[node]
        n_probed = state.n_probed + active.to(torch.int32)
        better = active & (scaled < state.x_val)
        x_val = torch.where(better, scaled, state.x_val)
        best_node = torch.where(better, node, state.best_node)
        s_bin = torch.where(active, b, state.s_bin)
        sigma_next = self.tables.sigma[min(node + 1, self.n_nodes - 1)][
            s_bin.long()]
        # ties break toward stopping (Def. 4.4 "smallest solution")
        cont = active & (x_val > sigma_next) & (node + 1 < self.n_nodes)
        return TreeIndexState(s_bin=s_bin, x_val=x_val, best_node=best_node,
                              explore_cost=explore, n_probed=n_probed), cont

    def serve(self, state: TreeIndexState) -> torch.Tensor:
        return state.best_node


@dataclasses.dataclass(frozen=True)
class ThresholdState(State):
    last_node: torch.Tensor
    best_loss: torch.Tensor
    best_node: torch.Tensor
    explore_cost: torch.Tensor
    n_probed: torch.Tensor


class ThresholdStrategy:
    """Stop at the first node whose scaled loss clears its threshold."""

    online = True
    swap_attrs = ("thresholds", "costs")

    def __init__(self, n_nodes: int, thresholds, recall: bool = False,
                 costs=None, lam: float = 1.0):
        self.n_nodes = int(n_nodes)
        self.recall = bool(recall)
        self.lam = float(lam)
        self.costs = _as_costs(costs, self.n_nodes)
        thr = torch.as_tensor(thresholds, dtype=torch.float32,
                              device=self.costs.device)
        self.thresholds = thr.expand(self.n_nodes).contiguous()

    def init(self, batch: int) -> ThresholdState:
        dev = self.costs.device
        return ThresholdState(
            last_node=_full(batch, 0, torch.int32, dev),
            best_loss=_full(batch, float("inf"), torch.float32, dev),
            best_node=_full(batch, 0, torch.int32, dev),
            explore_cost=_full(batch, 0.0, torch.float32, dev),
            n_probed=_full(batch, 0, torch.int32, dev))

    def observe(self, state: ThresholdState, node: int, losses, active,
                aux=None):
        scaled = self.lam * losses.float()
        explore = state.explore_cost + active * self.costs[node]
        n_probed = state.n_probed + active.to(torch.int32)
        last_node = torch.where(active, node, state.last_node)
        better = active & (scaled < state.best_loss)
        best_loss = torch.where(better, scaled, state.best_loss)
        best_node = torch.where(better, node, state.best_node)
        hit = scaled <= self.thresholds[node]
        cont = active & ~hit & (node + 1 < self.n_nodes)
        return ThresholdState(last_node=last_node, best_loss=best_loss,
                              best_node=best_node, explore_cost=explore,
                              n_probed=n_probed), cont

    def serve(self, state: ThresholdState) -> torch.Tensor:
        return state.best_node if self.recall else state.last_node


@dataclasses.dataclass(frozen=True)
class PatienceState(State):
    prev_pred: torch.Tensor
    streak: torch.Tensor
    last_node: torch.Tensor
    explore_cost: torch.Tensor
    n_probed: torch.Tensor


class PatienceStrategy:
    """PABEE: exit after `patience` consecutive ramps agree (aux = preds).
    The engine's predictions are ``torch.argmax`` of each readout's
    logits, which, like ``jnp.argmax``, takes the first of tied values."""

    online = True
    needs_aux = True   # consumes predictions; loss-only replay can't drive it
    swap_attrs = ("costs",)   # patience itself is static control flow

    def __init__(self, n_nodes: int, patience: int, costs=None,
                 lam: float = 1.0):
        self.n_nodes = int(n_nodes)
        self.patience = int(patience)
        self.lam = float(lam)
        self.costs = _as_costs(costs, self.n_nodes)

    def init(self, batch: int) -> PatienceState:
        dev = self.costs.device
        return PatienceState(
            prev_pred=_full(batch, -1, torch.int32, dev),
            streak=_full(batch, 0, torch.int32, dev),
            last_node=_full(batch, 0, torch.int32, dev),
            explore_cost=_full(batch, 0.0, torch.float32, dev),
            n_probed=_full(batch, 0, torch.int32, dev))

    def observe(self, state: PatienceState, node: int, losses, active,
                aux=None):
        if aux is None:
            raise ValueError("PatienceStrategy needs predictions on the "
                             "aux channel")
        explore = state.explore_cost + active * self.costs[node]
        n_probed = state.n_probed + active.to(torch.int32)
        last_node = torch.where(active, node, state.last_node)
        same = (aux == state.prev_pred) & (node > 0)
        streak = torch.where(same, state.streak + 1, 0)
        hit = (streak >= self.patience) & (node > 0)
        cont = active & ~hit & (node + 1 < self.n_nodes)
        return PatienceState(prev_pred=aux.to(torch.int32), streak=streak,
                             last_node=last_node, explore_cost=explore,
                             n_probed=n_probed), cont

    def serve(self, state: PatienceState) -> torch.Tensor:
        return state.last_node


@dataclasses.dataclass(frozen=True)
class FixedState(State):
    served: torch.Tensor
    explore_cost: torch.Tensor
    n_probed: torch.Tensor


class FixedNodeStrategy:
    """Static endpoints of the trade-off: always_first / always_last."""

    online = True
    swap_attrs = ("costs",)   # serve_node is static by definition

    def __init__(self, n_nodes: int, serve_node: int, costs=None,
                 lam: float = 1.0):
        self.n_nodes = int(n_nodes)
        self.serve_node = int(serve_node) % self.n_nodes
        self.lam = float(lam)
        self.costs = _as_costs(costs, self.n_nodes)

    def init(self, batch: int) -> FixedState:
        dev = self.costs.device
        return FixedState(
            served=_full(batch, self.serve_node, torch.int32, dev),
            explore_cost=_full(batch, 0.0, torch.float32, dev),
            n_probed=_full(batch, 0, torch.int32, dev))

    def observe(self, state: FixedState, node: int, losses, active,
                aux=None):
        explore = state.explore_cost + active * self.costs[node]
        n_probed = state.n_probed + active.to(torch.int32)
        cont = active & (node < self.serve_node)
        return FixedState(served=state.served, explore_cost=explore,
                          n_probed=n_probed), cont

    def serve(self, state: FixedState) -> torch.Tensor:
        return state.served
