"""The `Strategy` protocol — one decision API for offline trace
evaluation and the online serving engine.

A strategy keeps all mutable quantities in a small state dataclass of
per-lane tensors, and its three methods are pure:

  * ``init(batch) -> state``            — fresh per-lane state.
  * ``observe(state, node, losses, active, aux) -> (state, active)``
        — fold in node ``node``'s per-lane losses; returns the updated
        state and the mask of lanes that should CONTINUE past this node.
  * ``serve(state) -> served_node``     — which node's output each lane
        returns if it stops now (with recall this is the argmin node).

``node`` is a Python int.  ``aux`` is an optional int32 per-lane side
channel: predicted labels for patience-style strategies (the engine
supplies the argmax of each readout's logits there), or precomputed
support bins for table strategies built without a ``Support`` (offline
evaluation against pre-quantized traces).  Every state carries
``explore_cost`` (f32 per lane) and ``n_probed`` (i32 per lane), which
``evaluate`` reads back together with ``serve``.

A strategy's ``swap_attrs`` names the tensors that parameterize its
decisions (solved tables, supports, thresholds, costs): `dynamic_arrays`
reads them and `with_arrays` swaps same-shaped ones in, the contract a
strategy bank's slot keeps across a republish.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Protocol, Tuple, runtime_checkable

import torch

__all__ = ["State", "PolicyResult", "Strategy", "evaluate", "reset_lanes",
           "init_lane", "dynamic_arrays", "array_leaves", "with_arrays"]


@dataclasses.dataclass(frozen=True)
class State:
    """Base of the strategies' state dataclasses: every field is a
    ``(B, ...)`` per-lane tensor."""

    def map(self, fn, *others):
        """A state of the same type whose fields are ``fn(field,
        *same_field_of_others)``."""
        return type(self)(**{
            f.name: fn(getattr(self, f.name),
                       *(getattr(o, f.name) for o in others))
            for f in dataclasses.fields(self)})


@dataclasses.dataclass(frozen=True)
class PolicyResult:
    """Outcome of running a strategy over a batch of traces."""

    served_node: torch.Tensor   # (T,) — node whose prediction is returned
    served_loss: torch.Tensor   # (T,) — loss of the served node
    explore_cost: torch.Tensor  # (T,) — sum of inspection costs paid
    n_probed: torch.Tensor      # (T,) — number of nodes inspected

    @property
    def total(self) -> torch.Tensor:
        return self.served_loss + self.explore_cost

    def mean_total(self) -> torch.Tensor:
        return torch.mean(self.total)


@runtime_checkable
class Strategy(Protocol):
    """Structural protocol — any object with these members qualifies."""

    n_nodes: int
    lam: float       # scale applied to incoming losses inside observe
    online: bool     # False => needs hindsight; engine refuses it

    def init(self, batch: int):
        ...

    def observe(self, state, node: int, losses: torch.Tensor,
                active: torch.Tensor,
                aux: torch.Tensor | None = None) -> Tuple[object,
                                                          torch.Tensor]:
        ...

    def serve(self, state) -> torch.Tensor:
        ...


def dynamic_arrays(strategy: Strategy) -> dict:
    """The strategy's swappable decision parameters, keyed by attribute
    name (``{}`` for strategies without ``swap_attrs``: the oracles)."""
    return {name: getattr(strategy, name)
            for name in getattr(strategy, "swap_attrs", ())}


def array_leaves(arrays: dict) -> list:
    """The tensors of a strategy's dynamic arrays (a dict of tensors or
    of dataclasses of tensors), in a fixed order."""
    out = []
    for value in arrays.values():
        if isinstance(value, torch.Tensor):
            out.append(value)
        else:
            out += [getattr(value, f.name)
                    for f in dataclasses.fields(value)]
    return out


def with_arrays(strategy: Strategy, arrays: dict) -> Strategy:
    """Shallow clone of ``strategy`` with its dynamic arrays replaced;
    static structure (lam, node count, patience) stays as it was."""
    if not arrays:
        return strategy
    clone = copy.copy(strategy)
    for name, value in arrays.items():
        setattr(clone, name, value)
    return clone


def reset_lanes(strategy: Strategy, state: State, mask) -> State:
    """Per-lane state reset — the runtime's lane-recycling primitive:
    lanes where ``mask`` is True get fresh ``init`` values, the others
    keep their state bit for bit."""
    mask = torch.as_tensor(mask)
    b = mask.shape[0]
    fresh = strategy.init(b)
    mask = mask.to(fresh.n_probed.device)

    def sel(f, s):
        return torch.where(mask.reshape((b,) + (1,) * (s.dim() - 1)), f, s)

    return fresh.map(sel, state)


def init_lane(strategy: Strategy, state: State, lane: int) -> State:
    """Reset a single lane of a batched state to its fresh ``init``."""
    b = state.n_probed.shape[0]
    return reset_lanes(strategy, state,
                       torch.arange(b, device=state.n_probed.device) == lane)


def evaluate(strategy: Strategy, losses, aux=None) -> PolicyResult:
    """Run ``strategy`` over offline traces, one ``observe`` per node.

    Args:
      losses: (T, n) per-node losses.
      aux: optional (T, n) int32 side channel (predictions / bins).

    ``served_loss`` is in the strategy's scaled units
    (``lam * losses[served]``).
    """
    losses = torch.as_tensor(losses, dtype=torch.float32)
    t, n = losses.shape
    if n != strategy.n_nodes:
        raise ValueError(f"traces have {n} nodes, strategy expects "
                         f"{strategy.n_nodes}")
    state = strategy.init(t)
    losses = losses.to(state.n_probed.device)
    active = torch.ones((t,), dtype=torch.bool, device=losses.device)
    if aux is not None:
        aux = torch.as_tensor(aux, device=losses.device).to(torch.int32)
    for node in range(n):
        state, active = strategy.observe(
            state, node, losses[:, node], active,
            aux=None if aux is None else aux[:, node])
    served = strategy.serve(state)
    served_loss = strategy.lam * torch.gather(
        losses, 1, served.long()[:, None])[:, 0]
    return PolicyResult(served_node=served, served_loss=served_loss,
                        explore_cost=state.explore_cost,
                        n_probed=state.n_probed)
