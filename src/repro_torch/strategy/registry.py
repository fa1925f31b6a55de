"""String registry mapping policy names to strategy factories.

``make("recall_index", cascade)`` builds a ready-to-serve strategy from
a calibrated `Cascade`; ``available()`` lists every registered name
(``available(online_only=True)`` the ones the serving engine takes).
The ten names are the JAX package's: the paper's table and index
policies (line, tree, skip), the no-recall and recall baselines, the
static endpoints and the two hindsight oracles.

Factories accept a ``lam`` override (default: the cascade's own) — pass
``lam=1.0`` when the traces fed are already lambda-scaled (the offline
pareto sweeps do this).
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from repro_torch.strategy.base import dynamic_arrays
from repro_torch.strategy.cascade import Cascade
from repro_torch.strategy.line import (FixedNodeStrategy, PatienceStrategy,
                                       RecallIndexStrategy,
                                       ThresholdStrategy, TreeIndexStrategy)
from repro_torch.strategy.oracle import OracleStrategy
from repro_torch.strategy.skip import SkipRecallStrategy

__all__ = ["register", "available", "make", "needs_tables",
           "slot_signature", "reserve_bank"]

_REGISTRY: Dict[str, Callable[..., object]] = {}
_ONLINE: Dict[str, bool] = {}
_NEEDS_TABLES: Dict[str, bool] = {}


def register(name: str, online: bool = True, needs_tables: bool = False):
    """Decorator: register a ``factory(cascade, **kwargs) -> Strategy``.

    ``online=False`` marks hindsight-only strategies (usable with
    `strategy.evaluate`, refused by the serving engine);
    ``needs_tables=True`` marks strategies whose factory solves DP
    tables, so callers can skip model calibration for the others.
    """
    def deco(factory):
        if name in _REGISTRY:
            raise ValueError(f"strategy {name!r} already registered")
        _REGISTRY[name] = factory
        _ONLINE[name] = online
        _NEEDS_TABLES[name] = needs_tables
        return factory
    return deco


def available(online_only: bool = False) -> tuple[str, ...]:
    return tuple(sorted(n for n in _REGISTRY
                        if not online_only or _ONLINE[n]))


def needs_tables(name: str) -> bool:
    """Does the named strategy consume solved DP tables (and therefore
    need a real calibrated cascade rather than a placeholder)?"""
    if name not in _NEEDS_TABLES:
        raise KeyError(f"unknown strategy {name!r}; available: "
                       f"{', '.join(available())}")
    return _NEEDS_TABLES[name]


def make(name: str, cascade: Cascade, **kwargs):
    """Build the named strategy from a `Cascade` spec."""
    try:
        factory = _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown strategy {name!r}; available: "
                       f"{', '.join(available())}") from None
    return factory(cascade, **kwargs)


def _leaves(prefix: str, value):
    """(path, tensor) pairs of a dynamic array: a tensor, or a dataclass
    of tensors (tables, supports), in field order."""
    if isinstance(value, torch.Tensor):
        return [(prefix, value)]
    return [(f"{prefix}.{name}", getattr(value, name))
            for name in value.__dataclass_fields__]


def slot_signature(strategy) -> tuple:
    """Structural signature a reserved bank slot keeps across swaps:
    the strategy's class, and the name, shape and dtype of every tensor
    of its dynamic arrays.  Two strategies with equal signatures can
    take each other's place in a bank without changing what the token
    step runs."""
    leaves = []
    for name, value in dynamic_arrays(strategy).items():
        leaves += _leaves(name, value)
    return (type(strategy).__name__,
            tuple((path, tuple(t.shape), str(t.dtype).removeprefix("torch."))
                  for path, t in leaves))


def reserve_bank(strategies) -> tuple:
    """Reserve strategy-bank slots: every member must serve online and
    all must agree on the node count.  Returns ``(strategies,
    signatures)``, the per-slot contract later swaps are held to."""
    strategies = tuple(strategies)
    if not strategies:
        raise ValueError("a strategy bank needs at least one slot")
    n = strategies[0].n_nodes
    for i, s in enumerate(strategies):
        if not getattr(s, "online", False):
            raise ValueError(f"slot {i}: {type(s).__name__} is a "
                             "hindsight-only strategy; banks serve online")
        if s.n_nodes != n:
            raise ValueError(f"slot {i} expects {s.n_nodes} nodes, slot 0 "
                             f"expects {n} — one bank serves one ladder")
    return strategies, tuple(slot_signature(s) for s in strategies)


def _lam(cascade: Cascade, lam) -> float:
    return cascade.lam if lam is None else float(lam)


@register("recall_index", needs_tables=True)
def _recall_index(c: Cascade, *, lam=None):
    return RecallIndexStrategy(c.solve_line(), c.support, costs=c.costs,
                               lam=_lam(c, lam))


@register("tree_index", needs_tables=True)
def _tree_index(c: Cascade, *, lam=None):
    return TreeIndexStrategy(c.solve_line(), c.support, costs=c.costs,
                             lam=_lam(c, lam))


@register("norecall_threshold")
def _norecall_threshold(c: Cascade, *, threshold=0.3, lam=None):
    return ThresholdStrategy(c.n_nodes, threshold, recall=False,
                             costs=c.costs, lam=_lam(c, lam))


@register("recall_threshold")
def _recall_threshold(c: Cascade, *, threshold=0.3, lam=None):
    return ThresholdStrategy(c.n_nodes, threshold, recall=True,
                             costs=c.costs, lam=_lam(c, lam))


@register("norecall_patience")
def _norecall_patience(c: Cascade, *, patience=2, lam=None):
    return PatienceStrategy(c.n_nodes, patience, costs=c.costs,
                            lam=_lam(c, lam))


@register("oracle", online=False)
def _oracle(c: Cascade, *, lam=None):
    return OracleStrategy(c.n_nodes, costs=c.costs, recall=True,
                          lam=_lam(c, lam))


@register("oracle_norecall", online=False)
def _oracle_norecall(c: Cascade, *, lam=None):
    return OracleStrategy(c.n_nodes, costs=c.costs, recall=False,
                          lam=_lam(c, lam))


@register("always_last")
def _always_last(c: Cascade, *, lam=None):
    return FixedNodeStrategy(c.n_nodes, c.n_nodes - 1, costs=c.costs,
                             lam=_lam(c, lam))


@register("always_first")
def _always_first(c: Cascade, *, lam=None):
    return FixedNodeStrategy(c.n_nodes, 0, costs=c.costs, lam=_lam(c, lam))


@register("skip_recall", needs_tables=True)
def _skip_recall(c: Cascade, *, mode="cumulative", lam=None):
    tables = c.solve_skip(mode)
    return SkipRecallStrategy(tables, c.support, c.edge_costs,
                              lam=_lam(c, lam))
