"""String registry mapping policy names to strategy factories.

``make("recall_index", cascade)`` builds a ready-to-serve strategy from
a calibrated `Cascade`; ``available()`` lists every registered name.
Factories accept a ``lam`` override (default: the cascade's own).
"""

from __future__ import annotations

from typing import Callable, Dict

from repro_torch.strategy.cascade import Cascade
from repro_torch.strategy.line import FixedNodeStrategy, RecallIndexStrategy

__all__ = ["register", "available", "make", "needs_tables"]

_REGISTRY: Dict[str, Callable[..., object]] = {}
_NEEDS_TABLES: Dict[str, bool] = {}


def register(name: str, needs_tables: bool = False):
    """Decorator: register a ``factory(cascade, **kwargs) -> Strategy``.
    ``needs_tables=True`` marks strategies whose factory solves DP
    tables, so callers can skip model calibration for the others."""
    def deco(factory):
        if name in _REGISTRY:
            raise ValueError(f"strategy {name!r} already registered")
        _REGISTRY[name] = factory
        _NEEDS_TABLES[name] = needs_tables
        return factory
    return deco


def available() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def needs_tables(name: str) -> bool:
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


def _lam(cascade: Cascade, lam) -> float:
    return cascade.lam if lam is None else float(lam)


@register("recall_index", needs_tables=True)
def _recall_index(c: Cascade, *, lam=None):
    return RecallIndexStrategy(c.solve_line(), c.support, costs=c.costs,
                               lam=_lam(c, lam))


@register("always_last")
def _always_last(c: Cascade, *, lam=None):
    return FixedNodeStrategy(c.n_nodes, c.n_nodes - 1, costs=c.costs,
                             lam=_lam(c, lam), device=c.costs.device)
