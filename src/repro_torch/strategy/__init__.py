"""repro_torch.strategy — the pluggable decision layer shared by trace
evaluation and the serving engine.

    from repro_torch import strategy
    casc = strategy.Cascade.from_traces(losses, costs, k=32, lam=0.6)
    strat = strategy.make("recall_index", casc)
    result = strategy.evaluate(strat, losses)
"""

from repro_torch.strategy.base import (PolicyResult, State, Strategy,
                                       evaluate, init_lane, reset_lanes)
from repro_torch.strategy.cascade import Cascade
from repro_torch.strategy.line import FixedNodeStrategy, RecallIndexStrategy
from repro_torch.strategy.registry import (available, make, needs_tables,
                                           register)

__all__ = ["Strategy", "State", "PolicyResult", "evaluate", "reset_lanes",
           "init_lane", "Cascade", "make", "available", "needs_tables",
           "register", "RecallIndexStrategy", "FixedNodeStrategy"]
