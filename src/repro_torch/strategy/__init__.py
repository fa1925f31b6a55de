"""repro_torch.strategy — the pluggable decision layer shared by trace
evaluation and the serving engine.

    from repro_torch import strategy
    casc = strategy.Cascade.from_traces(losses, costs, k=32, lam=0.6)
    strat = strategy.make("recall_index", casc)
    result = strategy.evaluate(strat, losses)
"""

from repro_torch.strategy.base import (PolicyResult, State, Strategy,
                                       dynamic_arrays, evaluate, init_lane,
                                       reset_lanes, with_arrays)
from repro_torch.strategy.cascade import Cascade
from repro_torch.strategy.line import (FixedNodeStrategy, PatienceStrategy,
                                       RecallIndexStrategy,
                                       ThresholdStrategy, TreeIndexStrategy)
from repro_torch.strategy.oracle import OracleStrategy
from repro_torch.strategy.registry import (available, make, needs_tables,
                                           register, reserve_bank,
                                           slot_signature)
from repro_torch.strategy.skip import SkipRecallStrategy

__all__ = [
    "Strategy", "State", "PolicyResult", "evaluate", "reset_lanes",
    "init_lane", "dynamic_arrays", "with_arrays",
    "Cascade",
    "make", "available", "needs_tables", "register",
    "reserve_bank", "slot_signature",
    "RecallIndexStrategy", "TreeIndexStrategy", "ThresholdStrategy",
    "PatienceStrategy", "FixedNodeStrategy", "OracleStrategy",
    "SkipRecallStrategy",
]
