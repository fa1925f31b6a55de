"""Load-indexed gear plans.

A **gear** is one complete serving configuration: a T-Tamer strategy
(the provably-optimal stop/skip policy for its lambda) plus the host
knobs that accompany it — cascade escalate policy patience, chunked-
prefill budget, escalation lane split.  `GearPlanner` precomputes a
BANK of gears offline from calibration traces, prices each one with
the same cost model the simulation charges, and indexes them by the
arrival rate they can sustain:

    work      = expected node-equivalents per token (probes for walk
                strategies; objective explore cost / per-node cost for
                jump strategies, so a skipped-but-still-computed
                backbone under cumulative edge costs is priced in)
    tok/s     = n_lanes / (overhead + seg_time * work)
    max_rate  = utilization * tok/s / mean_tokens     [requests/sec]

`GearBank` orders gears QUALITY-FIRST (most work, lowest loss, first)
so ``slot_for_rate`` degrades monotonically: serve the best gear whose
capacity covers the observed load, falling back to the cheapest gear
when even it is saturated.  The bank's order fixes the strategy-bank
slot layout the stepper traces over — slots never move after that; the
control plane only changes which slot new admissions use and what
tables live inside a slot.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.strategy.base import evaluate
from repro_torch.strategy.cascade import Cascade
from repro_torch.strategy.registry import make as make_strategy

__all__ = ["GearSpec", "Gear", "GearBank", "GearPlanner"]


@dataclasses.dataclass(frozen=True)
class GearSpec:
    """Declarative gear: the lambda point + host knobs."""

    name: str
    lam: float
    strategy: str = "skip_recall"
    kwargs: dict = dataclasses.field(default_factory=dict)
    patience: int | None = None          # cascade de-escalation window
    prefill_budget: int | None = None    # chunked-prefill tokens/step
    esc_budgets: tuple | None = None     # per-model catch-up budgets
    lane_split: tuple | None = None      # per-rung escalation lane caps

    def __post_init__(self):
        if not 0.0 < self.lam <= 1.0:
            raise ValueError(f"gear {self.name!r}: lam must be in (0, 1], "
                             f"got {self.lam}")


@dataclasses.dataclass
class Gear:
    """A solved gear: spec + strategy + its priced capacity."""

    spec: GearSpec
    cascade: Cascade
    strategy: object
    work: float          # expected node-equivalents per token
    est_loss: float      # holdout mean served loss, RAW units
    max_rate: float      # sustainable requests/sec
    slot: int = -1       # strategy-bank slot (assigned by GearBank)

    @property
    def name(self) -> str:
        return self.spec.name

    @property
    def prefill_budget(self):
        return self.spec.prefill_budget

    @property
    def patience(self):
        return self.spec.patience

    @property
    def esc_budgets(self):
        return self.spec.esc_budgets

    @property
    def lane_split(self):
        return self.spec.lane_split

    def describe(self) -> dict:
        return {"name": self.name, "slot": self.slot,
                "lam": self.spec.lam, "strategy": self.spec.strategy,
                "work": self.work, "est_loss": self.est_loss,
                "max_rate": self.max_rate}


class GearBank:
    """Quality-first ordered gears; order == strategy-bank slot layout."""

    def __init__(self, gears):
        gears = list(gears)
        if not gears:
            raise ValueError("a gear bank needs at least one gear")
        names = [g.name for g in gears]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate gear names: {names}")
        # most work first = best quality first; loss breaks ties
        gears.sort(key=lambda g: (-g.work, g.est_loss))
        for slot, g in enumerate(gears):
            g.slot = slot
        self.gears = gears

    def __len__(self) -> int:
        return len(self.gears)

    def __iter__(self):
        return iter(self.gears)

    def __getitem__(self, slot: int) -> Gear:
        return self.gears[slot]

    def by_name(self, name: str) -> Gear:
        for g in self.gears:
            if g.name == name:
                return g
        raise KeyError(f"no gear named {name!r}; have "
                       f"{[g.name for g in self.gears]}")

    @property
    def strategies(self) -> tuple:
        """Slot-ordered strategy tuple — what the stepper traces over."""
        return tuple(g.strategy for g in self.gears)

    @property
    def rate_thresholds(self) -> list[float]:
        """Ascending capacity edges for telemetry's ``load_level``."""
        return sorted(g.max_rate for g in self.gears)

    def slot_for_rate(self, rate: float) -> int:
        """Best (highest-quality) gear whose capacity covers ``rate``;
        the cheapest gear when nothing does (graceful saturation)."""
        for g in self.gears:
            if g.max_rate >= rate:
                return g.slot
        return self.gears[-1].slot

    def describe(self) -> list[dict]:
        return [g.describe() for g in self.gears]


class GearPlanner:
    """Offline gear solver against calibration traces.

    ``losses``: (T, n) RAW per-node calibration losses; a trailing
    ``holdout`` fraction is held out of table fitting and used to price
    each gear's work/loss — the same split keeps capacity estimates
    honest about generalization.  ``node_costs``: (n,) per-node compute
    in FLOP-fraction units (each gear's objective costs are
    ``(1 - lam) * node_costs``, matching the offline sweeps).
    ``device`` is where the gears' cascades and strategies live (the
    JAX package has no such argument: its arrays live where JAX puts
    them).
    """

    def __init__(self, losses, node_costs, *, k: int = 16,
                 seg_time: float, overhead: float, n_lanes: int,
                 mean_tokens: float, utilization: float = 0.85,
                 holdout: float = 0.25, boundaries=None,
                 entry_costs=None, device="cpu"):
        losses = np.asarray(losses, np.float64)
        if losses.ndim != 2:
            raise ValueError(f"losses must be (T, n), got {losses.shape}")
        n_hold = max(1, int(round(losses.shape[0] * float(holdout))))
        if n_hold >= losses.shape[0]:
            raise ValueError("holdout fraction leaves no fitting rows")
        self.fit_losses = losses[:-n_hold]
        self.holdout_losses = losses[-n_hold:]
        self.node_costs = np.asarray(node_costs, np.float64)
        if self.node_costs.shape != (losses.shape[1],):
            raise ValueError(f"node_costs shape {self.node_costs.shape} "
                             f"vs {losses.shape[1]} trace columns")
        self.k = int(k)
        self.seg_time = float(seg_time)
        self.overhead = float(overhead)
        self.n_lanes = int(n_lanes)
        self.mean_tokens = float(mean_tokens)
        self.utilization = float(utilization)
        self.boundaries = boundaries
        self.entry_costs = entry_costs
        self.device = device

    def solve(self, spec: GearSpec) -> Gear:
        """Calibrate + solve one gear and price it on the holdout."""
        cascade = Cascade.from_traces(
            self.fit_losses, (1.0 - spec.lam) * self.node_costs,
            k=self.k, lam=spec.lam, solve=False,
            boundaries=self.boundaries, entry_costs=self.entry_costs,
            device=self.device)
        strategy = make_strategy(spec.strategy, cascade, **spec.kwargs)
        work, est_loss = self.price(strategy, cascade)
        return Gear(spec=spec, cascade=cascade, strategy=strategy,
                    work=work, est_loss=est_loss,
                    max_rate=self.rate_for_work(work))

    def price(self, strategy, cascade: Cascade,
              losses=None) -> tuple[float, float]:
        """(work, raw mean served loss) of a strategy on held-out rows.

        ``work`` is the mean number of PROBED nodes per token — exactly
        what the runtime `SimStepper` charges a lane per step (its
        ``policy`` counter sums active lanes per node), so
        ``rate_for_work`` prices capacity in the units the serve clock
        pays.  Jump strategies' objective explore cost (which also
        bills the skipped-but-computed backbone under cumulative edge
        costs) is deliberately NOT used: the replay sim only executes
        observed nodes, and a capacity estimate must match the executor
        it gates.
        """
        rows = self.holdout_losses if losses is None else np.asarray(losses)
        res = evaluate(strategy, rows.astype(np.float32))
        work = float(np.mean(res.n_probed.cpu().numpy()))
        est_loss = float(np.mean(res.served_loss.cpu().numpy())) \
            / strategy.lam
        return work, est_loss

    def rate_for_work(self, work: float) -> float:
        """Sustainable requests/sec at a given per-token work level."""
        tok_s = self.n_lanes / (self.overhead + self.seg_time * work)
        return self.utilization * tok_s / self.mean_tokens

    def plan(self, specs) -> GearBank:
        """Solve every spec into a quality-first `GearBank`."""
        return GearBank([self.solve(s) for s in specs])
