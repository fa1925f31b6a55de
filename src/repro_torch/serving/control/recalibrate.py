"""`Recalibrator` — online re-fit of the cascade tables.

The offline tables are only as good as the calibration distribution;
when the served traffic drifts (harder prompts, different overthinking
mix), a frozen gear keeps probing where the VALUE function says losses
used to improve, and its real capacity quietly collapses.  This object
closes that gap without ever touching the hot path:

  * the stepper's ``row_tap`` streams observed (per-node raw losses,
    served node) outcomes into a bounded row window + per-node serve
    histogram — O(1) per token, host-side;
  * every ``interval`` of serve time (and once at least ``min_rows``
    rows have accumulated), `recalibrate` re-fits EVERY gear's
    `Cascade` from the observed rows (`Cascade.refit` — same lambda,
    same support size, so tables come back shape-identical), rebuilds
    each gear's strategy through the registry, and publishes it into
    its reserved `BankSwap` slot;
  * with a `GearPlanner` attached, each gear's work/capacity estimate
    is re-priced on the observed rows too, so ``slot_for_rate`` tracks
    what the gears can REALLY sustain now, not what the stale
    calibration promised.

The re-solve runs on the host between steps (a few line/skip DPs over a
(k, n) grid — microseconds next to a token step); the publish is the
`BankSwap` in-place copy into the slot's reserved tensors, guarded by
the slot signature.
"""

from __future__ import annotations

import collections

import numpy as np

from repro_torch.serving.control.gears import GearBank, GearPlanner
from repro_torch.serving.control.swap import BankSwap
from repro_torch.strategy.registry import make as make_strategy

__all__ = ["Recalibrator"]


class Recalibrator:
    """Streaming outcome window + periodic re-fit/publish."""

    def __init__(self, bank: GearBank, swap: BankSwap, *,
                 interval: float, min_rows: int = 256,
                 max_rows: int = 4096, planner: GearPlanner | None = None):
        if not interval > 0:
            raise ValueError(f"interval must be > 0, got {interval}")
        if min_rows < 2:
            raise ValueError("min_rows must be >= 2 (chain fitting "
                             "needs consecutive rows)")
        self.bank = bank
        self.swap = swap
        self.interval = float(interval)
        self.min_rows = int(min_rows)
        self.planner = planner
        self._rows: collections.deque = collections.deque(
            maxlen=int(max_rows))
        n = bank[0].cascade.n_nodes
        self.node_counts = np.zeros(n, np.int64)   # served-node histogram
        self.last = 0.0
        self.recals = 0
        self.events: list[dict] = []

    # ---- streaming feed (flushed from row_tap at step boundaries) ----

    def observe(self, rows, served=None) -> None:
        """Fold a batch of observed outcomes: ``rows`` (B, n) RAW
        per-node losses, ``served`` (B,) served node indices."""
        rows = np.asarray(rows, np.float64)
        for row in rows:
            self._rows.append(row)
        if served is not None:
            np.add.at(self.node_counts, np.asarray(served, np.int64), 1)

    @property
    def n_rows(self) -> int:
        return len(self._rows)

    # ---- the periodic re-solve ---------------------------------------

    def due(self, now: float) -> bool:
        return (float(now) - self.last >= self.interval
                and self.n_rows >= self.min_rows)

    def recalibrate(self, now: float) -> int:
        """Re-fit every gear from the observed row window and publish
        the rebuilt strategies into their reserved slots.  Returns the
        number of slots published; records an event either way."""
        rows = np.stack(tuple(self._rows))
        published = 0
        for gear in self.bank:
            casc = gear.cascade.refit(rows)
            strategy = make_strategy(gear.spec.strategy, casc,
                                     **gear.spec.kwargs)
            self.swap.publish(gear.slot, strategy, now)
            gear.cascade = casc
            gear.strategy = strategy
            if self.planner is not None:
                gear.work, gear.est_loss = self.planner.price(
                    strategy, casc, losses=rows)
                gear.max_rate = self.planner.rate_for_work(gear.work)
            published += 1
        self.last = float(now)
        self.recals += 1
        self.events.append({
            "t": float(now), "rows": int(rows.shape[0]),
            "published": published,
            "gears": self.bank.describe(),
        })
        return published
