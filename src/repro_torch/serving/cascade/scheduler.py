"""`EscalationScheduler` — lanes and token budgets for the deeper rungs
(DESIGN.md §10).

Rung 0's lanes are the Server's request slots (admission capacity);
every deeper model's lanes are an ESCALATION pool this scheduler owns.
An escalating request asks for a lane on its target model; when none is
free it waits in a deterministic FIFO (trigger order, request id
tie-break) while its source-model lane idles silently — requests are
never dropped and never bounce.

The second resource is per-model TOKEN BUDGETS for catch-up prefill:
each rung's catch-up chunks are planned by a per-model `ChunkPlanner`
(the chunked-prefill fairness machinery, one planner per model), so a
burst of escalations is throttled to its budget per step instead of
flooding the device queue — the small model's decode lanes keep
decoding through an escalation storm.  In engine mode the per-model
`EngineStepper` owns the physical planner; this scheduler carries the
budget configuration and plans the virtual-clock catch-ups for the
simulation stepper.
"""

from __future__ import annotations

import collections

from repro_torch.serving.cascade.bank import ModelBank
from repro_torch.serving.runtime.scheduler import ChunkPlanner

__all__ = ["EscalationScheduler"]


class EscalationScheduler:
    """Deeper-rung lane pools + catch-up chunk budgets."""

    def __init__(self, bank: ModelBank, *, chunk: int = 16,
                 budgets=None):
        """``budgets``: per-model catch-up token budget per step (list
        aligned with the bank; entry 0 is the admission-prefill budget).
        Defaults to one ``chunk`` per model."""
        self.bank = bank
        self.chunk = int(chunk)
        if budgets is None:
            budgets = [self.chunk] * len(bank)
        budgets = [int(b) for b in budgets]
        if len(budgets) != len(bank):
            raise ValueError(f"{len(budgets)} budgets for {len(bank)} "
                             "models")
        self.budgets = budgets
        self.planners = [ChunkPlanner(self.chunk, b) for b in budgets]
        # gear-parameterized lane split: per-rung caps on concurrently
        # granted escalation lanes (<= the rung's physical lanes; shapes
        # never change, a cap only throttles grants)
        self.lane_caps = {m: bank[m].n_lanes for m in range(1, len(bank))}
        # deeper rungs: free-lane stacks (ascending pop for determinism)
        self._free = {m: list(range(bank[m].n_lanes - 1, -1, -1))
                      for m in range(1, len(bank))}
        # (slot, model) waiters in trigger order
        self._wait: collections.deque[tuple[int, int]] = \
            collections.deque()
        self._lane_of: dict[tuple[int, int], int] = {}
        self.peak_in_use = {m: 0 for m in range(1, len(bank))}

    # ------------------------------------------------------------------
    # gear knobs (control plane)
    # ------------------------------------------------------------------

    def set_budgets(self, budgets) -> None:
        """Swap the per-model catch-up token budgets between steps."""
        budgets = [int(b) for b in budgets]
        if len(budgets) != len(self.bank):
            raise ValueError(f"{len(budgets)} budgets for "
                             f"{len(self.bank)} models")
        self.budgets = budgets
        for planner, b in zip(self.planners, budgets):
            if b < 1:
                raise ValueError("budget must be >= 1")
            planner.budget = b

    def set_lane_caps(self, caps) -> None:
        """Swap the per-rung escalation lane caps (rungs 1..M-1).
        Already-granted lanes are never revoked — a tighter cap only
        throttles FUTURE grants, so in-flight escalations finish on the
        residency they were granted."""
        caps = [int(c) for c in caps]
        if len(caps) != len(self.bank) - 1:
            raise ValueError(f"{len(caps)} caps for {len(self.bank) - 1} "
                             "escalation rungs")
        for m, c in zip(range(1, len(self.bank)), caps):
            if not 1 <= c <= self.bank[m].n_lanes:
                raise ValueError(
                    f"rung {m} cap {c} outside [1, "
                    f"{self.bank[m].n_lanes}] physical lanes")
            self.lane_caps[m] = c

    def _can_grant(self, m: int) -> bool:
        return bool(self._free[m]) and \
            self.lanes_in_use(m) < self.lane_caps[m]

    # ------------------------------------------------------------------
    # lanes
    # ------------------------------------------------------------------

    def lanes_in_use(self, m: int) -> int:
        return self.bank[m].n_lanes - len(self._free[m])

    def lane_of(self, slot: int, m: int) -> int | None:
        return self._lane_of.get((slot, m))

    def slot_of(self, m: int, lane: int) -> int | None:
        """Reverse lookup: which slot holds rung ``m``'s ``lane``."""
        for (slot, mm), ln in self._lane_of.items():
            if mm == m and ln == lane:
                return slot
        return None

    def request(self, slot: int, m: int) -> int | None:
        """Ask for a lane on rung ``m``; None queues the slot (FIFO)."""
        if m < 1 or m >= len(self.bank):
            raise ValueError(f"rung {m} has no escalation pool")
        if (slot, m) in self._lane_of:
            raise ValueError(f"slot {slot} already holds a lane on "
                             f"model {m}")
        if self._can_grant(m) and not any(w[1] == m for w in self._wait):
            return self._grant(slot, m)
        self._wait.append((slot, m))
        return None

    def _grant(self, slot: int, m: int) -> int:
        lane = self._free[m].pop()
        self._lane_of[(slot, m)] = lane
        self.peak_in_use[m] = max(self.peak_in_use[m],
                                  self.lanes_in_use(m))
        return lane

    def grants(self, skip=()) -> list[tuple[int, int, int]]:
        """Serve waiters whose rung has a free lane now; returns
        ``(slot, model, lane)`` in FIFO order.  Waiters on a rung in
        ``skip`` (e.g. one frozen by a fault-plan stall window) stay
        queued in place — their FIFO position survives the window."""
        out = []
        still = collections.deque()
        while self._wait:
            slot, m = self._wait.popleft()
            if m not in skip and self._can_grant(m):
                out.append((slot, m, self._grant(slot, m)))
            else:
                still.append((slot, m))
        self._wait = still
        return out

    def release(self, slot: int, m: int) -> int:
        """Return the slot's rung-``m`` lane to the pool."""
        lane = self._lane_of.pop((slot, m))
        self._free[m].append(lane)
        self._free[m].sort(reverse=True)   # keep ascending-pop order
        return lane

    def cancel(self, slot: int) -> None:
        """Drop the slot's waiters (request finished or aborted)."""
        self._wait = collections.deque(
            w for w in self._wait if w[0] != slot)

    # ------------------------------------------------------------------
    # catch-up token budgets (virtual-clock planning; engine steppers
    # plan through their own per-model ChunkPlanner built from the same
    # budgets)
    # ------------------------------------------------------------------

    def plan_catchup(self, m: int, lanes: dict) -> dict:
        """Budgeted catch-up widths for rung ``m`` this step —
        ``lanes``: slot -> (remaining, total) like `ChunkPlanner.plan`."""
        if not lanes:
            return {}
        return self.planners[m].plan(lanes)
