"""`DegradeGovernor` — demote under pressure instead of failing.

The governor sits at the single point where a cascade decides to
escalate and answers one question: *can the deep rung still pay off?*
Escalating costs catch-up prefill (the deep rung must replay the
stream it skipped) and, if the target rung is inside a fault-plan
stall window, an unbounded wait.  When the remaining deadline budget
cannot cover that cost, escalating converts a servable request into a
deadline miss — so the governor denies the escalation and the router
serves the best already-probed shallow answer instead.  Recall is what
makes this demotion cheap and *legal*: the shallow rung's observed
node is a genuine T-Tamer walk answer, just an earlier stop on the
node line.

The governor holds no serve state and draws no randomness — a denial
is a pure function of (now, deadline, catch-up cost, stall flag), so a
governed serve replays bit-identically.
"""

from __future__ import annotations

from typing import Any

__all__ = ["DegradeGovernor"]


class DegradeGovernor:
    """Deadline-aware escalation gate.

    ``safety`` scales the catch-up cost estimate before comparing it
    against the remaining budget: > 1 denies earlier (conservative),
    < 1 gambles on the estimate being pessimistic.
    """

    def __init__(self, *, safety: float = 1.0):
        self.safety = float(safety)
        self.allowed = 0
        self.denied = 0
        self.denied_deadline = 0
        self.denied_stall = 0

    def allow_escalation(self, *, now: float,
                         deadline: float | None,
                         catchup_cost: float,
                         stalled: bool = False) -> bool:
        """True if the escalation may proceed.

        Denies when the target rung is stalled (escalating into a
        frozen rung parks the request for the whole window), or when a
        deadline leaves less budget than the scaled catch-up cost.
        """
        if stalled:
            self.denied += 1
            self.denied_stall += 1
            return False
        if (deadline is not None
                and deadline - now < self.safety * catchup_cost):
            self.denied += 1
            self.denied_deadline += 1
            return False
        self.allowed += 1
        return True

    def stats(self) -> dict[str, Any]:
        return {
            "governor_allowed": self.allowed,
            "governor_denied": self.denied,
            "governor_denied_deadline": self.denied_deadline,
            "governor_denied_stall": self.denied_stall,
        }
