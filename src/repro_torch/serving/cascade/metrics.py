"""Cross-model cascade metrics (DESIGN.md §10).

`RuntimeMetrics` keeps its single-model view (the cascade's combined
node line is its ``full_depth``); this module adds the MODEL dimension:
per-model tokens served / node probes / catch-up tokens, escalation and
recall event counts, and the served-loss accumulator the
cascade-vs-monolith Pareto sweeps report (simulation mode knows the
served node's trace loss exactly).

Attribution: tokens and segment probes are attributed to the
model that actually SERVED / RAN them — an escalated token that recalls
a small-model node counts as small-model service even though the large
model was consulted — and TTFT comes from the actual emission step
(escalating lanes are occupied but silent, exactly like chunked-prefill
lanes).
"""

from __future__ import annotations

__all__ = ["CascadeStats"]


class CascadeStats:
    """Per-model counters + escalation events for one serve run."""

    def __init__(self, n_models: int):
        self.n_models = int(n_models)
        self.tokens_served = [0] * self.n_models   # by SERVING model
        self.probes = [0] * self.n_models          # node probes run
        self.catchup_tokens = [0] * self.n_models  # escalation prefill
        self.sync_writes = [0] * self.n_models     # resident, unprobed
        self.escalations = 0      # residency added to a deeper model
        self.deescalations = 0    # recall-policy release of a rung
        self.commits = 0          # commit-policy point of no return
        self.recalls = 0          # token served by a shallower model
                                  # than the deepest it probed
        self.repin_tokens = 0     # catch-up tokens SKIPPED via retained
                                  # context (the re-pin, not recompute)
        self.served_loss_sum = 0.0
        self.served_loss_n = 0

    def on_served(self, model: int, deepest_probed: int,
                  loss: float | None = None) -> None:
        self.tokens_served[model] += 1
        if deepest_probed > model:
            self.recalls += 1
        if loss is not None:
            self.served_loss_sum += float(loss)
            self.served_loss_n += 1

    @property
    def mean_served_loss(self) -> float | None:
        if not self.served_loss_n:
            return None
        return self.served_loss_sum / self.served_loss_n

    def as_dict(self) -> dict:
        return {
            "n_models": self.n_models,
            "tokens_served": list(self.tokens_served),
            "probes": list(self.probes),
            "catchup_tokens": list(self.catchup_tokens),
            "sync_writes": list(self.sync_writes),
            "escalations": self.escalations,
            "deescalations": self.deescalations,
            "commits": self.commits,
            "recalls": self.recalls,
            "repin_tokens": self.repin_tokens,
            "mean_served_loss": self.mean_served_loss,
        }
