"""`CascadeRouter` — per-request routing state for the model ladder
(DESIGN.md §10).

The STRATEGY decides which nodes a token probes; the router turns those
decisions into residency: which models hold live context (lane + KV
pages) for each request slot, when a request ESCALATES onto a deeper
model (catch-up prefill required before the pending token can emit),
when a recall-style strategy's retreat DE-ESCALATES it back off, and —
under the ``commit`` policy — when the request abandons its source model
for good.

Everything here is plain host bookkeeping shared by the simulation and
real-engine cascade steppers, so the escalation state machine is
unit-testable with no device code at all.

Policies (``--escalate-policy``):

  * ``recall`` — rung 0 stays resident for the request's whole life;
    deeper rungs join at escalation and leave after ``patience``
    consecutive emitted tokens whose walks never probed them.  While a
    deeper rung is resident, serving an earlier rung's node (the
    strategy's argmin recall) costs nothing extra — and because a
    released rung's pages stay warm in its model's prefix cache, a
    later RE-escalation's catch-up prefill skips straight past the
    shared prefix: recall is a page-table re-pin plus a delta catch-up,
    never a full recompute.
  * ``commit`` — the no-recall discipline: the first escalation is
    final.  When the pending token resolves, the request commits to the
    deepest model it probed (walk floor pinned to that model's first
    node), and every shallower rung's residency is released.
"""

from __future__ import annotations

import dataclasses

from repro_torch.serving.cascade.bank import ModelBank

__all__ = ["CascadeRouter", "SlotTrack"]

POLICIES = ("recall", "commit")


@dataclasses.dataclass
class SlotTrack:
    """Routing state of one request slot."""

    resident: set                  # model ids with live lane + context
    floor: int = 0                 # first GLOBAL node the walk may probe
    emitted: int = 0               # tokens emitted so far
    # model -> positions of this stream present in the model's context
    # (holes included: positions advance even for unprobed tokens)
    synced: dict = dataclasses.field(default_factory=dict)
    # model -> positions REGISTERED in the model's shareable prefix
    # (the chain its catch-up committed; decode appendage is lane-
    # private and dies with the lane)
    registered: dict = dataclasses.field(default_factory=dict)
    # model -> positions still warm in the model's prefix cache after a
    # de-escalation released its lane (the re-pin credit)
    retained: dict = dataclasses.field(default_factory=dict)
    # model(>0) -> consecutive emitted tokens whose walk skipped it
    idle_streak: dict = dataclasses.field(default_factory=dict)
    # escalation in flight: {"targets": [m..], "handoff": stepper data}
    pending: dict | None = None


class CascadeRouter:
    """Residency + escalation policy over a `ModelBank` ladder."""

    def __init__(self, bank: ModelBank, n_slots: int, *,
                 policy: str = "recall", patience: int = 4):
        if policy not in POLICIES:
            raise ValueError(f"unknown escalate policy {policy!r}; "
                             f"choose from {POLICIES}")
        if patience < 1:
            raise ValueError("patience must be >= 1")
        self.bank = bank
        self.n_slots = int(n_slots)
        self.policy = policy
        self.patience = int(patience)
        self.slots: list[SlotTrack | None] = [None] * self.n_slots

    def set_patience(self, patience: int) -> None:
        """Gear knob (control plane): retune the de-escalation window
        mid-serve.  Takes effect from the NEXT emitted token — existing
        idle streaks keep their counts and are judged against the new
        window, so a swap can only move future de-escalations, never
        retroactively drop a resident rung."""
        if patience < 1:
            raise ValueError("patience must be >= 1")
        self.patience = int(patience)

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    def admit(self, slot: int, prompt_len: int) -> SlotTrack:
        if self.slots[slot] is not None:
            raise ValueError(f"slot {slot} already routed")
        tr = SlotTrack(resident={0}, synced={0: int(prompt_len)},
                       registered={0: int(prompt_len)})
        self.slots[slot] = tr
        return tr

    def release(self, slot: int) -> list[int]:
        """Request finished: returns the models whose lanes must be
        freed (every resident model)."""
        tr = self._track(slot)
        self.slots[slot] = None
        return sorted(tr.resident)

    def _track(self, slot: int) -> SlotTrack:
        tr = self.slots[slot]
        if tr is None:
            raise ValueError(f"slot {slot} is not routed")
        return tr

    # ------------------------------------------------------------------
    # queries the steppers drive the state machine with
    # ------------------------------------------------------------------

    def floor(self, slot: int) -> int:
        return self._track(slot).floor

    def resident(self, slot: int) -> list[int]:
        return sorted(self._track(slot).resident)

    def stream_pos(self, slot: int, prompt_len: int) -> int:
        """Context positions a fully synced model holds before the NEXT
        (pending) token decodes: the prompt plus one written position
        per emitted token."""
        return int(prompt_len) + self._track(slot).emitted

    def escalation_targets(self, slot: int, probed_models) -> list[int]:
        """Which of the walk's probed models need a NEW residency —
        the escalation the pending token blocks on."""
        tr = self._track(slot)
        return sorted(m for m in probed_models if m not in tr.resident)

    def catchup_need(self, slot: int, m: int, prompt_len: int) -> int:
        """Catch-up prefill tokens model ``m`` needs before the pending
        token can decode there: the stream's positions BEFORE the
        pending token, minus whatever the model retains from an earlier
        residency (released pages kept warm by its prefix cache — this
        is the quantity that makes re-escalation a delta, not a full
        recompute)."""
        tr = self._track(slot)
        need = self.stream_pos(slot, prompt_len)
        return max(0, need - tr.retained.get(m, 0))

    # ------------------------------------------------------------------
    # transitions
    # ------------------------------------------------------------------

    def begin_escalation(self, slot: int, targets, handoff) -> None:
        tr = self._track(slot)
        if tr.pending is not None:
            raise ValueError(f"slot {slot} already escalating")
        targets = sorted(targets)
        bad = [m for m in targets if m in tr.resident]
        if bad:
            raise ValueError(f"slot {slot}: models {bad} already resident")
        tr.pending = {"targets": targets, "handoff": handoff}

    def pending_handoff(self, slot: int):
        tr = self._track(slot)
        return None if tr.pending is None else tr.pending["handoff"]

    def finish_escalation(self, slot: int, prompt_len: int) -> list[int]:
        """Catch-up complete on every target: the targets become
        resident (synced through the pending token's position).  Under
        the ``commit`` policy this is also the commit point — the walk
        floor moves to the deepest target's first node and every
        shallower residency is released; returns the models to free."""
        tr = self._track(slot)
        if tr.pending is None:
            raise ValueError(f"slot {slot} has no escalation in flight")
        targets = tr.pending["targets"]
        pos = self.stream_pos(slot, prompt_len)
        for m in targets:
            tr.resident.add(m)
            tr.synced[m] = pos
            # the catch-up chain is what the rung's prefix cache keeps
            # shareable (engine: KVPool.commit_prefix) — decode appends
            # after this point are lane-private
            tr.registered[m] = pos
            tr.retained.pop(m, None)
            tr.idle_streak[m] = 0
        tr.pending = None
        if self.policy != "commit":
            return []
        deepest = max(targets)
        tr.floor = self.bank.offset(deepest)
        drop = sorted(m for m in tr.resident if m < deepest)
        for m in drop:
            self._release_model(tr, m)
        return drop

    def note_emit(self, slot: int, probed_models, served_node: int,
                  prompt_len: int) -> list[int]:
        """Account one emitted token; returns the models the recall
        policy DE-ESCALATES (idle past the patience window)."""
        tr = self._track(slot)
        tr.emitted += 1
        pos = self.stream_pos(slot, prompt_len)
        drop = []
        for m in sorted(tr.resident):
            tr.synced[m] = pos
            if m == 0 or self.policy == "commit":
                continue
            if m in probed_models:
                tr.idle_streak[m] = 0
            else:
                tr.idle_streak[m] = tr.idle_streak.get(m, 0) + 1
                if tr.idle_streak[m] >= self.patience:
                    drop.append(m)
        for m in drop:
            self._release_model(tr, m)
        return drop

    def _release_model(self, tr: SlotTrack, m: int) -> None:
        tr.resident.discard(m)
        # the model's prefix cache keeps the REGISTERED chain warm (not
        # the lane-private decode tail), so a re-escalation catches up
        # only the delta past it (engine: real LRU entries; sim: this
        # counter models the same credit)
        tr.retained[m] = tr.registered.get(m, 0)
        tr.idle_streak.pop(m, None)
        tr.synced.pop(m, None)
        tr.registered.pop(m, None)
