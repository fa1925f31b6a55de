"""`CascadeSimStepper` — virtual-clock multi-model cascade serving
(DESIGN.md §10).

The decision layer is EXACT: each emitted token's node walk over the
combined ladder line is the same ``bank_observe``/``bank_serve`` fold
`strategy.evaluate` runs offline on that token's trace row, so
per-request decisions are independent of lane placement, escalation
timing and arrival order by construction.  What the simulation ADDS is
the runtime: which models are resident, what escalation catch-up costs,
which steps a token can actually emit in, and what the virtual clock
charges (`ModelSpec.seg_time` / ``prefill_tok_time`` per model).  The
walk runs on the stepper's device; everything else is host bookkeeping.

Cost model per step (one device, serial across models, piggyback
roofline per model exactly like the single-model sim):

    cost = overhead + sum_m max(seg_time_m * probes_m / lanes_m,
                                prefill_tok_time_m * catchup_m)

Probes are charged on the step they physically run: an escalating
token's source-model probes at walk time, its target-model probes when
the catch-up finishes and the pending token resolves.  Tokens and
served losses are attributed to the model that SERVED them
(`metrics.CascadeStats`), and an escalating slot is occupied-but-silent
until its pending token emits, so TTFT reflects real emission time.

Under a `FaultPlan` (``faults``) a rung frozen by a stall window does no
work; a `DegradeGovernor` (``governor``) may deny an escalation, and the
slot then serves the best node it observed on a resident rung.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.serving.cascade.bank import ModelBank
from repro_torch.serving.cascade.metrics import CascadeStats
from repro_torch.serving.cascade.router import CascadeRouter
from repro_torch.serving.cascade.scheduler import EscalationScheduler
from repro_torch.serving.engine import bank_observe, bank_serve
from repro_torch.serving.runtime.request import Request
from repro_torch.serving.runtime.server import arrays_to
from repro_torch.strategy.base import (array_leaves, dynamic_arrays,
                                       with_arrays)

__all__ = ["CascadeSimStepper", "make_cascade_decide"]

_ROW_PRIME = 9973   # same (rid, token) -> row mapping as SimStepper


def _check_strategies(strategies, n_total: int, policy: str):
    for s in strategies:
        if s.n_nodes != n_total:
            raise ValueError(
                f"strategy expects {s.n_nodes} nodes, the cascade ladder "
                f"has {n_total}")
        if getattr(s, "needs_aux", False):
            raise ValueError(
                f"{type(s).__name__} consumes the aux prediction channel; "
                "simulation replays losses only")
        if policy == "commit" and getattr(s, "jumps", False):
            raise ValueError(
                f"{type(s).__name__} walks a NEXT table from the root; "
                "the commit policy pins walks to a floor mid-line, which "
                "the table was not solved for — use --escalate-policy "
                "recall (or a threshold/index strategy)")


def make_cascade_decide(bank: ModelBank, strategies: tuple):
    """Build the combined-ladder walk.

    ``decide(arrays, losses (B, n_total), occupied (B,), sid (B,),
    floor (B,))`` (tensors on one device) returns ``(served (B,),
    probes (M, B) i32, depth (M,) i32, deepest (B,) i32)``: the served
    global node, per-model per-lane node-probe counts, per-model
    launched-node counts, and each lane's deepest PROBED node (-1 when
    nothing was observed).  ``arrays`` carries each bank slot's dynamic
    decision arrays.  ``floor`` gates the walk — nodes below a lane's
    floor are neither observed nor charged, but the lane stays eligible
    to start at the floor (the commit policy's pinned walk); floor 0
    reproduces `strategy.evaluate` exactly.
    """
    n_models = len(bank)

    def probed_of(states, sid):
        out = states[0].n_probed
        for k in range(1, len(strategies)):
            out = torch.where(sid == k, states[k].n_probed, out)
        return out

    def decide(arrays, losses, occupied, sid, floor):
        live = tuple(with_arrays(s, a)
                     for s, a in zip(strategies, arrays))
        b = losses.shape[0]
        dev = losses.device
        states = tuple(s.init(b) for s in live)
        active = occupied
        np_before = torch.zeros((b,), dtype=torch.int32, device=dev)
        # per-lane deepest probed node, folded from per-node n_probed
        # deltas — costs no extra strategy calls
        deepest = torch.full((b,), -1, dtype=torch.int32, device=dev)
        np_lane = torch.zeros((b,), dtype=torch.int32, device=dev)
        probes, depth = [], []
        node = 0
        for m in range(n_models):
            d = torch.zeros((), dtype=torch.int32, device=dev)
            for _ in range(bank[m].n_nodes):
                above = node >= floor
                obs = active & above
                d = d + obs.any().to(torch.int32)
                states, cont = bank_observe(live, states, node,
                                            losses[:, node], None, obs,
                                            sid)
                np_lane_now = probed_of(states, sid)
                deepest = torch.where(np_lane_now > np_lane, node, deepest)
                np_lane = np_lane_now
                # below its floor a lane passes through un-observed
                active = torch.where(above, cont, active)
                node += 1
            np_now = probed_of(states, sid)
            probes.append(np_now - np_before)
            np_before = np_now
            depth.append(d)
        served = bank_serve(live, states, sid)
        return served, torch.stack(probes), torch.stack(depth), deepest

    return decide


class CascadeSimStepper:
    """Model-free multi-model stepper behind the standard Server loop."""

    virtual_time = True
    emits_tokens = False
    # the server installs a `SpanTracer` here when one is attached; the
    # per-lane attribution of the last step — served-node loss (NaN =
    # silent), emitted through an escalation, deepest PROBED node — is
    # kept only under a tracer, for its token events
    tracer = None
    last_loss = None
    last_escalated = None
    last_deepest = None
    fault_now = 0.0         # the server's clock, stamped under faults

    def __init__(self, bank: ModelBank, strategies: tuple, trace_bank, *,
                 overhead: float = 0.25, policy: str = "recall",
                 patience: int = 4, chunk: int = 16, budgets=None,
                 pool=None, faults=None, governor=None, device="cuda"):
        self.device = torch.device(device)
        # optional rung-0 paged-KV admission gate: the host-side
        # `KVPool` bookkeeping the single-model sim can carry
        self.pool = pool
        # fault plane: scripted chaos windows + the degrade governor
        # that turns deadline pressure into demotion
        self.faults = faults
        self.governor = governor
        self.bank = bank
        self.strategies = strategies
        self.traces = np.asarray(trace_bank, np.float32)
        if self.traces.shape[1] != bank.n_total:
            raise ValueError(f"trace bank has {self.traces.shape[1]} "
                             f"node columns, ladder has {bank.n_total}")
        _check_strategies(strategies, bank.n_total, policy)
        self.n_lanes = bank[0].n_lanes        # Server request slots
        self.full_depth = bank.n_total
        self.overhead = float(overhead)
        self.policy = policy
        self.patience = int(patience)
        self.chunk = int(chunk)
        self.budgets = budgets
        self._bank_arrays = tuple(arrays_to(dynamic_arrays(s), self.device)
                                  for s in strategies)
        self.bank_source = None    # control-plane hot-swap override
        self.row_tap = None        # observed-outcome tap
        self._decide = make_cascade_decide(bank, strategies)
        # the data_ptrs of every set of bank storages a serving step
        # decided with (one set while publishes copy in place)
        self.storages: set = set()
        self.alloc()

    def bank_arrays(self) -> tuple:
        if self.bank_source is not None:
            return self.bank_source.bank_arrays()
        return self._bank_arrays

    def decide_cache_size(self) -> int:
        """The number of distinct sets of bank storages the serving steps
        have handed the walk (the JAX package counts jit cache entries
        here); 1 across `BankSwap` swaps and publishes."""
        return len(self.storages)

    def apply_gear(self, gear) -> None:
        """Host-side gear knobs: escalate patience, per-model catch-up
        budgets, per-rung lane caps.  All step-boundary swaps — granted
        residencies and in-flight escalations are never revoked."""
        spec = getattr(gear, "spec", gear)
        patience = getattr(spec, "patience", None)
        if patience is not None:
            self.router.set_patience(patience)
            self.patience = int(patience)
        budgets = getattr(spec, "esc_budgets", None)
        if budgets is not None:
            self.esc.set_budgets(budgets)
            self.budgets = list(budgets)
        lane_split = getattr(spec, "lane_split", None)
        if lane_split is not None:
            self.esc.set_lane_caps(lane_split)

    # ------------------------------------------------------------------

    def alloc(self) -> None:
        n = self.n_lanes
        self.lane_req: list[Request | None] = [None] * n
        self.lane_tidx = np.zeros(n, np.int64)
        self.prefill0 = np.zeros(n, np.int64)
        self.router = CascadeRouter(self.bank, n, policy=self.policy,
                                    patience=self.patience)
        self.esc = EscalationScheduler(self.bank, chunk=self.chunk,
                                       budgets=self.budgets)
        # slot -> {model: catch-up tokens remaining} (granted lanes only)
        self.catchup: dict[int, dict[int, int]] = {}
        # slot -> {model: the catch-up's full length} (planner buckets)
        self.catchup_total: dict[int, dict[int, int]] = {}
        self.stats = CascadeStats(len(self.bank))
        self._stall_seen: set = set()   # (model, window-start) emitted
        if self.pool is not None:
            self.pool.reset()

    def warmup(self) -> None:
        n, dev = self.n_lanes, self.device
        self._decide(self.bank_arrays(),
                     torch.zeros((n, self.bank.n_total), device=dev),
                     torch.zeros((n,), dtype=torch.bool, device=dev),
                     torch.zeros((n,), dtype=torch.int32, device=dev),
                     torch.zeros((n,), dtype=torch.int32, device=dev))
        self.alloc()

    def reserve(self, req: Request) -> bool:
        if self.pool is None:
            return True
        return self.pool.reserve(req.prompt, req.max_tokens)

    def admit(self, slot: int, req: Request) -> None:
        self.lane_req[slot] = req
        self.lane_tidx[slot] = 0
        lp = len(req.prompt)
        if self.pool is not None:
            self.pool.admit(slot, req.prompt, req.max_tokens)
        self.prefill0[slot] = lp
        self.router.admit(slot, lp)

    def release(self, slot: int) -> None:
        if self.pool is not None:
            self.pool.release(slot)
        self.router.release(slot)
        # free EVERY granted deep lane, resident or not: a reaped slot
        # may hold lanes granted to escalation targets that never
        # became resident (catch-up unfinished)
        for m in range(1, len(self.bank)):
            if self.esc.lane_of(slot, m) is not None:
                self.esc.release(slot, m)
        self.esc.cancel(slot)
        self.catchup.pop(slot, None)
        self.catchup_total.pop(slot, None)
        self.lane_req[slot] = None
        self.prefill0[slot] = 0

    # ------------------------------------------------------------------

    def _row(self, req: Request, tidx: int) -> np.ndarray:
        return self.traces[(req.rid * _ROW_PRIME + tidx)
                           % len(self.traces)]

    def _start_catchup(self, slot: int, m: int) -> None:
        lp = len(self.lane_req[slot].prompt)
        need = self.router.catchup_need(slot, m, lp)
        credit = self.router.stream_pos(slot, lp) - need
        if credit > 0:
            # retained context made the re-escalation a re-pin: these
            # tokens are NOT recomputed
            self.stats.repin_tokens += credit
        self.catchup.setdefault(slot, {})[m] = need
        # the planner buckets by the catch-up's FULL length (what the
        # engine's per-rung ChunkPlanner sees), not the moving remainder
        self.catchup_total.setdefault(slot, {})[m] = max(need, 1)

    def _escalation_ready(self, slot: int) -> bool:
        tr = self.router.slots[slot]
        if tr is None or tr.pending is None:
            return False
        cu = self.catchup.get(slot, {})
        return all(m in cu and cu[m] == 0 for m in tr.pending["targets"])

    def _demoted_node(self, slot: int, probed, resident, probes,
                      losses, floor: int) -> int:
        """Denied escalation: the best (lowest-loss) node the walk
        actually observed on a RESIDENT rung this token.  The walk
        stops early on the node line instead of crossing to the target
        model — a legal T-Tamer stop, paid for with recall."""
        cand = []
        for m in probed:
            if m not in resident:
                continue
            start = max(self.bank.offset(m), floor)
            cand.extend(range(start, start + int(probes[m, slot])))
        if not cand:
            # degenerate (no observed resident probes): the floor node
            return int(floor)
        return min(cand, key=lambda n: float(losses[slot, n]))

    def _note_stall(self, model: int) -> None:
        """Emit one `rung_stall` span per scripted window edge."""
        win = self.faults.stall_window(model, self.fault_now)
        if win is None or (model, win[0]) in self._stall_seen:
            return
        self._stall_seen.add((model, win[0]))
        if self.tracer is not None:
            self.tracer.emit("rung_stall", model=model,
                             t0=round(win[0], 9), until=round(win[1], 9))

    def _stalled_models(self) -> set:
        if self.faults is None:
            return set()
        out = set()
        for m in range(len(self.bank)):
            if self.faults.stall_active(m, self.fault_now):
                out.add(m)
                self._note_stall(m)
        return out

    def step(self, occupied: np.ndarray, sid: np.ndarray):
        """Returns ``(emitted, served, seg_batch, seg_policy, cost,
        emit_mask)`` — the SimStepper contract; ``emitted`` carries the
        served global node (sim tokens have no content)."""
        occupied = np.asarray(occupied, bool)
        emit = occupied.copy()
        served_out = np.zeros(self.n_lanes, np.int32)
        m_count = len(self.bank)
        probes_paid = np.zeros(m_count, np.int64)
        chunk_cost = np.zeros(m_count, np.float64)
        seg_batch = 0
        otr = self.tracer
        if otr is not None:
            self.last_loss = np.full(self.n_lanes, np.nan)
            self.last_escalated = np.zeros(self.n_lanes, bool)
            self.last_deepest = np.full(self.n_lanes, -1)
        # fault plane: rungs frozen by a scripted stall window do no
        # work this step — no grants, no prefill, no catch-up, no
        # decode on their lanes.  The clock still advances (cost >=
        # overhead), so a finite window always passes.
        stalled = self._stalled_models()

        # 0. lanes freed since last step go to FIFO waiters (waiters on
        #    a stalled rung hold their FIFO position)
        for slot, m, _lane in self.esc.grants(skip=stalled):
            self._start_catchup(slot, m)
            if otr is not None:
                otr.emit("esc_grant", rid=self.lane_req[slot].rid,
                         lane=slot, model=m)

        # 1. initial model-0 admission prefill (chunked, budgeted)
        prefilling = occupied & (self.prefill0 > 0)
        emit &= ~prefilling
        if prefilling.any() and 0 not in stalled:
            widths = self.esc.plan_catchup(0, {
                int(s): (int(self.prefill0[s]),
                         len(self.lane_req[s].prompt))
                for s in np.flatnonzero(prefilling)})
            for slot, w in widths.items():
                self.prefill0[slot] -= w
                chunk_cost[0] += w * self.bank[0].prefill_tok_time
                if otr is not None:
                    otr.emit("prefill_chunk",
                             rid=self.lane_req[slot].rid, lane=slot,
                             model=0, width=int(w),
                             left=int(self.prefill0[slot]))

        # 2. escalation catch-up chunks, per target model, budgeted
        for m in range(1, m_count):
            if m in stalled:
                continue
            lanes = {slot: (cu[m], self.catchup_total[slot][m])
                     for slot, cu in self.catchup.items()
                     if occupied[slot] and cu.get(m, 0) > 0}
            for slot, w in self.esc.plan_catchup(m, lanes).items():
                self.catchup[slot][m] -= w
                chunk_cost[m] += w * self.bank[m].prefill_tok_time
                self.stats.catchup_tokens[m] += w
                if otr is not None:
                    otr.emit("prefill_chunk",
                             rid=self.lane_req[slot].rid, lane=slot,
                             model=m, width=int(w),
                             left=int(self.catchup[slot][m]))

        # 3. escalations whose every target is granted + caught up:
        #    the pending token resolves and emits NOW, paying the
        #    target-model probes stashed in its handoff
        resolved = set()
        for slot in range(self.n_lanes):
            pend = (occupied[slot]
                    and self.router.slots[slot] is not None
                    and self.router.slots[slot].pending is not None)
            # a ready escalation whose target rung is stalled cannot
            # resolve this step — it stays silent until the window ends
            target_stalled = pend and stalled and any(
                m in stalled
                for m in self.router.slots[slot].pending["targets"])
            if (not occupied[slot] or not self._escalation_ready(slot)
                    or target_stalled):
                if pend:
                    emit[slot] = False      # escalating: silent
                continue
            tr = self.router.slots[slot]
            handoff = tr.pending["handoff"]
            targets = list(tr.pending["targets"])
            lp = len(self.lane_req[slot].prompt)
            for m in self.router.finish_escalation(slot, lp):
                if m >= 1:
                    self.esc.release(slot, m)
            if self.policy == "commit":
                self.stats.commits += 1
            for m in targets:
                # the walk already counted these nodes in seg_batch at
                # trigger time; only the probe COST lands here
                probes_paid[m] += int(handoff["probes"][m])
            served = int(handoff["served"])
            served_out[slot] = served
            emit[slot] = True
            resolved.add(slot)
            sm = self.bank.model_of(served)
            deepest = max(handoff["probed_models"])
            self.stats.on_served(sm, deepest, loss=handoff["loss"])
            if otr is not None:
                rid = self.lane_req[slot].rid
                for m in targets:
                    otr.emit("esc_resolve", rid=rid, lane=slot, model=m)
                if deepest > sm:
                    otr.emit("recall", rid=rid, lane=slot, model=sm,
                             node=served, deepest=deepest)
                self.last_loss[slot] = handoff["loss"]
                self.last_escalated[slot] = True
                self.last_deepest[slot] = int(handoff["deepest_node"])
            for m in self.router.note_emit(slot,
                                           handoff["probed_models"],
                                           served, lp):
                self.esc.release(slot, m)
                self.stats.deescalations += 1
                if otr is not None:
                    otr.emit("deescalate", rid=self.lane_req[slot].rid,
                             lane=slot, model=m)
            for m in targets:
                self.catchup.get(slot, {}).pop(m, None)
                self.catchup_total.get(slot, {}).pop(m, None)

        # 4. the walk for every normally decoding slot (one batched fold
        #    over the combined ladder on the device)
        decode = [s for s in np.flatnonzero(emit) if s not in resolved]
        if stalled and decode:
            # a slot whose resident rung is frozen decodes nothing — its
            # row is not consumed, so the decision stream is untouched
            # by where the stall landed
            frozen = [s for s in decode
                      if set(self.router.resident(s)) & stalled]
            for s in frozen:
                emit[s] = False
            decode = [s for s in decode if s not in frozen]
        if decode:
            losses = np.zeros((self.n_lanes, self.bank.n_total),
                              np.float32)
            floor = np.zeros(self.n_lanes, np.int32)
            for slot in decode:
                losses[slot] = self._row(self.lane_req[slot],
                                         int(self.lane_tidx[slot]))
                floor[slot] = self.router.floor(slot)
            mask = np.zeros(self.n_lanes, bool)
            mask[decode] = True
            dev = self.device
            arrays = self.bank_arrays()
            self.storages.add(tuple(t.data_ptr() for a in arrays
                                     for t in array_leaves(a)))
            out = self._decide(
                arrays, torch.as_tensor(losses, device=dev),
                torch.as_tensor(mask, device=dev),
                torch.as_tensor(np.asarray(sid, np.int32), device=dev),
                torch.as_tensor(floor, device=dev))
            served, probes, depth, deepest_arr = (t.cpu().numpy()
                                                  for t in out)
            seg_batch += int(depth.sum())
            if self.row_tap is not None:
                self.row_tap(losses[decode], served[decode])
            for slot in decode:
                self.lane_tidx[slot] += 1
                lp = len(self.lane_req[slot].prompt)
                probed = [m for m in range(m_count)
                          if int(probes[m, slot]) > 0]
                targets = self.router.escalation_targets(slot, probed)
                resident = set(self.router.resident(slot))
                for m in probed:
                    if m in resident:
                        probes_paid[m] += int(probes[m, slot])
                denied = False
                if targets and self.governor is not None:
                    # the degrade governor denies the escalation when the
                    # targets' catch-up prefill cannot fit the request's
                    # remaining deadline budget, or when a target rung is
                    # frozen by a stall window — the slot serves its best
                    # shallow (recalled) answer instead of parking
                    req = self.lane_req[slot]
                    cost = sum(
                        self.router.catchup_need(slot, m, lp)
                        * self.bank[m].prefill_tok_time
                        for m in targets)
                    denied = not self.governor.allow_escalation(
                        now=self.fault_now, deadline=req.deadline,
                        catchup_cost=cost,
                        stalled=any(m in stalled for m in targets))
                if targets and not denied:
                    # the token cannot finish on the resident rungs:
                    # stash the handoff, request deeper lanes, go silent
                    emit[slot] = False
                    self.router.begin_escalation(slot, targets, {
                        "served": int(served[slot]),
                        "probes": np.asarray(probes[:, slot]),
                        "probed_models": probed,
                        "loss": float(losses[slot, int(served[slot])]),
                        "deepest_node": int(deepest_arr[slot]),
                    })
                    self.stats.escalations += len(targets)
                    for m in targets:
                        if otr is not None:
                            otr.emit("escalate",
                                     rid=self.lane_req[slot].rid,
                                     lane=slot, model=m)
                        if self.esc.request(slot, m) is not None:
                            self._start_catchup(slot, m)
                            if otr is not None:
                                otr.emit("esc_grant",
                                         rid=self.lane_req[slot].rid,
                                         lane=slot, model=m)
                        elif otr is not None:
                            otr.emit("esc_wait",
                                     rid=self.lane_req[slot].rid,
                                     lane=slot, model=m)
                else:
                    sv = int(served[slot])
                    if denied:
                        # demotion: serve the best node the walk actually
                        # OBSERVED on a resident rung — a legal earlier
                        # stop on the node line (recall)
                        sv = self._demoted_node(slot, probed, resident,
                                                probes, losses,
                                                int(floor[slot]))
                        deepest = max((m for m in probed
                                       if m in resident), default=0)
                    else:
                        deepest = max(probed) if probed else 0
                    served_out[slot] = sv
                    sm = self.bank.model_of(sv)
                    self.stats.on_served(sm, deepest,
                                         loss=float(losses[slot, sv]))
                    if otr is not None:
                        self.last_loss[slot] = float(losses[slot, sv])
                        self.last_deepest[slot] = int(deepest_arr[slot])
                        if denied:
                            otr.emit("recall",
                                     rid=self.lane_req[slot].rid,
                                     lane=slot, model=sm, node=sv,
                                     deepest=deepest, denied=True)
                        elif deepest > sm:
                            otr.emit("recall",
                                     rid=self.lane_req[slot].rid,
                                     lane=slot, model=sm, node=sv,
                                     deepest=deepest)
                    for m in self.router.note_emit(slot, probed, sv, lp):
                        self.esc.release(slot, m)
                        self.stats.deescalations += 1
                        if otr is not None:
                            otr.emit("deescalate",
                                     rid=self.lane_req[slot].rid,
                                     lane=slot, model=m)

        if self.pool is not None and emit.any():
            # rung-0 paged bookkeeping per emitted token (fresh tail
            # pages from the reserved budget, COW on shared tails)
            self.pool.prepare_step(emit)
            self.pool.note_written(emit)

        # 5. the virtual clock: serial across models, piggyback
        #    roofline within each (catch-up hides under decode)
        cost = self.overhead
        for m in range(m_count):
            self.stats.probes[m] += int(probes_paid[m])
            decode_cost = self.bank[m].seg_time * float(probes_paid[m]) \
                / max(self.bank[m].n_lanes, 1)
            cost += max(decode_cost, float(chunk_cost[m]))
        seg_policy = int(probes_paid.sum())
        return (served_out, served_out, int(seg_batch), int(seg_policy),
                cost, emit)

    def cascade_stats(self) -> dict:
        out = self.stats.as_dict()
        out["models"] = [s.name for s in self.bank.specs]
        out["peak_lanes"] = {f"m{m}": v
                             for m, v in self.esc.peak_in_use.items()}
        if self.governor is not None:
            out.update(self.governor.stats())
        return out
