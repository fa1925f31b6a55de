"""`CascadeEngineStepper` — the real multi-model cascade: a ladder of
models live in ONE process, one `EngineStepper` per rung, one combined
strategy bank (DESIGN.md §10).

One Server step = one INTERLEAVED ROUND over the rungs:

  1. Rung 0 decodes every normally-walking slot (its chunked admission
     prefills ride along) through a ``walk_io`` token step: the step
     returns, per lane, whether the walk is still active after rung 0's
     head (the ESCALATION SIGNAL) plus the best-served-so-far logits —
     the handoff buffer.
  2. Each deeper rung m then steps its resident lanes in the SAME
     round, resuming the handed-off walks (``resume_walk``: states +
     logits scattered in, folds starting at the rung's global node
     offset).  Dual-resident lanes whose walk already stopped still
     step for position alignment, but their folds and KV writes are
     masked — the cross-model analogue of the engine's early-exit
     holes.
  3. A walk active past the deepest rung it could run on cannot finish
     its token: the slot goes silent, its handoff (walk states + best
     logits, both left on the device) is stashed, and the next rung's
     `EscalationScheduler` lane + catch-up prefill are requested.
     Catch-up re-prefills the stream through that rung's CHUNKED
     prefill path under its token budget; prefix-cache hits make a
     RE-escalation skip everything the rung retains from its previous
     residency — recall is a page-table re-pin plus a delta, never a
     full recompute.  Page needs are reserved INCREMENTALLY
     (`KVPool.grow`), not worst-case twice.
  4. When catch-up completes, the pending token decodes on the target
     rung from the stashed handoff and emits; under the recall policy
     both rungs then decode every round until the strategy ignores the
     deep rung for ``patience`` tokens (de-escalation frees its lane);
     under the commit policy the slot pins to the deep rung for good.

Determinism: every device computation is deterministic on its inputs,
all host routing is FIFO with rid tie-breaks, and each lane's stream is
a function of its own request (masked writes per rung).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.serving.cascade.bank import ModelBank
from repro_torch.serving.cascade.metrics import CascadeStats
from repro_torch.serving.cascade.router import CascadeRouter
from repro_torch.serving.cascade.scheduler import EscalationScheduler
from repro_torch.serving.kvpool import PoolExhausted
from repro_torch.serving.runtime.request import Request
from repro_torch.serving.runtime.scheduler import EngineStepper

__all__ = ["CascadeEngineStepper"]


def _slice_row(states, i: int):
    """One index's bank-state row (per-member states, batch axis
    dropped; copies, so later steps cannot change a stashed row)."""
    return tuple(st.map(lambda a: a[i].clone()) for st in states)


def _scatter_rows(dst_states, dst_lanes, src_rows):
    """Scatter per-slot state ROWS (fields without the batch axis) into
    a stepper's batched bank states."""
    if not dst_lanes:
        return dst_states
    dev = dst_states[0].n_probed.device
    idx = torch.as_tensor(dst_lanes, dtype=torch.long, device=dev)
    out = []
    for k, dst in enumerate(dst_states):
        stacked = src_rows[0][k].map(
            lambda *rows: torch.stack(rows), *[row[k] for row in src_rows[1:]])
        out.append(dst.map(
            lambda d, s: d.index_put((idx,), s.to(d.dtype)), stacked))
    return tuple(out)


class CascadeEngineStepper:
    """Real-model ladder stepper behind the standard Server loop."""

    virtual_time = False
    emits_tokens = True
    _tracer = None
    last_escalated = None  # per-slot: emitted via escalation resolution

    # installing the tracer here also fans it out to every rung's
    # EngineStepper, so their chunked prefills (initial + catch-up) land
    # on the same event stream
    @property
    def tracer(self):
        return self._tracer

    @tracer.setter
    def tracer(self, t) -> None:
        self._tracer = t
        for st in self.steppers:
            st.tracer = t

    # the server's `StepProbe` fans out the same way: each rung's step
    # times its own parts and transfers
    _probe = None

    @property
    def probe(self):
        return self._probe

    @probe.setter
    def probe(self, p) -> None:
        self._probe = p
        for st in self.steppers:
            st.probe = p

    def __init__(self, bank: ModelBank, strategies: tuple, *,
                 cache_len: int, prompt_len: int, page_size: int = 16,
                 chunk: int = 8, budgets=None, pages=None,
                 policy: str = "recall", patience: int = 4,
                 paged_kernel: bool = False, faults=None, governor=None):
        if any(sp.cfg is None or sp.params is None for sp in bank.specs):
            raise ValueError("CascadeEngineStepper needs real cfg+params "
                             "on every ModelSpec (sim specs drive "
                             "CascadeSimStepper)")
        for s in strategies:
            if s.n_nodes != bank.n_total:
                raise ValueError(f"strategy expects {s.n_nodes} nodes, "
                                 f"ladder has {bank.n_total}")
            if getattr(s, "persistent", False):
                raise ValueError("persistent strategies cannot hand "
                                 "walks across rungs")
            if policy == "commit" and getattr(s, "jumps", False):
                raise ValueError(
                    f"{type(s).__name__} walks a NEXT table from the "
                    "root; use --escalate-policy recall")
        self.bank = bank
        self.strategies = strategies
        self.n_lanes = bank[0].n_lanes        # Server request slots
        self.full_depth = bank.n_total
        self.prompt_len = int(prompt_len)
        self.page_size = int(page_size)
        self.policy = policy
        self.patience = int(patience)
        self.chunk = int(chunk)
        if budgets is None:
            budgets = [self.chunk] * len(bank)
        self.budgets = [int(b) for b in budgets]
        # fault plane: scripted chaos + the degrade governor (the Server
        # stamps its clock on ``fault_now`` when either is attached)
        self.faults = faults
        self.fault_now = 0.0
        self.governor = governor
        lane_pages = -(-int(cache_len) // self.page_size)
        self.steppers: list[EngineStepper] = []
        for m, sp in enumerate(bank.specs):
            self.steppers.append(EngineStepper(
                sp.params, sp.cfg, strategies, n_lanes=sp.n_lanes,
                cache_len=cache_len, prompt_len=prompt_len,
                kv="paged", page_size=page_size,
                n_pages=(pages[m] if pages is not None else None),
                paged_kernel=paged_kernel,
                prefill_chunk=self.chunk, prefill_budget=self.budgets[m],
                node_offset=bank.offset(m), walk_io=True,
                resume_walk=(m > 0), max_lane_pages=lane_pages,
                model_key=sp.name))
        # rung 0's pool doubles as the Server-facing pool for reports
        self.pool = self.steppers[0].pool
        self.alloc()

    # ------------------------------------------------------------------
    # lifecycle (Server contract)
    # ------------------------------------------------------------------

    def alloc(self) -> None:
        for st in self.steppers:
            st.alloc()
        n = self.n_lanes
        self.router = CascadeRouter(self.bank, n, policy=self.policy,
                                    patience=self.patience)
        self.esc = EscalationScheduler(self.bank, chunk=self.chunk,
                                       budgets=self.budgets)
        self.lane_req: list[Request | None] = [None] * n
        # per slot: prompt + every decode INPUT token so far (the seed
        # token + emitted stream) — the catch-up prefill source
        self.history: list[list[int] | None] = [None] * n
        # slots whose catch-up landed; their pending token resumes next
        # round
        self.ready: set[int] = set()
        # catch-up admissions blocked on pages: (slot, m, lane)
        self.page_wait: list[tuple[int, int, int]] = []
        self.rung_sid = [np.zeros(sp.n_lanes, np.int32)
                         for sp in self.bank.specs]
        self.stats = CascadeStats(len(self.bank))
        self._futile_rounds = 0
        self._page_blocked = False

    def warmup(self) -> None:
        for st in self.steppers:
            st.warmup()
        self.alloc()

    def reserve(self, req: Request) -> bool:
        return self.steppers[0].reserve(req)

    def admit(self, slot: int, req: Request) -> None:
        self.steppers[0].admit(slot, req)
        self.lane_req[slot] = req
        self.history[slot] = [int(t) for t in np.asarray(req.prompt)]
        self.router.admit(slot, len(req.prompt))

    def release(self, slot: int) -> None:
        for m in self.router.release(slot):
            if m == 0:
                self.steppers[0].release(slot)
            else:
                self.steppers[m].release(self._rung_lane(slot, m))
                self.esc.release(slot, m)
        # granted-but-unresolved deep lanes are NOT in the resident set
        # (catch-up still in flight, or parked in page_wait before the
        # rung stepper ever admitted them) — free them too, or a reaped
        # slot leaks the rung's lane and its catch-up pages
        waiting = {(w[0], w[1]) for w in self.page_wait}
        for m in range(1, len(self.bank)):
            lane = self.esc.lane_of(slot, m)
            if lane is None:
                continue
            if (slot, m) not in waiting:
                self.steppers[m].release(lane)
            self.esc.release(slot, m)
        self.esc.cancel(slot)
        self.page_wait = [w for w in self.page_wait if w[0] != slot]
        self.ready.discard(slot)
        self.lane_req[slot] = None
        self.history[slot] = None

    # ------------------------------------------------------------------
    # escalation plumbing
    # ------------------------------------------------------------------

    def _remaining(self, slot: int) -> int:
        tr = self.router.slots[slot]
        return max(1, self.lane_req[slot].max_tokens - tr.emitted)

    def _admit_catchup(self, slot: int, m: int, lane: int) -> None:
        """Chunk-prefill the stream's context onto rung ``m``: the
        catch-up 'prompt' is every token the rung must hold BEFORE the
        pending token's position (the last history entry is the pending
        decode's input).  The page reservation is ONE page-quantum —
        incremental `grow` covers later decode, so an escalated stream
        never reserves its worst case twice."""
        hist = self.history[slot]
        req = Request(rid=self.lane_req[slot].rid,
                      prompt=np.asarray(hist[:-1], np.int32),
                      max_tokens=min(self.page_size,
                                     self._remaining(slot)))
        stepper = self.steppers[m]
        if not stepper.reserve(req):
            self.page_wait.append((slot, m, lane))
            return
        stepper.admit(lane, req)
        self.rung_sid[m][lane] = self.rung_sid[0][slot]
        skipped = stepper._prefilling[lane]["cursor"]
        if skipped > 0:
            # prefix-cache hit from a previous residency: the retained
            # chain re-pins instead of recomputing
            self.stats.repin_tokens += int(skipped)

    def _rung_lane(self, slot: int, m: int) -> int:
        lane = self.esc.lane_of(slot, m)
        if lane is None:
            raise ValueError(f"slot {slot} holds no rung-{m} lane")
        return lane

    # ------------------------------------------------------------------
    # the interleaved round
    # ------------------------------------------------------------------

    def step(self, occupied: np.ndarray, sid: np.ndarray):
        occupied = np.asarray(occupied, bool)
        self.rung_sid[0] = np.asarray(sid, np.int32).copy()
        n = self.n_lanes
        emit = occupied.copy()
        emitted_out = np.zeros(n, np.int32)
        served_out = np.zeros(n, np.int32)
        sb = sp = 0
        chunk_before = sum(st.chunk_stats["tokens_computed"]
                           for st in self.steppers)
        otr = self._tracer
        if otr is not None:
            self.last_escalated = np.zeros(n, bool)

        # 0. freed rungs go to FIFO waiters; page-blocked admissions
        #    retry (pages may have been released since)
        for slot, m, lane in self.esc.grants():
            self._admit_catchup(slot, m, lane)
            if otr is not None:
                otr.emit("esc_grant", rid=self.lane_req[slot].rid,
                         lane=slot, model=m)
        retry, self.page_wait = self.page_wait, []
        for slot, m, lane in retry:
            self._admit_catchup(slot, m, lane)

        # slots resuming their pending token this round vs still silent
        resume = {s for s in self.ready if occupied[s]}
        self.ready -= resume
        silent = np.zeros(n, bool)
        for slot in np.flatnonzero(occupied):
            tr = self.router.slots[slot]
            if tr is not None and tr.pending is not None \
                    and slot not in resume:
                silent[slot] = True
        # page-pressure gate BEFORE any rung runs: a dual-resident slot
        # whose deep-rung lane cannot append (and cannot grow) must skip
        # the WHOLE round — deferring after rung 0 already decoded would
        # double-advance the stream
        self._page_blocked = bool(self.page_wait)
        for slot in np.flatnonzero(occupied & ~silent):
            tr = self.router.slots[slot]
            if tr is None:
                continue
            for m in sorted(tr.resident):
                if m == 0:
                    continue
                lane = self._rung_lane(slot, m)
                pool = self.steppers[m].pool
                if not pool.can_append(lane) and \
                        not pool.grow(lane, self.page_size):
                    silent[slot] = True
                    self._page_blocked = True
                    if slot in resume:
                        resume.discard(slot)
                        self.ready.add(slot)   # retry next round
                    break
        emit &= ~silent

        # 1. rung 0: every normally-walking slot (floored slots skip
        #    it; chunked admissions ride along inside the step)
        occ0 = occupied & ~silent
        for slot in np.flatnonzero(occ0):
            if slot in resume or self.router.floor(slot) > 0:
                occ0[slot] = False
        pre0 = set(self.steppers[0]._prefilling)
        tok0, served0, sb0, sp0, dec0, (wa0, best0) = \
            self.steppers[0].step(occ0, self.rung_sid[0])
        sb += sb0
        sp += sp0
        self.stats.probes[0] += sp0
        emit &= ~(occ0 & ~dec0)                # still prefilling: silent
        for lane in pre0 - set(self.steppers[0]._prefilling):
            # initial prefill finished: the fused chunk seeded the
            # stream's first token — it is the NEXT round's input
            self.history[lane].append(int(tok0[lane]))

        # 2. deeper rungs in ladder order.  Book-keeping per slot:
        #    walk_wa   — is the walk still active past its last rung,
        #    state_loc — (rung, index) where its walk states live,
        #    src_best  — its best-logits handoff row (device),
        #    probed    — rungs whose folds it ran this token.
        walk_wa = {int(s): bool(wa0[s]) for s in np.flatnonzero(dec0)}
        state_loc = {s: (0, s) for s in walk_wa}
        src_best = {s: best0[s] for s in walk_wa}
        probed = {s: [0] for s in walk_wa}
        final_tok = {s: int(tok0[s]) for s in walk_wa}
        final_served = {s: int(served0[s]) for s in walk_wa}
        for m in range(1, len(self.bank)):
            stepper = self.steppers[m]
            run: list[tuple[int, int, str]] = []   # (slot, lane, src)
            for slot in np.flatnonzero(occupied):
                tr = self.router.slots[slot]
                if tr is None:
                    continue
                if slot in resume and max(tr.pending["targets"]) == m:
                    run.append((slot, self._rung_lane(slot, m), "stash"))
                elif tr.pending is None and m in tr.resident:
                    if tr.floor > 0:
                        if self.bank.model_of(tr.floor) == m:
                            # committed here: fresh walk starts at this
                            # rung every token
                            run.append((slot, self._rung_lane(slot, m),
                                        "fresh"))
                    elif dec0[slot]:
                        # dual-resident: step for position alignment
                        # even when the walk stopped earlier (masked
                        # folds, §10 holes)
                        run.append((slot, self._rung_lane(slot, m),
                                    "cont"))
            if not run and not stepper._prefilling:
                continue
            occ_m = np.zeros(stepper.n_lanes, bool)
            wa_m = np.zeros(stepper.n_lanes, bool)
            dst_lanes, rows, best_rows, deferred = [], [], [], []
            for slot, lane, src in run:
                if not stepper.pool.can_append(lane) and \
                        not stepper.pool.grow(lane, self.page_size):
                    # page pressure: defer the slot, never fail it
                    # mid-stream.  Only stash/fresh slots reach here —
                    # dual "cont" slots were gated before rung 0 ran —
                    # so no partial rung work exists to corrupt; a
                    # resuming slot retries next round.
                    deferred.append(slot)
                    self._page_blocked = True
                    if src == "stash":
                        self.ready.add(slot)
                    continue
                occ_m[lane] = True
                if src == "cont":
                    wa_m[lane] = walk_wa.get(slot, False)
                    if wa_m[lane]:
                        loc_m, loc_i = state_loc[slot]
                        best_rows.append(src_best[slot])
                        dst_lanes.append(lane)
                        rows.append(_slice_row(
                            self.steppers[loc_m].states, loc_i))
                    else:
                        # position-alignment step: resident, unprobed
                        self.stats.sync_writes[m] += 1
                elif src == "stash":
                    h = self.router.pending_handoff(slot)
                    wa_m[lane] = True
                    best_rows.append(h["best"])
                    dst_lanes.append(lane)
                    rows.append(h["states"])
                else:                                   # fresh (floored)
                    wa_m[lane] = True
                    best_rows.append(torch.zeros(
                        (stepper.cfg.vocab,), dtype=torch.float32,
                        device=stepper.device))
                    dst_lanes.append(lane)
                    rows.append(tuple(s.init(1).map(lambda a: a[0])
                                      for s in self.strategies))
            for slot in deferred:
                emit[slot] = False
            best_m = torch.zeros((stepper.n_lanes, stepper.cfg.vocab),
                                 dtype=torch.float32, device=stepper.device)
            if dst_lanes:
                best_m[torch.as_tensor(dst_lanes, dtype=torch.long,
                                       device=stepper.device)] = \
                    torch.stack(best_rows)
            stepper.states = _scatter_rows(stepper.states, dst_lanes,
                                           rows)
            pre_m = set(stepper._prefilling)
            tok_m, served_m, sb_m, sp_m, dec_m, (wa_out, best_out) = \
                stepper.step(occ_m, self.rung_sid[m],
                             walk=(torch.as_tensor(wa_m,
                                                   device=stepper.device),
                                   best_m))
            sb += sb_m
            sp += sp_m
            self.stats.probes[m] += sp_m
            for lane in pre_m - set(stepper._prefilling):
                # catch-up landed: the pending walk resumes NEXT round;
                # its decode input is the token the source rung already
                # consumed, not the chunk's own head argmax
                slot = self.esc.slot_of(m, lane)
                if slot is None:
                    continue
                stepper.set_lane_token(lane, self.history[slot][-1])
                self.ready.add(slot)
            for slot, lane, src in run:
                if slot in deferred:
                    continue
                if src == "stash":
                    probed[slot] = sorted(set(
                        self.router.pending_handoff(slot)["models"]
                        + [m]))
                if bool(wa_m[lane]):
                    if src == "cont":
                        probed[slot].append(m)
                    elif src == "fresh":
                        probed[slot] = [m]
                    final_tok[slot] = int(tok_m[lane])
                    final_served[slot] = int(served_m[lane])
                    walk_wa[slot] = bool(wa_out[lane])
                    state_loc[slot] = (m, lane)
                    src_best[slot] = best_out[lane]

        # 3. emission resolution per slot (token overrides collected
        #    per rung and applied in one scatter each)
        tok_override: list[dict[int, int]] = [dict()
                                              for _ in self.bank.specs]
        for slot in np.flatnonzero(emit):
            slot = int(slot)
            tr = self.router.slots[slot]
            if tr is None or slot not in final_tok:
                emit[slot] = False
                continue
            lp = len(self.lane_req[slot].prompt)
            if slot in resume:
                if otr is not None:
                    for m in tr.pending["targets"]:
                        otr.emit("esc_resolve",
                                 rid=self.lane_req[slot].rid,
                                 lane=slot, model=m)
                    self.last_escalated[slot] = True
                for m in self.router.finish_escalation(slot, lp):
                    if m == 0:
                        self.steppers[0].release(slot)
                    else:
                        self.steppers[m].release(self._rung_lane(slot, m))
                        self.esc.release(slot, m)
                if self.policy == "commit":
                    self.stats.commits += 1
            if walk_wa.get(slot, False):
                targets = self._next_targets(slot, probed[slot])
                if targets:
                    # the token needs a rung it is not resident on:
                    # stash the handoff, request the lane, go silent
                    emit[slot] = False
                    loc_m, loc_i = state_loc[slot]
                    self.router.begin_escalation(slot, targets, {
                        "best": src_best[slot].clone(),
                        "states": _slice_row(
                            self.steppers[loc_m].states, loc_i),
                        "models": probed[slot],
                    })
                    self.stats.escalations += len(targets)
                    for m in targets:
                        if otr is not None:
                            otr.emit("escalate",
                                     rid=self.lane_req[slot].rid,
                                     lane=slot, model=m)
                        lane = self.esc.request(slot, m)
                        if lane is not None:
                            self._admit_catchup(slot, m, lane)
                            if otr is not None:
                                otr.emit("esc_grant",
                                         rid=self.lane_req[slot].rid,
                                         lane=slot, model=m)
                        elif otr is not None:
                            otr.emit("esc_wait",
                                     rid=self.lane_req[slot].rid,
                                     lane=slot, model=m)
                    continue
            token = final_tok[slot]
            served = final_served[slot]
            emitted_out[slot] = token
            served_out[slot] = served
            self.history[slot].append(token)
            sm = self.bank.model_of(served)
            deepest = max(probed[slot])
            self.stats.on_served(sm, deepest)
            if otr is not None and deepest > sm:
                otr.emit("recall", rid=self.lane_req[slot].rid,
                         lane=slot, model=sm, node=served,
                         deepest=deepest)
            for m in self.router.resident(slot):
                lane = slot if m == 0 else self._rung_lane(slot, m)
                tok_override[m][lane] = token
            for m in self.router.note_emit(slot, probed[slot], served,
                                           lp):
                # recall-policy de-escalation: pages back to the rung's
                # pool, the chain stays warm in its prefix cache — the
                # next escalation re-pins instead of recomputing
                self.steppers[m].release(self._rung_lane(slot, m))
                self.esc.release(slot, m)
                self.stats.deescalations += 1
                if otr is not None:
                    otr.emit("deescalate", rid=self.lane_req[slot].rid,
                             lane=slot, model=m)

        for m, over in enumerate(tok_override):
            if over:
                st = self.steppers[m]
                lanes_m = sorted(over)
                st.tok[torch.as_tensor(lanes_m, dtype=torch.long,
                                       device=st.device)] = \
                    torch.as_tensor([over[ln] for ln in lanes_m],
                                    dtype=torch.int32, device=st.device)

        # wedge guard: a round that emitted nothing and prefilled
        # nothing cannot free pages or lanes either (only emissions
        # release resources), so if page-blocked work exists the serve
        # can never progress — raise instead of spinning the Server
        # loop forever.  Deterministic, so 3 futile rounds == forever.
        chunk_after = sum(st.chunk_stats["tokens_computed"]
                          for st in self.steppers)
        progressed = bool(emit.any()) or chunk_after > chunk_before
        if not progressed and occupied.any():
            self._futile_rounds += 1
            if self._futile_rounds >= 3 and self._page_blocked:
                blocked = sorted({(s, m) for s, m, _ in self.page_wait})
                raise PoolExhausted(
                    f"cascade wedged: page-blocked escalation work "
                    f"(waiting admissions {blocked}) and no lane can "
                    "emit to free pages — a deeper rung's pool is too "
                    "small for this stream shape; raise its pages / "
                    "cache_len")
        else:
            self._futile_rounds = 0
        return emitted_out, served_out, int(sb), int(sp), emit

    # ------------------------------------------------------------------

    def _next_targets(self, slot: int, probed_models) -> list[int]:
        """The walk is active past the deepest rung it ran: the next
        ladder rung is the escalation target (rung-by-rung; a still-
        deeper need surfaces after that rung's own step).  With a
        `DegradeGovernor` attached, a denied escalation returns no
        targets — the slot then serves the walk's resident-depth
        answer through the normal emit path (the same legal serve the
        last rung uses), instead of parking past its deadline."""
        deepest = max(probed_models)
        if deepest + 1 >= len(self.bank):
            return []        # past the last head: nothing deeper exists
        targets = self.router.escalation_targets(slot, [deepest + 1])
        if targets and self.governor is not None:
            req = self.lane_req[slot]
            need = max(0, len(self.history[slot]) - 1)
            cost = sum(need * self.bank[m].prefill_tok_time
                       for m in targets)
            stalled = self.faults is not None and any(
                self.faults.stall_active(m, self.fault_now)
                for m in targets)
            if not self.governor.allow_escalation(
                    now=self.fault_now, deadline=req.deadline,
                    catchup_cost=cost, stalled=stalled):
                return []
        return targets

    def cascade_stats(self) -> dict:
        # deeper rungs only ever chunk-prefill catch-ups, so their chunk
        # counters ARE the escalation catch-up compute
        for m in range(1, len(self.bank)):
            self.stats.catchup_tokens[m] = \
                self.steppers[m].chunk_stats["tokens_computed"]
        out = self.stats.as_dict()
        out["models"] = [s.name for s in self.bank.specs]
        out["peak_lanes"] = {f"m{m}": v
                             for m, v in self.esc.peak_in_use.items()}
        out["pools"] = {sp.name: st.pool.stats()
                        for sp, st in zip(self.bank.specs, self.steppers)}
        out["chunks"] = {sp.name: dict(st.chunk_stats)
                         for sp, st in zip(self.bank.specs, self.steppers)}
        if self.governor is not None:
            out.update(self.governor.stats())
        return out
