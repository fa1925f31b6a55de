"""The continuous-batching serve loop and the model-free simulation.

Data flow per iteration:

    workload arrivals -> RequestQueue -> LaneScheduler.admit
        -> stepper.admit (page allocation + prefill | sim cursor)
        -> stepper.step  (one token for every decoding lane, one
                          prefill chunk for the admitting lanes)
        -> metrics.on_token / lane recycling on completion

`Server` drives either stepper behind one loop:

  * `EngineStepper` (scheduler.py) — the real model; time is wall time.
  * `SimStepper` (here) — model-free: each lane's token replays a row of
    per-node losses (calibration traces or synthetic) through the SAME
    strategy bank the engine would consult, and a virtual clock prices
    each step.  Its decision program runs on the stepper's device.

The sim cost model prices a step as ``overhead + seg_time * work``
where work is the launched depth (``cost="batch"``, what the masked
batch engine pays) or the mean per-lane probes (``cost="lane"``, what a
lane-granular dispatch would pay).

The control plane (`serving.control`) drives the loop through the
``controller`` hooks; the fault plane (`serving.faults`) rides the
stepper (``faults``, ``governor``, read with ``getattr``) and the
requests (``cancel_at``, ``deadline``).  The observability plane
(`serving.obs`) rides an ``obs`` bundle: the server binds its clock to
the tracer and hands the tracer to the stepper and the controller, and,
on a wall-clock stepper, a `StepProbe` that splits each turn's host
time by part and times every transfer (its record rides the turn's
``counter`` event); every producer guards on ``tracer is not None`` or
``probe is not None``, so an untraced serve does no extra work.  The
serve unbinds both from the stepper when it ends.
"""

from __future__ import annotations

import dataclasses
import time
import weakref

import numpy as np
import torch

from repro_torch.serving.engine import bank_observe, bank_serve
from repro_torch.serving.obs.probe import StepProbe
from repro_torch.serving.runtime.metrics import RuntimeMetrics
from repro_torch.serving.runtime.request import Request, RequestQueue
from repro_torch.serving.runtime.scheduler import ChunkPlanner, LaneScheduler
from repro_torch.strategy.base import (array_leaves, dynamic_arrays,
                                       with_arrays)

__all__ = ["Server", "SimStepper", "build_bank", "cascade_factory",
           "arrays_to"]

_ROW_PRIME = 9973  # deterministic per-(rid, token) trace-row assignment


def build_bank(requests, make_strategy, default: tuple):
    """Resolve the distinct per-request ``(strategy, lam)`` pairs into a
    static strategy bank.

    Returns ``(strategies, sid_of)`` — the tuple the token step runs
    over and the lane->member resolver the scheduler stamps on each
    admission.  ``make_strategy(name, lam)`` builds one member;
    ``default`` fills a request's missing fields (the launcher's
    factory is `repro_torch.launch.serve.build_strategy` with its
    knobs, the plain one `cascade_factory`).
    """
    def key_of(req):
        return (req.strategy or default[0],
                req.lam if req.lam is not None else default[1])

    keys: list = []
    for req in sorted(requests, key=lambda r: r.rid):
        k = key_of(req)
        if k not in keys:
            keys.append(k)
    if not keys:
        keys = [default]
    strategies = tuple(make_strategy(name, lam) for name, lam in keys)
    index = {k: i for i, k in enumerate(keys)}
    return strategies, lambda req: index[key_of(req)]


def cascade_factory(cascade):
    """The standard ``make_strategy`` for `build_bank`: registry dispatch
    against one calibrated cascade, with ``lam=None`` meaning the
    cascade's own lambda."""
    from repro_torch import strategy as _strategy

    def mk(name, lam):
        if lam is None:
            return _strategy.make(name, cascade)
        return _strategy.make(name, cascade, lam=lam)

    return mk


def arrays_to(obj, device):
    """``obj`` with every tensor in it on ``device``: a tensor, a
    dataclass of tensors (tables, supports), or a dict of those (a
    strategy's `dynamic_arrays`)."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, dict):
        return {k: arrays_to(v, device) for k, v in obj.items()}
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: arrays_to(getattr(obj, f.name), device)
            for f in dataclasses.fields(obj) if f.init})
    return obj


class SimStepper:
    """Model-free stepper: replays loss traces through the strategy bank.

    ``trace_bank`` is a ``(T, n_nodes)`` array of per-node losses (e.g.
    `core.traces.ee_like_traces` or a cascade's calibration traces);
    request ``rid``'s token ``t`` deterministically reads row
    ``(rid * 9973 + t) % T``, so a request's decisions are independent
    of lane placement and arrival order by construction.

    The decision program — one ``bank_observe`` fold per node over the
    occupied lanes' rows, then ``bank_serve`` — runs on ``device`` with
    the bank's dynamic arrays (`strategy.dynamic_arrays`) as its
    argument; ``bank_source`` overrides them (the control plane's
    hot-swap point: a `serving.control.BankSwap`, whose publishes copy
    into the same tensors) and ``row_tap`` receives each step's
    observed (loss rows, served nodes).

    ``pool`` is an optional host-side `KVPool` admission gate (the same
    reservation, prefix sharing, page growth and COW bookkeeping the
    engine does, with no device tensors behind it); ``faults`` is an
    optional `FaultPlan` whose rung-0 stall windows freeze the step.

    Prefill cost model: ``prefill_tok_time`` prices one prompt token.
    By default admission is STOP-THE-WORLD — the whole prompt's cost
    lands on the virtual clock as a SERIAL stall before the next step.
    With ``prefill_chunk`` set, admission is CHUNKED instead: the same
    `ChunkPlanner` the real engine uses spreads up to
    ``prefill_budget`` prompt tokens per step across admitting lanes,
    and the fused step is priced at ``max(decode cost, chunk cost)``
    (the compute-bound chunk hides under the memory-bound decode).
    Lanes emit their first token on the step after their prefill
    completes.  Token decisions are (rid, t)-keyed either way, so the
    two admission modes produce identical streams — only the clock
    moves.
    """

    virtual_time = True
    emits_tokens = False   # `emitted` carries served nodes, not token ids
    # the server installs a `SpanTracer` here when one is attached; the
    # per-lane attribution below is built only under a tracer
    tracer = None
    last_loss = None       # per-lane served-node loss of the last step
    last_deepest = None    # per-lane deepest PROBED node (-1 = silent)
    fault_now = 0.0        # the server's clock, stamped with a FaultPlan

    def __init__(self, strategies: tuple, trace_bank, *, n_lanes: int,
                 seg_time: float = 1.0, overhead: float = 0.25,
                 cost: str = "lane", prefill_tok_time: float = 0.0,
                 prefill_chunk: int | None = None,
                 prefill_budget: int | None = None, pool=None,
                 faults=None, device="cuda"):
        if cost not in ("lane", "batch"):
            raise ValueError(f"unknown cost model {cost!r}")
        self.device = torch.device(device)
        self.pool = pool
        self.faults = faults
        self.prefill_tok_time = float(prefill_tok_time)
        prefill_chunk = prefill_chunk or None      # 0 == disabled
        self.prefill_chunk = None if prefill_chunk is None \
            else int(prefill_chunk)
        self.planner = None if prefill_chunk is None else ChunkPlanner(
            self.prefill_chunk, prefill_budget)
        self.strategies = strategies
        self.bank = np.asarray(trace_bank, np.float32)
        self.n_nodes = self.bank.shape[1]
        self.full_depth = self.n_nodes
        self.n_lanes = int(n_lanes)
        self.seg_time = float(seg_time)
        self.overhead = float(overhead)
        self.cost = cost
        for s in strategies:
            if s.n_nodes != self.n_nodes:
                raise ValueError(
                    f"strategy expects {s.n_nodes} nodes, trace bank has "
                    f"{self.n_nodes}")
            if getattr(s, "needs_aux", False):
                raise ValueError(
                    f"{type(s).__name__} consumes the aux prediction "
                    "channel; simulation mode replays losses only — "
                    "serve it through the real EngineStepper instead")
        self._bank_arrays = tuple(arrays_to(dynamic_arrays(s), self.device)
                                  for s in strategies)
        self.bank_source = None
        self.row_tap = None
        # the data_ptrs of every set of bank storages a serving step
        # decided with (one set while publishes copy in place)
        self.storages: set = set()
        self.alloc()

    def _decide(self, arrays, losses, occupied, sid):
        live = tuple(with_arrays(s, a)
                     for s, a in zip(self.strategies, arrays))
        b = losses.shape[0]
        states = tuple(s.init(b) for s in live)
        active = occupied
        depth = torch.zeros((), dtype=torch.int32, device=self.device)
        policy = torch.zeros((), dtype=torch.int32, device=self.device)
        # per-lane deepest PROBED node, folded from the per-node
        # n_probed deltas (no extra strategy calls)
        deepest = torch.full((b,), -1, dtype=torch.int32, device=self.device)
        np_prev = torch.zeros((b,), dtype=torch.int32, device=self.device)

        def probed_of(states):
            out = states[0].n_probed
            for k in range(1, len(live)):
                out = torch.where(sid == k, states[k].n_probed, out)
            return out

        for node in range(self.n_nodes):
            depth = depth + active.any().to(torch.int32)
            policy = policy + active.sum(dtype=torch.int32)
            states, active = bank_observe(live, states, node,
                                          losses[:, node], None, active,
                                          sid)
            np_now = probed_of(states)
            deepest = torch.where(np_now > np_prev, node, deepest)
            np_prev = np_now
        return bank_serve(live, states, sid), depth, policy, deepest

    def bank_arrays(self) -> tuple:
        """The per-slot dynamic arrays the next step will decide with."""
        if self.bank_source is not None:
            return self.bank_source.bank_arrays()
        return self._bank_arrays

    def decide_cache_size(self) -> int:
        """The number of distinct sets of bank storages the serving steps
        have handed the decision program (the JAX package counts jit
        cache entries here).  A `BankSwap` publish copies into the same
        storages, so this stays 1 across swaps and publishes."""
        return len(self.storages)

    def apply_gear(self, gear) -> None:
        """Host-side gear knobs outside the strategy tables: the
        chunked-prefill budget.  Routing (which slot new admissions
        use) and tables (recalibration) swap through ``bank_source``."""
        budget = getattr(getattr(gear, "spec", gear),
                         "prefill_budget", None)
        if budget is not None and self.planner is not None:
            self.planner.budget = int(budget)

    def alloc(self) -> None:
        self.lane_req: list[Request | None] = [None] * self.n_lanes
        self.lane_tidx = np.zeros(self.n_lanes, np.int64)
        self.lane_prefill = np.zeros(self.n_lanes, np.int64)
        self._stall = 0.0          # stop-the-world prefill debt
        # served-loss accumulator: the trace loss of every served node
        self.served_loss_sum = 0.0
        self.served_loss_n = 0
        self._stall_seen: set = set()   # (model, window-start) emitted
        if self.pool is not None:
            self.pool.reset()

    def _note_stall(self, model: int) -> None:
        """Emit one `rung_stall` span per scripted window edge."""
        win = self.faults.stall_window(model, self.fault_now)
        if win is None or (model, win[0]) in self._stall_seen:
            return
        self._stall_seen.add((model, win[0]))
        if self.tracer is not None:
            self.tracer.emit("rung_stall", model=model,
                             t0=round(win[0], 9), until=round(win[1], 9))

    def reserve(self, req: Request) -> bool:
        """Admission gate: with a pool attached, reserve the request's
        worst-case page need (or leave it queued); gate-free otherwise."""
        if self.pool is None:
            return True
        return self.pool.reserve(req.prompt, req.max_tokens)

    def release(self, lane: int) -> None:
        self.lane_prefill[lane] = 0     # reaped mid-prefill: drop debt
        if self.pool is not None:
            self.pool.release(lane)

    def admit(self, lane: int, req: Request) -> None:
        self.lane_req[lane] = req
        self.lane_tidx[lane] = 0
        lp = len(req.prompt)
        if self.pool is not None:
            self.pool.admit(lane, req.prompt, req.max_tokens)
        if self.prefill_chunk is not None:
            self.lane_prefill[lane] = lp
        elif self.prefill_tok_time > 0.0:
            # stop-the-world: the whole prompt stalls the next step
            self._stall += lp * self.prefill_tok_time

    def warmup(self) -> None:
        """Run the decision program once (virtual time is unaffected)."""
        n = self.n_lanes
        self._decide(self.bank_arrays(),
                     torch.zeros((n, self.n_nodes), device=self.device),
                     torch.zeros((n,), dtype=torch.bool, device=self.device),
                     torch.zeros((n,), dtype=torch.int32,
                                 device=self.device))
        self.alloc()

    def _row(self, req: Request, tidx: int) -> np.ndarray:
        return self.bank[(req.rid * _ROW_PRIME + tidx) % len(self.bank)]

    def step(self, occupied: np.ndarray, sid: np.ndarray):
        """Returns ``(emitted, served, seg_batch, seg_policy, cost,
        emit_mask)`` — lanes mid-prefill are occupied but emit nothing
        and consume no trace row."""
        occupied = np.asarray(occupied, bool)
        if (self.faults is not None
                and self.faults.stall_active(0, self.fault_now)):
            # the single sim rung is frozen: no rows consumed, no
            # tokens, no prefill progress — only the clock moves, so a
            # finite window always passes (liveness)
            self._note_stall(0)
            if self.tracer is not None:
                self.last_loss = np.full(self.n_lanes, np.nan)
                self.last_deepest = np.full(self.n_lanes, -1)
            served = np.zeros(self.n_lanes, np.int64)
            return (served, served, 0, 0, self.overhead,
                    np.zeros(self.n_lanes, bool))
        emit = occupied.copy()
        stall = self._stall                 # stop-the-world: serial
        self._stall = 0.0
        chunk_cost = 0.0                    # chunked: piggybacked
        if self.prefill_chunk is not None:
            prefilling = occupied & (self.lane_prefill > 0)
            emit &= ~prefilling
            if prefilling.any():
                widths = self.planner.plan({
                    int(lane): (int(self.lane_prefill[lane]),
                                len(self.lane_req[lane].prompt))
                    for lane in np.flatnonzero(prefilling)})
                for lane, w in widths.items():
                    self.lane_prefill[lane] -= w
                    chunk_cost += w * self.prefill_tok_time
                    if self.tracer is not None:
                        self.tracer.emit(
                            "prefill_chunk", lane=lane,
                            rid=self.lane_req[lane].rid, width=int(w),
                            left=int(self.lane_prefill[lane]))
        if self.pool is not None and emit.any():
            # paged bookkeeping per decode token: fresh tail pages from
            # the reserved budget, COW splits on shared tails
            self.pool.prepare_step(emit)
            self.pool.note_written(emit)
        losses = np.zeros((self.n_lanes, self.n_nodes), np.float32)
        for lane in np.flatnonzero(emit):
            losses[lane] = self._row(self.lane_req[lane],
                                     int(self.lane_tidx[lane]))
            self.lane_tidx[lane] += 1
        arrays = self.bank_arrays()
        self.storages.add(tuple(t.data_ptr() for a in arrays
                                 for t in array_leaves(a)))
        served, depth, policy, deepest = self._decide(
            arrays, torch.as_tensor(losses, device=self.device),
            torch.as_tensor(emit, device=self.device),
            torch.as_tensor(np.asarray(sid, np.int32), device=self.device))
        served = served.cpu().numpy()
        depth, policy = int(depth), int(policy)
        for lane in np.flatnonzero(emit):
            self.served_loss_sum += float(losses[lane, served[lane]])
            self.served_loss_n += 1
        if self.tracer is not None:
            # per-lane served-node loss (NaN = no emission) and deepest
            # probed node, picked up by the server's token events for
            # decision attribution (the one copy of ``deepest`` back)
            self.last_loss = np.where(
                emit, losses[np.arange(self.n_lanes),
                             np.clip(served, 0, self.n_nodes - 1)], np.nan)
            self.last_deepest = np.where(emit, deepest.cpu().numpy(), -1)
        if self.row_tap is not None and emit.any():
            idx = np.flatnonzero(emit)
            self.row_tap(losses[idx], served[idx])
        work = (policy / self.n_lanes) if self.cost == "lane" else depth
        # piggyback roofline: the compute-bound chunk hides under the
        # memory-bound decode sweep; the serial stop-the-world stall
        # cannot (it is its own batch-1 program on the device queue)
        cost = self.overhead + max(self.seg_time * float(work),
                                   chunk_cost) + stall
        # sim tokens have no content; the served node stands in
        return served, served, depth, policy, cost, emit

    @property
    def mean_served_loss(self) -> float | None:
        if not self.served_loss_n:
            return None
        return self.served_loss_sum / self.served_loss_n


def _weak_clock(server):
    """``server._now`` through a weak reference; once the server is gone
    the clock keeps returning the last time it read."""
    ref = weakref.ref(server)
    last = 0.0

    def now() -> float:
        nonlocal last
        srv = ref()
        if srv is not None:
            last = srv._now()
        return last

    return now


class Server:
    """Open-loop continuous-batching server over any stepper.

    ``order`` is the queue discipline (``"fifo"`` or ``"edf"``; under
    EDF a request without a deadline gets ``arrival + slo``),
    ``static_batching`` admits a new batch only when every lane is free,
    ``eos`` ends a stream early on that token (token-emitting steppers
    only), and ``enforce_deadlines`` reaps requests past their
    ``deadline``; a request's ``cancel_at`` is always enforced.
    ``controller`` (a `serving.control.AdaptiveController`) is bound to
    the run by ``begin``, fed arrivals by ``on_arrivals``, and called at
    every step boundary by ``on_step_end`` — the one instant a gear swap
    or a table publish may land.  ``obs`` (a `serving.obs.Observability`)
    traces the serve: lifecycle and per-token events on the server's
    clock (virtual in sim mode, so the trace is deterministic), with its
    flight recorder, invariant ledger and regret meter riding the
    tracer's listener hook.
    """

    def __init__(self, stepper, scheduler: LaneScheduler, sid_of, *,
                 order: str = "fifo", slo: float | None = None,
                 static_batching: bool = False, eos: int | None = None,
                 controller=None, obs=None,
                 enforce_deadlines: bool = False):
        self.stepper = stepper
        self.scheduler = scheduler
        self.sid_of = sid_of
        self.order = order
        self.slo = slo
        self.static_batching = static_batching
        self.eos = eos
        self.enforce_deadlines = bool(enforce_deadlines)
        self.obs = obs
        self.controller = controller
        self._vt = 0.0
        self._t0 = 0.0
        self._probe = None

    # ---- clock ---------------------------------------------------------
    def _now(self) -> float:
        if self.stepper.virtual_time:
            return self._vt
        return time.perf_counter() - self._t0

    def _advance_to(self, t: float) -> None:
        if self.stepper.virtual_time:
            self._vt = max(self._vt, t)
        else:
            if self._probe is not None:
                self._probe.waited()
            gap = t - self._now()
            if gap > 0:
                time.sleep(gap)

    # ---- reaping -------------------------------------------------------
    def _reap_status(self, req, now: float) -> str | None:
        """Terminal status a live request has earned by ``now``, or
        None.  Cancellation wins ties — a hung-up client's deadline is
        moot."""
        if req.cancel_at is not None and req.cancel_at <= now:
            return "cancelled"
        if (self.enforce_deadlines and req.deadline is not None
                and req.deadline <= now):
            return "timed_out"
        return None

    def _reap(self, queue, metrics, tracer, release, now: float) -> None:
        """Sweep cancelled / expired requests out of the queue and off
        their lanes between steps.  Lane teardown runs release-first so
        the span events land on an already-clean pool — the ledger's
        `cancel_releases_pages` probe reads pool state at the event."""
        sched = self.scheduler
        for req in queue.reap(
                lambda r: self._reap_status(r, now) is not None):
            status = self._reap_status(req, now)
            metrics.on_reap(req, now, status)
            if tracer is not None:
                kind = ("cancel" if status == "cancelled"
                        else "deadline_miss")
                tracer.emit(kind, rid=req.rid)
        for lane in np.flatnonzero(sched.occupied_mask()):
            req = sched.lane_req[lane]
            status = self._reap_status(req, now)
            if status is None:
                continue
            if release is not None:
                release(int(lane))  # KV pages + escalation lanes freed
            sched.release(int(lane))
            metrics.on_reap(req, now, status)
            if tracer is not None:
                kind = ("cancel" if status == "cancelled"
                        else "deadline_miss")
                tracer.emit(kind, rid=req.rid, lane=int(lane))

    def _fault_wake(self, queue, faults, reaping: bool,
                    now: float) -> float | None:
        """Earliest future instant at which the fault plane changes the
        picture for a queue that cannot admit right now: a queued
        request's reap time, or a scripted stall/squeeze boundary."""
        wake = None
        if reaping:
            for r in queue.requests():
                for t in (r.cancel_at,
                          r.deadline if self.enforce_deadlines else None):
                    if t is not None and t > now and (wake is None
                                                      or t < wake):
                        wake = t
        if faults is not None:
            nc = faults.next_change(now)
            if nc is not None and (wake is None or nc < wake):
                wake = nc
        return wake

    # ---- the loop ------------------------------------------------------
    def serve(self, requests, warmup: bool = True) -> RuntimeMetrics:
        """Run the full open-loop session: admit every request at its
        arrival time, decode until all streams drain, return metrics.

        ``warmup`` runs the stepper once before the serving clock starts
        (on the card this builds and loads the kernels), so wall-clock
        latency percentiles measure serving; without it the stepper's
        lane state is only allocated."""
        sched = self.scheduler
        stepper = self.stepper
        if warmup:
            stepper.warmup()
        else:
            stepper.alloc()
        metrics = RuntimeMetrics(stepper.full_depth, sched.n_lanes)
        if self.controller is not None:
            self.controller.begin(metrics, stepper)
        tracer = self.obs.tracer if self.obs is not None else None
        probe = None
        if tracer is not None:
            probe = self._bind_obs(tracer, metrics)
        deadline_of = None
        if self.order == "edf" and self.slo is not None:
            deadline_of = lambda r: r.arrival + self.slo  # noqa: E731
        queue = RequestQueue(self.order, deadline_of=deadline_of)
        pending = sorted(requests, key=lambda r: (r.arrival, r.rid))
        # the fault plan's serve-borne windows (rung stalls, page
        # squeezes) are read off the clock each iteration; the degrade
        # governor reads the clock too, plan or not
        faults = getattr(stepper, "faults", None)
        clocked = (faults is not None
                   or getattr(stepper, "governor", None) is not None)
        reaping = self.enforce_deadlines or any(
            r.cancel_at is not None for r in pending)
        self._vt = 0.0
        self._t0 = time.perf_counter()
        metrics.t_start = self._now()
        # paged-KV steppers gate admission on their free-page budget
        # (reserve-at-pop); a blocked request waits at the queue head
        gate = getattr(stepper, "reserve", None)
        release = getattr(stepper, "release", None)
        if gate is not None and tracer is not None:
            def gate(req, _inner=gate):
                ok = _inner(req)
                if not ok:
                    tracer.emit("page_blocked", rid=req.rid)
                return ok

        while pending or len(queue) or sched.busy():
            if probe is not None:
                probe.begin_turn()
            now = self._now()
            if clocked:
                stepper.fault_now = now
            if faults is not None:
                pool = getattr(stepper, "pool", None)
                if pool is not None:
                    pool.set_squeeze(faults.squeeze_pages(now))
            pushed = []
            while pending and pending[0].arrival <= now:
                req = pending.pop(0)
                queue.push(req)
                pushed.append(req.arrival)
                if tracer is not None:
                    self._emit_queued(tracer, req)
            if self.controller is not None and pushed:
                self.controller.on_arrivals(pushed)
            if reaping:
                self._reap(queue, metrics, tracer, release, now)
            if probe is not None:
                probe.push("tt.admit")
            for lane, req in sched.admit(
                    queue, self.sid_of,
                    static_batching=self.static_batching,
                    can_admit=gate):
                stepper.admit(lane, req)
                metrics.on_admit(req, self._now())
                if tracer is not None:
                    tracer.emit("admitted", rid=req.rid, lane=lane,
                                sid=int(sched.sid[lane]))
            if probe is not None:
                probe.pop()
            if not sched.busy():
                if not pending:
                    # nothing running, nothing arriving — the queue may
                    # still hold page-blocked requests.  Guard against a
                    # request that can NEVER be admitted, unless a queued
                    # request is about to be reaped: then jump there.
                    if len(queue):
                        wake = self._fault_wake(queue, faults, reaping,
                                                now)
                        if wake is not None and wake > now:
                            self._advance_to(wake)
                            continue
                        raise RuntimeError(
                            "admission deadlock: queued requests but no "
                            "lane busy and no pending arrivals")
                    break
                # every lane idle and nothing admissible: jump (sim) or
                # sleep (real) to the next arrival
                self._advance_to(pending[0].arrival)
                continue

            out = stepper.step(sched.occupied_mask(), sched.sid)
            if stepper.virtual_time:
                emitted, served, sb, sp, cost, emit = out
                self._vt += cost
            else:
                emitted, served, sb, sp, emit = out
            tnow = self._now()
            # emit marks lanes whose entry is a real token this step;
            # lanes mid-prefill are occupied but still silent
            metrics.on_step(sb, sp, int(np.asarray(emit).sum()))
            if probe is not None:
                probe.push("tt.tokens")
            for lane in np.flatnonzero(emit):
                req = sched.lane_req[lane]
                metrics.on_token(req.rid, int(served[lane]), tnow,
                                 token=int(emitted[lane]))
                if tracer is not None:
                    self._emit_token(tracer, metrics, req, lane, emitted,
                                     served)
                done = sched.consume_token(lane)
                if (not done and self.eos is not None
                        and getattr(stepper, "emits_tokens", True)
                        and int(emitted[lane]) == self.eos):
                    done = True  # stream early exit: recycle immediately
                if done:
                    metrics.on_finish(req.rid, tnow)
                    if release is not None:
                        release(lane)   # paged KV: pages back to the pool
                    sched.release(lane)
                    if tracer is not None:
                        tracer.emit("finish", rid=req.rid, lane=int(lane))
            if probe is not None:
                probe.pop()
            if tracer is not None:
                data = {"queue": len(queue)}
                pool = getattr(stepper, "pool", None)
                if pool is not None:
                    data["pages_in_use"] = int(pool.pages_in_use)
                if probe is not None:
                    data.update(probe.end_turn())
                tracer.emit("counter", **data)
            if self.controller is not None:
                # step boundary: no lane is mid-token — the one atomic
                # instant a gear swap / table publish may land
                self.controller.on_step_end(self._now(), len(queue))

        metrics.t_end = self._now()
        if self.obs is not None:
            if self.obs.ledger is not None:
                self.obs.ledger.finalize(self._now())
            if self.obs.regret is not None:
                self.obs.regret.finalize(self._now())
        if tracer is not None:
            self._unbind_obs(tracer, probe)
        return metrics

    # ---- observability -------------------------------------------------
    def _bind_obs(self, tracer, metrics) -> StepProbe | None:
        """Bind the tracer to this serve: the server's clock, the stepper
        and the controller as producers, and the flight recorder, ledger
        and regret meter as listeners (they never emit or sync).  A
        stepper that runs in wall time gets a fresh `StepProbe`, which
        times the tracer's emits too, lands in ``obs.probe`` and is
        returned.

        The tracer outlives the serve (the launcher returns it), so
        nothing bound here holds the server: the clock reaches it through
        a weak reference.  A strong one would make a server -> obs ->
        tracer -> server cycle that keeps the stepper's weights and pools
        alive until the cycle collector runs."""
        stepper = self.stepper
        tracer.bind_clock(_weak_clock(self))
        stepper.tracer = tracer
        probe = None
        if not stepper.virtual_time:
            probe = StepProbe()
            stepper.probe = tracer.timer = self._probe = probe
        self.obs.probe = probe
        if self.controller is not None:
            self.controller.tracer = tracer
        flight = self.obs.flight
        if flight is not None:
            if flight.slo is None:
                flight.slo = self.slo
            slo = self.slo
            flight.bind(tracer, snapshot_fn=lambda: metrics.summary(slo))
        if self.obs.ledger is not None:
            self.obs.ledger.bind(tracer,
                                 pool=getattr(stepper, "pool", None))
        if self.obs.regret is not None:
            self.obs.regret.bind(tracer, stepper=stepper, flight=flight,
                                 controller=self.controller)
        return probe

    def _unbind_obs(self, tracer, probe) -> None:
        """The serve is over: a later step or serve without a tracer
        emits nothing and reads no probe clock (``obs.probe`` keeps the
        totals)."""
        self.stepper.tracer = None
        if probe is not None:
            probe.close()
            self.stepper.probe = tracer.timer = self._probe = None

    @staticmethod
    def _emit_queued(tracer, req) -> None:
        """The queued event carries everything needed to rebuild the
        request (`obs.replay`) — prompt bytes included, since paged
        admission and prefix sharing key on content."""
        extra = {"plen": len(req.prompt), "ntok": int(req.max_tokens),
                 "prompt": np.asarray(req.prompt,
                                      np.uint32).tobytes().hex()}
        if req.strategy is not None:
            extra["strategy"] = req.strategy
        if req.lam is not None:
            extra["lam"] = float(req.lam)
        if req.deadline is not None:
            extra["deadline"] = float(req.deadline)
        if req.cancel_at is not None:
            extra["cancel_at"] = float(req.cancel_at)
        tracer.emit("queued", t=req.arrival, rid=req.rid, **extra)

    def _emit_token(self, tracer, metrics, req, lane, emitted,
                    served) -> None:
        """One token event: the served node and bank slot, the TTFT on
        a request's first token, and the stepper's per-lane attribution
        (served loss, escalated, deepest probed node) where it has it —
        all host values the step already returned."""
        stepper = self.stepper
        extra = {}
        rec = metrics.records[req.rid]
        if rec.n_tokens == 1 and rec.ttft is not None:
            extra["ttft"] = round(rec.ttft, 9)
        ll = getattr(stepper, "last_loss", None)
        if ll is not None and not np.isnan(ll[lane]):
            extra["loss"] = round(float(ll[lane]), 6)
        le = getattr(stepper, "last_escalated", None)
        if le is not None and le[lane]:
            extra["esc"] = True
        ld = getattr(stepper, "last_deepest", None)
        if ld is not None and ld[lane] >= 0:
            extra["deepest"] = int(ld[lane])
        if getattr(stepper, "emits_tokens", True):
            extra["tok"] = int(emitted[lane])
        tracer.emit("token", rid=req.rid, lane=int(lane),
                    node=int(served[lane]),
                    sid=int(self.scheduler.sid[lane]), **extra)
