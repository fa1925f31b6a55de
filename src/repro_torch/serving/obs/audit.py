"""`InvariantLedger` — streaming contracts over the span stream
(DESIGN.md §13).

The ledger rides `SpanTracer.add_listener` exactly like the flight
recorder: it adds no producers and no device syncs, it just folds every
event into O(live-rids) contract state.  A serve with no ledger — or no
tracer at all — is bit-identical, the same guarantee the tracer itself
gives.

Contracts (each reports ``checks`` / ``violations`` and a verdict):

  * ``page_conservation`` — with a bound `KVPool`, the pool's own
    `check_invariants()` runs at every counter-event edge: allocs ==
    frees + in_use, refcounts never negative, every reference accounted
    to a lane table or prefix-cache entry, reserved budgets within the
    free list.  Without a pool the contract degrades to what the event
    stream alone can see (pages_in_use gauges never negative).
  * ``escalation_resolves`` — every ``escalate`` reaches
    ``esc_resolve`` / ``recall`` / ``deescalate`` / ``finish`` within
    ``horizon`` serve-seconds (virtual seconds in sim mode).  A waiter
    older than the horizon is a leaked deep lane or a wedged scheduler.
  * ``lane_conservation`` — lane occupancy across admit/recycle:
    admitting onto a lane that still holds a live request, a token or
    finish on a lane that disagrees with the rid's admission, a token
    before any admission — each is a conservation break.
  * ``walk_floor_monotonic`` — under ``--escalate-policy commit`` a
    request's served model rung may never move back down (that is what
    "commit" means; only recall policies may de-escalate).  Armed by
    passing ``policy="commit"`` and the cascade's ``boundaries``.
  * ``ttft_exactly_once`` — exactly one token event per rid carries the
    ``ttft`` stamp, and it is the rid's FIRST token.
  * ``admission_never_drop`` — the T-Tamer admission guarantee: queue,
    never drop.  At finalize every queued rid must have been admitted
    and finished — a page-blocked request may wait, but must land.
  * ``cancel_halts_stream`` — a reaped rid (``cancel`` /
    ``deadline_miss``) emits NOTHING afterwards: no tokens, no prefill
    chunks, no escalation grants.  A late emission means the server
    reaped the bookkeeping but left the lane running.
  * ``cancel_releases_pages`` — at the reap event of a lane-holding
    request, the pool shows zero pages and zero budget on that lane
    (the server releases BEFORE emitting, so the probe reads the
    post-teardown state; COW-shared prefix pages survive via their
    cache refs, which is the point).
  * ``rung_stall_liveness`` — an escalation whose window overlaps a
    scripted ``rung_stall`` may take the stall's duration extra, but
    no more: the stall allowance is added to the horizon, and
    exceeding even that is a deadlocked waiter, not a slow one.

Verdicts are ``pass`` / ``violated`` / ``unverifiable``.  The live
listener sees every emit regardless of ring evictions, so live verdicts
are exact.  `audit_events` (offline, over an exported ring) reports
``unverifiable`` instead of guessing whenever events were dropped:
a truncated ring makes "no admission seen" indistinguishable from
"admission evicted", and a false positive would poison CI.

On violation the ledger freezes a `flight_bundle/v1`-style dump (the
offending rid's FULL span history + the recent ring window) so the
break arrives with its causes attached — same artifact shape the
flight recorder emits and `benchmarks.check_trace --bundle` validates.
"""

from __future__ import annotations

import json
import os
from typing import Any

from repro_torch.serving.obs.trace import Event, SpanTracer

__all__ = ["InvariantLedger", "audit_events", "CONTRACTS"]

CONTRACTS = (
    "page_conservation",
    "escalation_resolves",
    "lane_conservation",
    "walk_floor_monotonic",
    "ttft_exactly_once",
    "admission_never_drop",
    "cancel_halts_stream",
    "cancel_releases_pages",
    "rung_stall_liveness",
)

_ESC_CLEARS = {"esc_resolve", "recall", "deescalate", "finish"}


class InvariantLedger:
    """Streaming auditor over a tracer's event stream.

    ``horizon`` bounds how long an escalation may stay unresolved
    (serve-seconds).  ``policy`` + ``boundaries`` arm the walk-floor
    contract: ``boundaries`` is the cascade's per-model node count
    tuple, mapping a served node to its model rung.  ``pool`` (or the
    pool the server binds) turns page conservation from gauge checks
    into the pool's full `check_invariants` audit, sampled every
    ``pool_check_every`` counter events.  ``max_violations`` caps the
    retained detail list; ``max_bundles`` caps frozen dumps.
    """

    def __init__(self, *, horizon: float = 120.0,
                 policy: str | None = None,
                 boundaries: tuple[int, ...] | None = None,
                 pool=None, pool_check_every: int = 1,
                 out_dir: str | None = None, window: int = 512,
                 max_violations: int = 64, max_bundles: int = 8):
        self.horizon = float(horizon)
        self.policy = policy
        self.boundaries = tuple(boundaries) if boundaries else None
        self.pool = pool
        self.pool_check_every = max(1, int(pool_check_every))
        self.out_dir = out_dir
        self.window = int(window)
        self.max_violations = int(max_violations)
        self.max_bundles = int(max_bundles)

        self.checks: dict[str, int] = {c: 0 for c in CONTRACTS}
        self.violations: list[dict[str, Any]] = []
        self.n_violations: dict[str, int] = {c: 0 for c in CONTRACTS}
        self.bundles: list[dict[str, Any]] = []
        self.dump_paths: list[str] = []
        self.events_seen = 0
        self.finalized = False
        self._tracer: SpanTracer | None = None

        # O(live-rids) state, cleaned on finish
        self._queued: set[int] = set()            # queued, not yet admitted
        self._admitted: dict[int, int] = {}       # rid -> lane
        self._lane_rid: dict[int, int] = {}       # lane -> rid
        self._ttft_seen: set[int] = set()
        self._tokens: dict[int, int] = {}         # rid -> token count
        self._esc_open: dict[tuple[int, int], float] = {}  # (rid,model)->t
        self._floor: dict[int, int] = {}          # rid -> deepest model rung
        self._counters = 0
        self._t_last = 0.0
        # fault plane (DESIGN.md §14)
        self._reaped: set[int] = set()            # cancelled / expired rids
        self._stalls: list[tuple[int, float, float]] = []  # (model, t0, t1)

    # ------------------------------------------------------------ wiring
    def bind(self, tracer: SpanTracer, *, pool=None) -> None:
        """Attach to a tracer as a chained listener.  The server passes
        the stepper's pool (when it has one) so page conservation audits
        the real allocator instead of just the exported gauges."""
        self._tracer = tracer
        if pool is not None:
            self.pool = pool
        tracer.add_listener(self.observe)

    def _node_model(self, node: int) -> int:
        if not self.boundaries:
            return 0
        acc = 0
        for m, n in enumerate(self.boundaries):
            acc += n
            if node < acc:
                return m
        return len(self.boundaries) - 1

    # ------------------------------------------------------------ stream
    def observe(self, ev: Event) -> None:
        self.events_seen += 1
        self._t_last = max(self._t_last, ev.t)
        kind = ev.kind
        if (ev.rid >= 0 and self._reaped and ev.rid in self._reaped
                and kind in ("token", "prefill_chunk", "escalate",
                             "esc_wait", "esc_grant", "esc_resolve",
                             "recall", "finish")):
            self._violate("cancel_halts_stream", ev,
                          f"rid {ev.rid} emitted {kind} after being "
                          f"reaped")
            return   # a phantom emission must not feed other contracts
        if kind == "queued":
            self._queued.add(ev.rid)
        elif kind == "admitted":
            self.checks["lane_conservation"] += 1
            prev = self._lane_rid.get(ev.lane)
            if prev is not None:
                self._violate("lane_conservation", ev,
                              f"lane {ev.lane} admitted rid {ev.rid} "
                              f"while still holding rid {prev}")
            if ev.rid in self._admitted:
                self._violate("lane_conservation", ev,
                              f"rid {ev.rid} admitted twice (lanes "
                              f"{self._admitted[ev.rid]} and {ev.lane})")
            self._queued.discard(ev.rid)
            self._admitted[ev.rid] = ev.lane
            self._lane_rid[ev.lane] = ev.rid
        elif kind == "token":
            self.checks["lane_conservation"] += 1
            lane = self._admitted.get(ev.rid)
            if lane is None:
                self._violate("lane_conservation", ev,
                              f"token for rid {ev.rid} before admission")
            elif ev.lane >= 0 and ev.lane != lane:
                self._violate("lane_conservation", ev,
                              f"token for rid {ev.rid} on lane {ev.lane} "
                              f"but admitted on lane {lane}")
            n = self._tokens.get(ev.rid, 0) + 1
            self._tokens[ev.rid] = n
            d = dict(ev.data)
            self.checks["ttft_exactly_once"] += 1
            if "ttft" in d:
                if ev.rid in self._ttft_seen:
                    self._violate("ttft_exactly_once", ev,
                                  f"rid {ev.rid} emitted a second ttft")
                elif n != 1:
                    self._violate("ttft_exactly_once", ev,
                                  f"rid {ev.rid} stamped ttft on token "
                                  f"{n}, not its first")
                self._ttft_seen.add(ev.rid)
            elif n == 1:
                self._violate("ttft_exactly_once", ev,
                              f"rid {ev.rid} first token has no ttft")
            if self.policy == "commit" and self.boundaries:
                self.checks["walk_floor_monotonic"] += 1
                node = int(d.get("node", -1))
                if node >= 0:
                    m = self._node_model(node)
                    floor = self._floor.get(ev.rid, 0)
                    if m < floor:
                        self._violate(
                            "walk_floor_monotonic", ev,
                            f"rid {ev.rid} served model {m} after "
                            f"committing to model {floor}")
                    elif m > floor:
                        self._floor[ev.rid] = m
        elif kind == "escalate":
            self._esc_open[(ev.rid, ev.model)] = ev.t
        elif kind in _ESC_CLEARS:
            if kind == "finish":
                for key in [k for k in self._esc_open if k[0] == ev.rid]:
                    self._close_escalation(key, ev.t)
                self._finish(ev)
            else:
                key = (ev.rid, ev.model)
                if key in self._esc_open:
                    self._close_escalation(key, ev.t)
        elif kind in ("cancel", "deadline_miss"):
            self._reap(ev)
        elif kind == "rung_stall":
            d = dict(ev.data)
            self.checks["rung_stall_liveness"] += 1
            self._stalls.append((int(ev.model),
                                 float(d.get("t0", ev.t)),
                                 float(d.get("until", ev.t))))
        elif kind == "counter":
            self._counters += 1
            d = dict(ev.data)
            pages = d.get("pages_in_use")
            if pages is not None:
                self.checks["page_conservation"] += 1
                if int(pages) < 0:
                    self._violate("page_conservation", ev,
                                  f"pages_in_use gauge {pages} < 0")
            if (self.pool is not None
                    and self._counters % self.pool_check_every == 0):
                self.checks["page_conservation"] += 1
                for msg in self.pool.check_invariants():
                    self._violate("page_conservation", ev, msg)
        # horizon sweep piggybacks on every event's timestamp — same
        # no-timer-thread idiom as the flight recorder's stuck waiter.
        # An escalation whose window overlaps a scripted rung stall
        # gets the stall's duration as extra allowance; exceeding even
        # that is a DEADLOCKED waiter (the rung-stall contract), while
        # exceeding the plain horizon with no stall in sight stays an
        # escalation-resolves break.
        if self._esc_open:
            key, t0 = min(self._esc_open.items(), key=lambda kv: kv[1])
            allow = self._stall_allowance(key[1], t0, ev.t)
            if ev.t - t0 > self.horizon + allow:
                del self._esc_open[key]
                rid, model = key
                contract = ("rung_stall_liveness" if allow > 0
                            else "escalation_resolves")
                self._violate(
                    contract,
                    Event(ev.t, "escalate", rid, -1, model),
                    f"rid {rid} escalation to model {model} unresolved "
                    f"after {ev.t - t0:.3f}s (horizon {self.horizon}s"
                    f" + stall allowance {allow:.3f}s)")

    def _stall_allowance(self, model: int, t0: float, t1: float) -> float:
        """Scripted stall time of ``model`` inside ``[t0, t1]``."""
        total = 0.0
        for m, s0, s1 in self._stalls:
            if m == model:
                total += max(0.0, min(t1, s1) - max(t0, s0))
        return total

    def _reap(self, ev: Event) -> None:
        """Fold a ``cancel`` / ``deadline_miss`` event: the rid is
        terminal — its open escalations close (the reap freed the deep
        lanes), its lane/queue state drops WITHOUT the finish-path
        violations (a reaped request is legally never finished), and
        with a bound pool the lane must already be page-clean."""
        rid = ev.rid
        self.checks["cancel_halts_stream"] += 1
        self._reaped.add(rid)
        for key in [k for k in self._esc_open if k[0] == rid]:
            del self._esc_open[key]
        self._queued.discard(rid)
        lane = self._admitted.pop(rid, None)
        if lane is not None and self._lane_rid.get(lane) == rid:
            del self._lane_rid[lane]
        self._tokens.pop(rid, None)
        self._ttft_seen.discard(rid)
        self._floor.pop(rid, None)
        if ev.lane >= 0 and self.pool is not None:
            self.checks["cancel_releases_pages"] += 1
            held = int(self.pool.n_held[ev.lane])
            budget = int(self.pool.budget[ev.lane])
            if held or budget:
                self._violate(
                    "cancel_releases_pages", ev,
                    f"rid {rid} reaped off lane {ev.lane} but the lane "
                    f"still holds {held} pages / {budget} budget")

    def _close_escalation(self, key: tuple[int, int], t: float) -> None:
        t0 = self._esc_open.pop(key)
        rid, model = key
        allow = self._stall_allowance(model, t0, t)
        contract = ("rung_stall_liveness" if allow > 0
                    else "escalation_resolves")
        self.checks[contract] += 1
        if t - t0 > self.horizon + allow:
            self._violate(
                contract, Event(t, "esc_resolve", rid, -1, model),
                f"rid {rid} escalation to model {model} resolved only "
                f"after {t - t0:.3f}s (horizon {self.horizon}s"
                f" + stall allowance {allow:.3f}s)")

    def _finish(self, ev: Event) -> None:
        self.checks["lane_conservation"] += 1
        lane = self._admitted.pop(ev.rid, None)
        if lane is None:
            self._violate("lane_conservation", ev,
                          f"finish for rid {ev.rid} never admitted")
        else:
            if ev.lane >= 0 and ev.lane != lane:
                self._violate("lane_conservation", ev,
                              f"rid {ev.rid} finished on lane {ev.lane} "
                              f"but admitted on lane {lane}")
            if self._lane_rid.get(lane) == ev.rid:
                del self._lane_rid[lane]
        self.checks["admission_never_drop"] += 1
        if ev.rid in self._queued:
            self._queued.discard(ev.rid)
            self._violate("admission_never_drop", ev,
                          f"rid {ev.rid} finished while still queued")
        # drop per-rid state: O(live-rids) overall
        self._tokens.pop(ev.rid, None)
        self._ttft_seen.discard(ev.rid)
        self._floor.pop(ev.rid, None)

    # ---------------------------------------------------------- verdicts
    def finalize(self, t_end: float | None = None) -> dict[str, Any]:
        """End-of-serve sweep: unresolved escalations, requests queued
        or admitted but never finished.  Idempotent; returns `report`."""
        if not self.finalized:
            self.finalized = True
            t = self._t_last if t_end is None else float(t_end)
            for (rid, model), t0 in sorted(self._esc_open.items()):
                self.checks["escalation_resolves"] += 1
                self._violate(
                    "escalation_resolves",
                    Event(t, "escalate", rid, -1, model),
                    f"rid {rid} escalation to model {model} never "
                    f"resolved (opened at {t0:.3f}s)")
            self._esc_open.clear()
            for rid in sorted(self._queued):
                self.checks["admission_never_drop"] += 1
                self._violate(
                    "admission_never_drop", Event(t, "queued", rid),
                    f"rid {rid} queued but never admitted at serve end")
            for rid, lane in sorted(self._admitted.items()):
                self.checks["admission_never_drop"] += 1
                self._violate(
                    "admission_never_drop", Event(t, "admitted", rid, lane),
                    f"rid {rid} admitted on lane {lane} but never "
                    f"finished")
            if self.pool is not None:
                self.checks["page_conservation"] += 1
                for msg in self.pool.check_invariants():
                    self._violate("page_conservation",
                                  Event(t, "counter"), msg)
        return self.report()

    def _violate(self, contract: str, ev: Event, msg: str) -> None:
        self.n_violations[contract] += 1
        if len(self.violations) < self.max_violations:
            self.violations.append({
                "contract": contract, "t": float(ev.t),
                "rid": int(ev.rid) if ev.rid >= 0 else None,
                "detail": msg,
            })
        self._freeze(contract, ev, msg)

    def _freeze(self, contract: str, ev: Event, msg: str) -> None:
        """flight_bundle/v1-style dump with the offending rid's full
        span history — the same artifact shape as the flight recorder."""
        if len(self.bundles) >= self.max_bundles:
            return
        tracer = self._tracer
        rid = int(ev.rid) if ev.rid >= 0 else None
        bundle: dict[str, Any] = {
            "schema": "flight_bundle/v1",
            "trigger": f"ledger:{contract}",
            "t": float(ev.t),
            "rid": rid,
            "detail": {"message": msg},
            "events": ([e.as_dict() for e in
                        list(tracer.events)[-self.window:]]
                       if tracer is not None else []),
            "request_span": ([e.as_dict()
                              for e in tracer.request_span(rid)]
                             if tracer is not None and rid is not None
                             else []),
            "span_events_dropped": (tracer.span_dropped(rid)
                                    if tracer is not None and rid is not None
                                    else 0),
        }
        self.bundles.append(bundle)
        if self.out_dir:
            os.makedirs(self.out_dir, exist_ok=True)
            path = os.path.join(
                self.out_dir,
                f"ledger-{contract}-{len(self.bundles)}.json")
            with open(path, "w") as f:
                json.dump(bundle, f, indent=2, default=float)
            self.dump_paths.append(path)

    # ------------------------------------------------------------ report
    @property
    def total_violations(self) -> int:
        return sum(self.n_violations.values())

    @property
    def ok(self) -> bool:
        return self.total_violations == 0

    def report(self, *, unverifiable: bool = False) -> dict[str, Any]:
        contracts = {}
        for c in CONTRACTS:
            if unverifiable:
                verdict = "unverifiable"
            elif self.n_violations[c]:
                verdict = "violated"
            else:
                verdict = "pass"
            contracts[c] = {"checks": self.checks[c],
                            "violations": self.n_violations[c],
                            "verdict": verdict}
        return {
            "schema": "ledger_report/v1",
            "mode": "offline" if unverifiable else "live",
            "events_seen": self.events_seen,
            "finalized": self.finalized,
            "horizon_s": self.horizon,
            "contracts": contracts,
            "violations": list(self.violations),
            "total_violations": self.total_violations,
        }

    def stats(self) -> dict[str, Any]:
        return {"events_seen": self.events_seen,
                "checks": sum(self.checks.values()),
                "violations": self.total_violations,
                "bundles": len(self.bundles)}


def audit_events(events, *, dropped: int = 0,
                 **ledger_kwargs) -> dict[str, Any]:
    """Offline audit of an exported event ring (or `Event` list).

    With ``dropped == 0`` the ring is the complete stream and the
    verdicts are exact — identical to what a live ledger would have
    said.  With ``dropped > 0`` the ring is only a suffix of the true stream:
    a missing admission may simply have been evicted, so every verdict
    degrades to an explicit ``unverifiable`` and any would-be
    violations are reported as ``suspect`` (diagnostic only) rather
    than counted — an honest "cannot audit a truncated ring" instead
    of a false positive.
    """
    ledger = InvariantLedger(**ledger_kwargs)
    for ev in events:
        if not isinstance(ev, Event):
            d = dict(ev)
            data = tuple(sorted(
                (k, v) for k, v in d.items()
                if k not in ("t", "kind", "rid", "lane", "model")))
            ev = Event(float(d["t"]), str(d["kind"]),
                       int(d.get("rid", -1)), int(d.get("lane", -1)),
                       int(d.get("model", -1)), data)
        ledger.observe(ev)
    ledger.finalize()
    if dropped > 0:
        report = ledger.report(unverifiable=True)
        report["events_dropped"] = int(dropped)
        report["suspect"] = report.pop("violations")
        report["violations"] = []
        report["total_violations"] = 0
        for c in report["contracts"].values():
            c["suspect"] = c.pop("violations")
            c["violations"] = 0
        return report
    report = ledger.report()
    report["events_dropped"] = 0
    return report
