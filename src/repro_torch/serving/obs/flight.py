"""`FlightRecorder` — anomaly-triggered post-mortem bundles
(DESIGN.md §12).

The recorder rides the tracer's event stream as its listener: it
never adds producers of its own, it just watches the same lifecycle
events and keeps trigger state.  When any trigger fires it freezes a
bundle — the last N ring events, the triggering request's FULL span
history, and a metrics snapshot — so the anomaly arrives with its
causes attached instead of a lone log line.

Triggers (all thresholds constructor-tunable):

  * ``slo_burst``     — ``slo_burst`` consecutive first tokens over
    the TTFT SLO.  One late request is load; a burst is a stall.
  * ``page_exhaustion`` — ``page_burst`` consecutive admission
    attempts refused for lack of KV pages.  Queueing under pressure
    is by design; a refusal *streak* means the pool stopped turning
    over.
  * ``stuck_waiter``  — an escalation waiter older than
    ``stuck_after`` serve-seconds with no grant.  Deep-lane grants
    normally arrive within a few steps; an old waiter is a leaked
    lane or a wedged scheduler.
  * ``gear_thrash``   — ``thrash_count`` gear switches inside
    ``thrash_window`` serve-seconds.  Hysteresis should make switches
    rare; thrash means the controller is chasing noise.
  * ``regret_burst``  — windowed p99 per-request regret above
    ``regret_threshold`` (fed by the `RegretMeter` via `note_regret`,
    not by a span kind).  A calibrated recall serve sits at ~zero
    regret; a sustained burst means the tables have drifted from the
    traffic or a no-recall gear is paying the impossibility tax.  The
    bundle pins the window's worst offender's full span history.

Each trigger kind fires at most ``max_bundles_per_kind`` times per
serve (anomalies tend to repeat every step once entered — one bundle
per failure mode is the useful artifact, a dump storm is not).  For
long soaks that cap is too blunt — it would only ever capture the
first anomaly of each kind across simulated hours — so
``rearm_interval`` re-arms all triggers every N serve-seconds:
bundles stay capped *per window*, and every window gets a fresh
budget.  `reset()` does the same re-arm explicitly.
"""

from __future__ import annotations

import collections
import json
import os
from typing import Any, Callable

from repro_torch.serving.obs.trace import Event, SpanTracer

__all__ = ["FlightRecorder"]


class FlightRecorder:
    def __init__(self, *, window: int = 2048, slo: float | None = None,
                 slo_burst: int = 5, page_burst: int = 3,
                 stuck_after: float = 30.0, thrash_count: int = 6,
                 thrash_window: float = 60.0, out_dir: str | None = None,
                 max_bundles_per_kind: int = 1,
                 rearm_interval: float | None = None,
                 regret_window: int = 64,
                 regret_threshold: float | None = None):
        self.window = int(window)
        self.slo = slo
        self.slo_burst = int(slo_burst)
        self.page_burst = int(page_burst)
        self.stuck_after = float(stuck_after)
        self.thrash_count = int(thrash_count)
        self.thrash_window = float(thrash_window)
        self.out_dir = out_dir
        self.max_bundles_per_kind = int(max_bundles_per_kind)
        self.rearm_interval = (float(rearm_interval)
                               if rearm_interval else None)
        self.regret_window = int(regret_window)
        self.regret_threshold = (float(regret_threshold)
                                 if regret_threshold is not None else None)

        self.bundles: list[dict[str, Any]] = []
        self.dump_paths: list[str] = []
        self._tracer: SpanTracer | None = None
        self._snapshot_fn: Callable[[], dict[str, Any]] | None = None
        self._fired: collections.Counter = collections.Counter()
        self._rearms = 0
        self._window_end: float | None = None

        self._slo_streak = 0
        self._page_streak = 0
        self._waiters: dict[tuple[int, int], float] = {}   # (rid, model) -> t
        self._switch_ts: collections.deque[float] = collections.deque()
        # (t, rid, regret) of the last `regret_window` finished requests
        self._regret_recent: collections.deque = collections.deque(
            maxlen=self.regret_window)

    # ---------------------------------------------------------- wiring
    def bind(self, tracer: SpanTracer,
             snapshot_fn: Callable[[], dict[str, Any]] | None = None,
             ) -> None:
        """Attach to a tracer as a listener (chained — the ledger and
        other consumers can ride the same stream).  ``snapshot_fn`` is
        called lazily at dump time for the metrics section."""
        self._tracer = tracer
        self._snapshot_fn = snapshot_fn
        tracer.add_listener(self.observe)

    def reset(self) -> None:
        """Re-arm every trigger: clear streak state and the per-kind
        fired counters.  Captured bundles and dump paths are kept."""
        self._fired.clear()
        self._slo_streak = 0
        self._page_streak = 0
        self._waiters.clear()
        self._switch_ts.clear()
        self._regret_recent.clear()
        self._rearms += 1

    # ---------------------------------------------------------- stream
    def observe(self, ev: Event) -> None:
        if self.rearm_interval is not None:
            if self._window_end is None:
                self._window_end = ev.t + self.rearm_interval
            elif ev.t >= self._window_end:
                self.reset()
                self._window_end = ev.t + self.rearm_interval
        kind = ev.kind
        if kind == "token":
            ttft = dict(ev.data).get("ttft")
            if ttft is not None and self.slo is not None:
                if float(ttft) > self.slo:
                    self._slo_streak += 1
                    if self._slo_streak >= self.slo_burst:
                        self.trigger("slo_burst", ev.t, rid=ev.rid,
                                     detail={"streak": self._slo_streak,
                                             "ttft": float(ttft),
                                             "slo": self.slo})
                else:
                    self._slo_streak = 0
        elif kind == "page_blocked":
            self._page_streak += 1
            if self._page_streak >= self.page_burst:
                self.trigger("page_exhaustion", ev.t, rid=ev.rid,
                             detail={"streak": self._page_streak})
        elif kind == "admitted":
            self._page_streak = 0
        elif kind == "esc_wait":
            self._waiters[(ev.rid, ev.model)] = ev.t
        elif kind in ("esc_grant", "esc_resolve", "finish", "deescalate",
                      "cancel", "deadline_miss"):
            if kind in ("finish", "cancel", "deadline_miss"):
                # terminal for the rid: sweep every model's waiter
                stale = [k for k in self._waiters if k[0] == ev.rid]
            else:
                stale = [(ev.rid, ev.model)]
            for k in stale:
                self._waiters.pop(k, None)
        elif kind == "gear_switch":
            self._switch_ts.append(ev.t)
            while (self._switch_ts and
                   ev.t - self._switch_ts[0] > self.thrash_window):
                self._switch_ts.popleft()
            if len(self._switch_ts) >= self.thrash_count:
                self.trigger("gear_thrash", ev.t,
                             detail={"switches": len(self._switch_ts),
                                     "window_s": self.thrash_window})
        # Stuck-waiter check piggybacks on every event's timestamp —
        # no timer thread, and in sim mode "age" is virtual age.
        if self._waiters:
            oldest = min(self._waiters.items(), key=lambda kv: kv[1])
            (rid, model), t0 = oldest
            if ev.t - t0 > self.stuck_after:
                self._waiters.pop((rid, model), None)
                self.trigger("stuck_waiter", ev.t, rid=rid,
                             detail={"model": model, "waited_s": ev.t - t0})

    def note_regret(self, t: float, rid: int, regret: float) -> None:
        """Fold one finished request's regret in (called by the
        `RegretMeter`, which rides the span stream — regret is not a
        span kind, so this is its own entry point).  Same rearm-window
        semantics as `observe`."""
        if self.regret_threshold is None:
            return
        if self.rearm_interval is not None:
            if self._window_end is None:
                self._window_end = t + self.rearm_interval
            elif t >= self._window_end:
                self.reset()
                self._window_end = t + self.rearm_interval
        self._regret_recent.append((t, int(rid), float(regret)))
        if len(self._regret_recent) < 4:
            return          # too few points for a percentile to mean much
        vals = sorted(r for _, _, r in self._regret_recent)
        p99 = vals[min(len(vals) - 1, int(0.99 * len(vals)))]
        if p99 > self.regret_threshold:
            worst = max(self._regret_recent, key=lambda x: x[2])
            self.trigger("regret_burst", t, rid=worst[1],
                         detail={"p99": p99,
                                 "threshold": self.regret_threshold,
                                 "worst_regret": worst[2],
                                 "window": len(self._regret_recent)})

    # ---------------------------------------------------------- dump
    def trigger(self, kind: str, t: float, *, rid: int | None = None,
                detail: dict[str, Any] | None = None) -> dict | None:
        if self._fired[kind] >= self.max_bundles_per_kind:
            return None
        self._fired[kind] += 1
        tracer = self._tracer
        events = list(tracer.events)[-self.window:] if tracer else []
        bundle: dict[str, Any] = {
            "schema": "flight_bundle/v1",
            "trigger": kind,
            "t": float(t),
            "rid": rid,
            "detail": detail or {},
            "events": [ev.as_dict() for ev in events],
            "request_span": ([ev.as_dict()
                              for ev in tracer.request_span(rid)]
                             if tracer and rid is not None else []),
            "span_events_dropped": (tracer.span_dropped(rid)
                                    if tracer and rid is not None else 0),
        }
        if self._snapshot_fn is not None:
            try:
                bundle["metrics"] = self._snapshot_fn()
            except Exception as e:        # snapshot must never kill a serve
                bundle["metrics"] = {"error": repr(e)}
        self.bundles.append(bundle)
        if self.out_dir:
            os.makedirs(self.out_dir, exist_ok=True)
            # len(bundles) is a monotone sequence — unlike the per-kind
            # fired counter, it never collides across re-arm windows.
            path = os.path.join(
                self.out_dir, f"flight-{kind}-{len(self.bundles)}.json")
            with open(path, "w") as f:
                json.dump(bundle, f, indent=2, default=float)
            self.dump_paths.append(path)
        return bundle

    # ---------------------------------------------------------- stats
    def stats(self) -> dict[str, Any]:
        return {"bundles": len(self.bundles),
                "triggers": dict(self._fired),
                "rearms": self._rearms,
                "pending_waiters": len(self._waiters)}
