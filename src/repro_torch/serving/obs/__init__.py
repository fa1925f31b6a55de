"""Unified serving observability plane (DESIGN.md §12).

One package threads through every serving subsystem:

  * `trace`    — `SpanTracer`: bounded host-side ring of lifecycle
    events (queued → admitted → prefill chunks → per-token decode →
    escalate/recall/de-escalate → finish), fed only from data the
    steppers already sync once per token.  Zero overhead when absent:
    every producer guards with ``if tracer is not None``.
  * `registry` — `MetricsRegistry`: counters/gauges/histograms with
    labels, absorbing the per-subsystem stats dicts behind one
    ``snapshot()`` / Prometheus-text / JSON surface.
  * `export`   — Chrome/Perfetto trace-event JSON (one track per
    lane, one per model rung, decision instants) + an optional
    ``torch.profiler`` capture around the serve loop.
  * `flight`   — `FlightRecorder`: last-N-events post-mortem bundles
    on anomaly triggers (TTFT-SLO breach burst, page exhaustion,
    stuck escalation waiter, gear thrash).
  * `audit`    — `InvariantLedger`: streaming contracts over the same
    listener hook (page conservation, escalations resolve, lane
    occupancy, walk-floor monotonicity, TTFT-exactly-once, admission
    never drops) with flight-bundle dumps on violation.
  * `replay`   — deterministic re-serve of an exported trace artifact
    with `span_digest` / `decision_digest` equality checks.
  * `lossmap`  — goodput-loss attribution: the achieved-vs-roofline
    gap decomposed into causes from span intervals.
  * `regret`   — `RegretMeter`: per-request distance from the
    offline-optimal walk (the paper's separation theorem as live
    telemetry), decomposed by decision cause, as a pure listener.
  * `pareto`   — `ParetoTracker`: the streaming empirical
    accuracy-latency frontier with per-gear attribution.
  * `report`   — the one serve report renderer (replaces the bespoke
    print blocks `launch/serve.py` used to duplicate).

`Observability` is the small bundle the `Server` accepts.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.serving.obs.audit import InvariantLedger, audit_events
from repro_torch.serving.obs.flight import FlightRecorder
from repro_torch.serving.obs.pareto import ParetoTracker
from repro_torch.serving.obs.regret import RegretMeter, regret_events
from repro_torch.serving.obs.registry import MetricsRegistry
from repro_torch.serving.obs.trace import SpanTracer, decision_attribution

__all__ = [
    "FlightRecorder",
    "InvariantLedger",
    "MetricsRegistry",
    "Observability",
    "ParetoTracker",
    "RegretMeter",
    "SpanTracer",
    "audit_events",
    "decision_attribution",
    "regret_events",
]


@dataclass
class Observability:
    """What a `Server` threads through a serve: a tracer (always, when
    observability is on), an optional flight recorder, invariant
    ledger and regret meter riding the same event stream, and an
    optional ``torch.profiler`` logdir for kernel-level capture around
    the serve loop."""

    tracer: SpanTracer = field(default_factory=SpanTracer)
    flight: FlightRecorder | None = None
    ledger: InvariantLedger | None = None
    regret: RegretMeter | None = None
    profile_dir: str | None = None
