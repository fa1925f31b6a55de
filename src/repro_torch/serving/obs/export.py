"""Trace export: `SpanTracer` events → Chrome/Perfetto trace-event
JSON, plus an optional ``torch.profiler`` capture around the serve loop.

Layout in the Perfetto UI:

  * pid 0 "lanes"   — one thread per lane; each request renders as a
    complete ("X") span from admission to finish, with per-token
    decisions ("token", "prefill_chunk") as thread-scoped instants.
  * pid 1 "models"  — one thread per model rung; escalate / esc_wait /
    esc_grant / esc_resolve / recall / deescalate land here as
    instants so ladder traffic reads at a glance.
  * pid 2 "control" — gear_switch / recal / page_blocked instants and
    "C" counter tracks (queue depth, pages in use) sampled at step
    edges.

Timestamps are the serve clock (virtual seconds in sim mode) scaled
to microseconds — Chrome's native unit — so a sim trace is exactly
deterministic and CI can pin its digest.
"""

from __future__ import annotations

import contextlib
import json
import os
from typing import Any, Iterable

from repro_torch.serving.obs.trace import Event

__all__ = ["to_perfetto", "write_trace", "events_doc", "write_events",
           "profiler_capture", "PROFILE_TRACE"]

_LANE_KINDS = {"token", "prefill_chunk", "admitted", "finish",
               "cancel", "deadline_miss"}
_MODEL_KINDS = {"escalate", "esc_wait", "esc_grant", "esc_resolve",
                "recall", "deescalate", "rung_stall"}


def _us(t: float) -> float:
    return round(t * 1e6, 3)


def to_perfetto(events: Iterable[Event], *,
                title: str = "t-tamer serve") -> dict[str, Any]:
    """Build a Chrome trace-event document from tracer events."""
    ev_list = list(events)
    out: list[dict[str, Any]] = []
    lanes: set[int] = set()
    models: set[int] = set()
    # Request spans: admitted -> finish per rid (X events need a dur).
    admit_at: dict[int, tuple[float, int]] = {}
    last_t = 0.0
    for ev in ev_list:
        last_t = max(last_t, ev.t)
        if ev.kind == "admitted" and ev.lane >= 0:
            admit_at[ev.rid] = (ev.t, ev.lane)
        if ev.lane >= 0:
            lanes.add(ev.lane)
        if ev.model >= 0:
            models.add(ev.model)

    for ev in ev_list:
        d = dict(ev.data)
        args: dict[str, Any] = {k: v for k, v in d.items()
                                if isinstance(v, (int, float, str, bool))}
        if ev.rid >= 0:
            args["rid"] = ev.rid
        if ev.kind == "queued":
            # Exact arrival stamp: the instant's ``ts`` is µs-rounded,
            # but replay (obs/replay.py) needs the raw serve-clock float.
            args["t_s"] = ev.t
        if ev.kind in ("finish", "cancel", "deadline_miss"):
            # every terminal kind closes the admit->end request span;
            # a reaped request renders with its terminal kind suffixed
            start = admit_at.pop(ev.rid, None)
            if start is not None:
                t0, lane = start
                name = (f"req {ev.rid}" if ev.kind == "finish"
                        else f"req {ev.rid} ({ev.kind})")
                out.append({"ph": "X", "name": name,
                            "cat": "request", "pid": 0, "tid": lane,
                            "ts": _us(t0), "dur": _us(ev.t - t0),
                            "args": args})
            if ev.kind == "finish":
                continue
            # cancel / deadline_miss keep their instant marker too
        if ev.kind == "counter":
            for k, v in d.items():
                if isinstance(v, (int, float)):
                    out.append({"ph": "C", "name": k, "pid": 2, "tid": 0,
                                "ts": _us(ev.t), "args": {"value": v}})
            continue
        if ev.kind in _MODEL_KINDS:
            pid, tid = 1, max(ev.model, 0)
        elif ev.kind in _LANE_KINDS and ev.lane >= 0:
            pid, tid = 0, ev.lane
        else:                      # queued / page_blocked / control plane
            pid, tid = 2, 0
        out.append({"ph": "i", "s": "t", "name": ev.kind, "cat": "decision",
                    "pid": pid, "tid": tid, "ts": _us(ev.t), "args": args})

    # Unfinished requests still render as spans up to the last event.
    for rid, (t0, lane) in sorted(admit_at.items()):
        out.append({"ph": "X", "name": f"req {rid} (open)",
                    "cat": "request", "pid": 0, "tid": lane,
                    "ts": _us(t0), "dur": _us(max(0.0, last_t - t0)),
                    "args": {"rid": rid, "open": True}})

    meta: list[dict[str, Any]] = []
    for pid, pname in ((0, "lanes"), (1, "models"), (2, "control")):
        meta.append({"ph": "M", "name": "process_name", "pid": pid,
                     "tid": 0, "args": {"name": pname}})
    for lane in sorted(lanes):
        meta.append({"ph": "M", "name": "thread_name", "pid": 0,
                     "tid": lane, "args": {"name": f"lane {lane}"}})
    for m in sorted(models):
        meta.append({"ph": "M", "name": "thread_name", "pid": 1,
                     "tid": m, "args": {"name": f"model {m}"}})
    meta.append({"ph": "M", "name": "thread_name", "pid": 2, "tid": 0,
                 "args": {"name": "control plane"}})

    return {"traceEvents": meta + out,
            "displayTimeUnit": "ms",
            "otherData": {"title": title, "clock": "serve-seconds"}}


def write_trace(tracer, path: str, *, title: str = "t-tamer serve",
                faults=None, regret=None) -> dict[str, Any]:
    doc = to_perfetto(tracer.events, title=title)
    doc["otherData"]["events_dropped"] = tracer.dropped
    doc["otherData"]["span_digest"] = tracer.span_digest()
    doc["otherData"]["decision_digest"] = tracer.decision_digest()
    if faults is not None:
        doc["otherData"]["faults"] = faults.as_doc()
    if regret is not None:
        # the regret meter is a listener, not a producer — its counter
        # track is synthesized here at export time (pid 2, one sample
        # per finished request) so the span stream itself stays
        # bit-identical with the meter on or off
        doc["traceEvents"].extend(
            {"ph": "C", "name": "regret", "pid": 2, "tid": 0,
             "ts": _us(t), "args": {"value": r}}
            for t, r in regret.counter_points())
    with open(path, "w") as f:
        json.dump(doc, f, default=float)
    return doc


def events_doc(tracer, *, faults=None) -> dict[str, Any]:
    """Raw-ring export (schema ``obs_trace/v1``): the lossless
    counterpart to the Perfetto document.  Keeps every event field
    bit-exactly (JSON floats round-trip), plus the two digests and the
    drop count — everything `obs/replay.py` needs to reconstruct the
    workload and verify a re-serve, with no µs rounding in the way.
    ``faults``: an optional `FaultPlan` whose ``faults/v1`` doc is
    embedded so a chaos serve replays under the same script."""
    doc = {
        "schema": "obs_trace/v1",
        "clock": "serve-seconds",
        "events": [ev.as_dict() for ev in tracer.events],
        "events_dropped": tracer.dropped,
        "span_digest": tracer.span_digest(),
        "decision_digest": tracer.decision_digest(),
    }
    if faults is not None:
        doc["faults"] = faults.as_doc()
    return doc


def write_events(tracer, path: str, *, faults=None) -> dict[str, Any]:
    doc = events_doc(tracer, faults=faults)
    with open(path, "w") as f:
        json.dump(doc, f, default=float)
    return doc


PROFILE_TRACE = "profile_trace.json"   # profiler_capture's file in logdir


@contextlib.contextmanager
def profiler_capture(logdir: str | None, device=None):
    """Optional ``torch.profiler`` capture around the serve loop for
    kernel-level attribution: host activity, and device activity when
    ``device`` is a CUDA device.  The Chrome trace lands in
    ``logdir/profile_trace.json``.  A no-op when ``logdir`` is falsy.

    Unlike a capture that degrades to nothing, this one raises when the
    profiler cannot start or write, and when a capture on the card holds
    no device event: a trace that silently records nothing would hide
    the device."""
    if not logdir:
        yield
        return
    import torch

    on_card = device is not None and torch.device(device).type == "cuda"
    acts = [torch.profiler.ProfilerActivity.CPU]
    if on_card:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield
        if on_card:
            torch.cuda.synchronize()
    if on_card and not any(
            e.device_type == torch.autograd.DeviceType.CUDA
            for e in prof.events()):
        raise RuntimeError(f"profiler_capture({logdir!r}): the capture "
                           "holds no device event")
    prof.export_chrome_trace(os.path.join(logdir, PROFILE_TRACE))
