"""Deterministic trace replay (DESIGN.md §13).

Every exported trace artifact is a self-contained repro: the ``queued``
events carry the full request spec (arrival stamp, prompt bytes, token
budget, per-request strategy/lambda), so the workload schedule can be
reconstructed from the artifact alone — no access to the original
workload generator or its seed.  Replaying re-serves that schedule
through the same virtual-clock stepper and asserts both digests:

  * ``span_digest``     — byte-exact event stream (timestamps included),
  * ``decision_digest`` — per-rid served-node streams (arrival-order and
    lane-placement invariant).

Two artifact shapes are accepted:

  * ``obs_trace/v1`` (`export.write_events`) — the lossless raw ring;
    the canonical replay input (floats round-trip through JSON exactly).
  * Chrome/Perfetto trace-event JSON (`export.write_trace`) — queued
    instants carry the same args plus a raw ``t_s`` stamp (the instant's
    own ``ts`` is µs-rounded), and ``otherData`` embeds the reference
    digests.  Span-digest equality additionally needs the raw ring, so
    a Perfetto-only replay verifies the decision digest and reports the
    span digest as unverifiable.

A ring that dropped events (``events_dropped > 0``) cannot be a
faithful workload record — arrivals may have been evicted — so replay
refuses it as ``unverifiable`` rather than reporting a hollow match.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Callable

import numpy as np

from repro_torch.serving.obs.trace import Event, SpanTracer
from repro_torch.serving.runtime.request import Request

__all__ = ["ReplayResult", "load_artifact", "events_from_doc",
           "workload_from_events", "workload_from_perfetto", "replay"]


@dataclasses.dataclass
class ReplayResult:
    ok: bool
    n_requests: int
    span_digest: str | None          # recomputed by the re-serve
    decision_digest: str | None
    ref_span_digest: str | None      # carried by the artifact
    ref_decision_digest: str | None
    mismatches: list[str]

    def summary(self) -> str:
        verdict = "MATCH" if self.ok else "MISMATCH"
        return (f"replay {verdict}: {self.n_requests} requests; "
                + ("; ".join(self.mismatches) if self.mismatches
                   else "span+decision digests equal"))


def _decode_prompt(hexstr: str) -> np.ndarray:
    return np.frombuffer(bytes.fromhex(hexstr), "<u4").astype(np.int32)


def _request_from(rid: int, t: float, d: dict[str, Any]) -> Request:
    if "prompt" in d:
        prompt = _decode_prompt(d["prompt"])
    else:                       # older traces: length only, content zeros
        prompt = np.zeros(int(d.get("plen", 1)), np.int32)
    return Request(rid=int(rid), prompt=prompt,
                   max_tokens=int(d.get("ntok", 1)), arrival=float(t),
                   lam=float(d["lam"]) if "lam" in d else None,
                   strategy=d.get("strategy"),
                   deadline=(float(d["deadline"])
                             if "deadline" in d else None),
                   cancel_at=(float(d["cancel_at"])
                              if "cancel_at" in d else None))


def events_from_doc(doc: dict[str, Any]) -> list[Event]:
    """Rebuild `Event` records from an ``obs_trace/v1`` document."""
    if doc.get("schema") != "obs_trace/v1":
        raise ValueError(f"not an obs_trace/v1 document: "
                         f"{doc.get('schema')!r}")
    out = []
    for d in doc["events"]:
        data = tuple(sorted(
            (k, v) for k, v in d.items()
            if k not in ("t", "kind", "rid", "lane", "model")))
        out.append(Event(float(d["t"]), str(d["kind"]),
                         int(d.get("rid", -1)), int(d.get("lane", -1)),
                         int(d.get("model", -1)), data))
    return out


def workload_from_events(events) -> list[Request]:
    """Reconstruct the workload schedule from queued events."""
    reqs = []
    seen = set()
    for ev in events:
        if ev.kind != "queued" or ev.rid in seen:
            continue
        seen.add(ev.rid)
        reqs.append(_request_from(ev.rid, ev.t, dict(ev.data)))
    return sorted(reqs, key=lambda r: (r.arrival, r.rid))


def workload_from_perfetto(doc: dict[str, Any]) -> list[Request]:
    """Reconstruct the workload from a Perfetto export's queued
    instants (their args carry the request spec + raw ``t_s``)."""
    reqs = []
    seen = set()
    for row in doc.get("traceEvents", ()):
        if row.get("ph") != "i" or row.get("name") != "queued":
            continue
        args = row.get("args", {})
        rid = int(args.get("rid", -1))
        if rid < 0 or rid in seen:
            continue
        seen.add(rid)
        t = float(args.get("t_s", row.get("ts", 0.0) / 1e6))
        reqs.append(_request_from(rid, t, args))
    return sorted(reqs, key=lambda r: (r.arrival, r.rid))


def load_artifact(path_or_doc) -> dict[str, Any]:
    if isinstance(path_or_doc, str):
        with open(path_or_doc) as f:
            return json.load(f)
    return path_or_doc


def replay(artifact, serve_fn: Callable[[list[Request]], Any],
           ) -> ReplayResult:
    """Re-serve an exported trace artifact and verify the digests.

    ``serve_fn(requests)`` must run the serve (same stepper config,
    strategy bank and seeds as the original — that is the caller's
    contract) and return the `SpanTracer` that observed it (an
    `Observability` bundle or a ``.tracer``-bearing object also works).
    """
    doc = load_artifact(artifact)
    mismatches: list[str] = []

    if doc.get("schema") == "obs_trace/v1":
        dropped = int(doc.get("events_dropped", 0))
        requests = workload_from_events(events_from_doc(doc))
        ref_span = doc.get("span_digest")
        ref_dec = doc.get("decision_digest")
    elif "traceEvents" in doc:
        other = doc.get("otherData", {})
        dropped = int(other.get("events_dropped", 0))
        requests = workload_from_perfetto(doc)
        ref_span = None          # µs rounding: span digest not carried
        ref_dec = other.get("decision_digest")
        if other.get("span_digest") and ref_dec is None:
            mismatches.append("perfetto artifact carries no "
                              "decision_digest")
    else:
        raise ValueError("unrecognized trace artifact (expected "
                         "obs_trace/v1 or Perfetto traceEvents)")

    if dropped > 0:
        return ReplayResult(
            ok=False, n_requests=len(requests), span_digest=None,
            decision_digest=None, ref_span_digest=ref_span,
            ref_decision_digest=ref_dec,
            mismatches=[f"unverifiable: source ring dropped {dropped} "
                        "events — the workload record is incomplete"])

    served = serve_fn(requests)
    tracer = getattr(served, "tracer", served)
    if not isinstance(tracer, SpanTracer):
        raise TypeError("serve_fn must return the SpanTracer that "
                        "observed the re-serve (or an object with a "
                        ".tracer)")
    span = tracer.span_digest()
    dec = tracer.decision_digest()
    if ref_span is not None and span != ref_span:
        mismatches.append(f"span digest {span[:12]}… != "
                          f"reference {ref_span[:12]}…")
    if ref_dec is not None and dec != ref_dec:
        mismatches.append(f"decision digest {dec[:12]}… != "
                          f"reference {ref_dec[:12]}…")
    if ref_span is None and ref_dec is None:
        mismatches.append("artifact carries no reference digests")
    return ReplayResult(ok=not mismatches, n_requests=len(requests),
                        span_digest=span, decision_digest=dec,
                        ref_span_digest=ref_span,
                        ref_decision_digest=ref_dec,
                        mismatches=mismatches)
