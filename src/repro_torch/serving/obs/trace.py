"""`SpanTracer` — bounded host-side ring buffer of request lifecycle
events (DESIGN.md §12).

Every event is one `Event` record ``(t, kind, rid, lane, model,
data)`` appended by whichever subsystem observed it; the producers
only ever touch data they already sync to the host once per token
(the served/emitted arrays, the router's slot maps, the pool's page
counters), so an event adds no device work and no host sync, and a
serve with no tracer attached pays nothing beyond ``if tracer is not
None``.

Event kinds (the schema CI validates in `benchmarks/check_trace.py`):

  queued        request entered the queue        (rid)
  admitted      request bound to a lane          (rid, lane)
  prefill_chunk one chunk of prompt prefilled    (rid, lane, width, done)
  token         one decode token served          (rid, lane, node, sid,
                                                  token?, loss?, esc?,
                                                  ttft? on first token)
  escalate      router began an escalation       (rid, model)
  esc_wait      escalation queued for a lane     (rid, model)
  esc_grant     waiter got its deep lane         (rid, model, lane)
  esc_resolve   catch-up done, rung serving      (rid, model)
  recall        deep rung exited at shallow node (rid, model, node)
  deescalate    request stepped back down        (rid, model)
  page_blocked  admission refused: no KV pages   (rid)
  gear_switch   control plane swapped gears      (from, to, names)
  recal         tables re-fit from served rows   (n_rows)
  counter       sampled gauges at a step edge    (queue, pages, ...)
  finish        request completed                (rid, lane)
  cancel        client hung up, request reaped   (rid, lane?)
  deadline_miss deadline expired, request reaped (rid, lane?)
  rung_stall    fault window froze a model rung  (model, t0, until)

Two digests:

  * `span_digest()` hashes the FULL ring — kinds, ids and virtual
    timestamps — so a seeded sim serve pins byte-for-byte (the golden
    value lives in tests, same idiom as the strategy goldens).
  * `decision_digest()` hashes only the per-request decision streams
    (rid → ordered served nodes), which is invariant to arrival
    order and lane placement — the tracer-level mirror of the
    (rid, token)-keyed trace-row property.
"""

from __future__ import annotations

import collections
import hashlib
from dataclasses import dataclass
from typing import Any, Callable, Iterable

__all__ = ["Event", "SpanTracer", "decision_attribution"]


@dataclass(frozen=True, slots=True)
class Event:
    t: float
    kind: str
    rid: int = -1
    lane: int = -1
    model: int = -1
    data: tuple = ()          # sorted (key, value) pairs, hashable

    def as_dict(self) -> dict[str, Any]:
        d = {"t": self.t, "kind": self.kind}
        if self.rid >= 0:
            d["rid"] = self.rid
        if self.lane >= 0:
            d["lane"] = self.lane
        if self.model >= 0:
            d["model"] = self.model
        d.update(self.data)
        return d


class SpanTracer:
    """Bounded ring of `Event`s + per-request live span index.

    ``capacity`` bounds the ring; ``span_events`` bounds any single
    request's indexed span (events past the cap are counted, not
    kept); ``keep_finished`` bounds how many completed spans stay
    addressable for post-mortems and tests.  Everything is O(1)
    amortised per event and strictly host-side.
    """

    def __init__(self, capacity: int = 65536, *, span_events: int = 512,
                 keep_finished: int = 256):
        self.capacity = int(capacity)
        self.events: collections.deque[Event] = collections.deque(
            maxlen=self.capacity)
        self.dropped = 0          # ring evictions
        self.span_events = int(span_events)
        self._live: dict[int, list[Event]] = {}
        self._span_dropped: collections.Counter = collections.Counter()
        self._done: collections.OrderedDict[int, list[Event]] = \
            collections.OrderedDict()
        self.keep_finished = int(keep_finished)
        self._clock: Callable[[], float] | None = None
        self.listener: Callable[[Event], None] | None = None
        self.n_emitted = 0
        # a `StepProbe` the server sets for a wall-clock serve: each
        # emit's time, listeners included, is charged to its trace part
        self.timer = None

    # ---------------------------------------------------------- wiring
    def bind_clock(self, clock: Callable[[], float]) -> None:
        """Events emitted without an explicit ``t`` stamp from here —
        the server binds its own clock (virtual in sim mode, so the
        whole trace is deterministic)."""
        self._clock = clock

    def add_listener(self, fn: Callable[[Event], None]) -> None:
        """Chain ``fn`` onto the listener hook so several consumers
        (flight recorder, invariant ledger, ...) can ride the same
        stream.  Listeners fire in registration order and see every
        emit — including events the bounded ring later evicts."""
        prev = self.listener
        if prev is None:
            self.listener = fn
            return

        def _fan(ev: Event, _a=prev, _b=fn) -> None:
            _a(ev)
            _b(ev)

        self.listener = _fan

    # ---------------------------------------------------------- emit
    def emit(self, kind: str, *, t: float | None = None, rid: int = -1,
             lane: int = -1, model: int = -1, **data: Any) -> None:
        timer = self.timer
        if timer is not None:
            timer.enter("trace")
        if t is None:
            t = self._clock() if self._clock is not None else 0.0
        ev = Event(float(t), kind, int(rid), int(lane), int(model),
                   tuple(sorted(data.items())))
        if len(self.events) == self.capacity:
            self.dropped += 1
        self.events.append(ev)
        self.n_emitted += 1
        if ev.rid >= 0:
            span = self._live.get(ev.rid)
            if span is None:
                span = self._live[ev.rid] = []
            if len(span) < self.span_events:
                span.append(ev)
            else:
                self._span_dropped[ev.rid] += 1
            if kind in ("finish", "cancel", "deadline_miss"):
                self._retire(ev.rid)
        if self.listener is not None:
            self.listener(ev)
        if timer is not None:
            timer.leave()

    def _retire(self, rid: int) -> None:
        span = self._live.pop(rid, None)
        if span is None:
            return
        self._done[rid] = span
        while len(self._done) > self.keep_finished:
            old, _ = self._done.popitem(last=False)
            self._span_dropped.pop(old, None)

    # ---------------------------------------------------------- queries
    def request_span(self, rid: int) -> list[Event]:
        """Full recorded span for ``rid`` — live or recently finished."""
        return list(self._live.get(rid) or self._done.get(rid) or ())

    def span_dropped(self, rid: int) -> int:
        return int(self._span_dropped.get(rid, 0))

    # ---------------------------------------------------------- digests
    @staticmethod
    def _canon(ev: Event) -> str:
        data = ",".join(f"{k}={v!r}" for k, v in ev.data)
        return f"{ev.t!r}|{ev.kind}|{ev.rid}|{ev.lane}|{ev.model}|{data}"

    def span_digest(self) -> str:
        """sha256 over the canonical ring — timestamps included, so a
        seeded virtual-clock serve reproduces this byte-for-byte."""
        h = hashlib.sha256()
        for ev in self.events:
            h.update(self._canon(ev).encode())
            h.update(b"\n")
        return h.hexdigest()

    def decision_digest(self) -> str:
        """sha256 over rid-sorted per-request served-node streams only
        — no timestamps, no lanes — hence invariant to arrival order
        and lane placement for (rid, token)-keyed sim traces."""
        streams: dict[int, list[int]] = {}
        for ev in self.events:
            if ev.kind == "token":
                node = dict(ev.data).get("node", -1)
                streams.setdefault(ev.rid, []).append(int(node))
        h = hashlib.sha256()
        for rid in sorted(streams):
            h.update(f"{rid}:{streams[rid]}".encode())
            h.update(b"\n")
        return h.hexdigest()

    # ---------------------------------------------------------- stats
    def stats(self) -> dict[str, int]:
        return {
            "events": len(self.events),
            "emitted": self.n_emitted,
            "dropped": self.dropped,
            "live_spans": len(self._live),
            "finished_spans": len(self._done),
        }


def decision_attribution(events: Iterable[Event],
                         gear_of: Callable[[int], str] | None = None,
                         ) -> list[dict[str, Any]]:
    """Aggregate token events into decision-attribution rows: for each
    (exit node, gear, escalated) cell, the tokens served there plus
    the latency and served-loss mass that decision produced.  Latency
    contribution is the inter-token gap closed by that token (TTFT for
    the first), read straight off the event stream's timestamps —
    virtual seconds in sim mode, wall seconds in engine mode."""
    cells: dict[tuple, dict[str, Any]] = {}
    last_t: dict[int, float] = {}
    arrival: dict[int, float] = {}
    for ev in events:
        if ev.kind == "queued":
            arrival[ev.rid] = ev.t
            continue
        if ev.kind != "token":
            continue
        d = dict(ev.data)
        node = int(d.get("node", -1))
        sid = int(d.get("sid", -1))
        esc = bool(d.get("esc", False))
        prev = last_t.get(ev.rid, arrival.get(ev.rid, ev.t))
        gap = max(0.0, ev.t - prev)
        last_t[ev.rid] = ev.t
        key = (node, sid, esc)
        cell = cells.get(key)
        if cell is None:
            cell = cells[key] = {
                "node": node,
                "gear": gear_of(sid) if gear_of is not None else str(sid),
                "escalated": esc,
                "tokens": 0,
                "latency_sum_s": 0.0,
                "served_loss_sum": 0.0,
                "_loss_n": 0,
            }
        cell["tokens"] += 1
        cell["latency_sum_s"] += gap
        loss = d.get("loss")
        if loss is not None:
            cell["served_loss_sum"] += float(loss)
            cell["_loss_n"] += 1
    rows = []
    for key in sorted(cells):
        cell = cells[key]
        n_loss = cell.pop("_loss_n")
        cell["latency_sum_s"] = round(cell["latency_sum_s"], 6)
        cell["served_loss_sum"] = round(cell["served_loss_sum"], 6)
        cell["served_loss_mean"] = (
            round(cell["served_loss_sum"] / n_loss, 6) if n_loss else None)
        rows.append(cell)
    return rows
