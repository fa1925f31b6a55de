"""Serving metrics for the continuous-batching runtime (DESIGN.md §7).

Definitions (all timestamps come from the server's clock — wall seconds
in engine mode, virtual units in simulation mode):

  * **TTFT** — first emitted token minus ARRIVAL (queue wait included;
    that is the quantity admission policy actually moves).
  * **token latency** — inter-token gap between consecutive emissions of
    one request; p50/p95/p99 are over all gaps of all requests.
  * **throughput** — emitted tokens (and completed requests) per unit
    time over the serve window.
  * **goodput** — emitted tokens/sec counting only requests that met the
    SLO (``ttft <= slo``); the difference to raw throughput is work the
    server did without serving anyone acceptably.
  * **segments saved** — both of the engine's accountings, in one unit
    each: *batch*-level (segment launches skipped because every lane had
    exited) and *lane*-level (per-lane probes skipped — what a
    lane-granular dispatch would save), both relative to full depth.

`summary()` returns a plain dict; `to_json()` dumps summary + per-request
records, which is what the bench trajectory and the CI artifact store.
"""

from __future__ import annotations

import collections
import dataclasses
import json

import numpy as np

__all__ = ["RequestRecord", "RuntimeMetrics", "SlidingWindow"]


@dataclasses.dataclass
class RequestRecord:
    rid: int
    arrival: float
    admitted: float | None = None
    first_token: float | None = None
    finished: float | None = None
    n_tokens: int = 0
    served_depth_sum: int = 0       # sum over tokens of served node idx
    strategy: str | None = None
    tokens: list = dataclasses.field(default_factory=list)  # emitted ids
    status: str = "active"          # -> completed | cancelled | timed_out
    deadline: float | None = None   # absolute deadline, if any
    ended: float | None = None      # terminal timestamp (any status)
    _last_token: float | None = None

    @property
    def ttft(self) -> float | None:
        return None if self.first_token is None \
            else self.first_token - self.arrival

    @property
    def e2e(self) -> float | None:
        return None if self.finished is None \
            else self.finished - self.arrival

    def as_dict(self) -> dict:
        return {
            "rid": self.rid, "arrival": self.arrival,
            "admitted": self.admitted, "first_token": self.first_token,
            "finished": self.finished, "n_tokens": self.n_tokens,
            "ttft": self.ttft, "e2e": self.e2e,
            "mean_served_node": (self.served_depth_sum / self.n_tokens
                                 if self.n_tokens else None),
            "strategy": self.strategy,
            "status": self.status,
            "deadline": self.deadline,
            "tokens": list(self.tokens),
        }


def _pct(vals, qs=(50, 95, 99)) -> dict:
    if not len(vals):
        return {f"p{q}": None for q in qs}
    arr = np.asarray(vals, np.float64)
    return {f"p{q}": float(np.percentile(arr, q)) for q in qs}


class SlidingWindow:
    """Bounded time-indexed sample ring for streaming percentiles.

    Holds ``(t, value)`` pairs; reads prune everything older than the
    trailing ``span``, and the deque's ``maxlen`` caps memory no matter
    how long the serve runs — the unbounded-growth fix the control
    plane's telemetry needs.  Semantics are EXPLICIT at the edges:

      * empty window  -> ``percentiles`` returns all-None, ``values``
        returns ``[]`` (callers must not read a rate out of nothing);
      * one sample    -> every percentile IS that sample (no
        interpolation against phantom data).
    """

    def __init__(self, span: float, maxlen: int = 4096):
        if not span > 0:
            raise ValueError(f"window span must be > 0, got {span}")
        self.span = float(span)
        self._buf: collections.deque = collections.deque(
            maxlen=int(maxlen))

    def __len__(self) -> int:
        return len(self._buf)

    def push(self, t: float, value) -> None:
        self._buf.append((float(t), value))

    def prune(self, now: float) -> None:
        lo = float(now) - self.span
        while self._buf and self._buf[0][0] < lo:
            self._buf.popleft()

    def items(self, now: float) -> list:
        self.prune(now)
        return list(self._buf)

    def values(self, now: float) -> list:
        return [v for _, v in self.items(now)]

    def percentiles(self, now: float, qs=(50, 95, 99)) -> dict:
        vals = self.values(now)
        if not vals:
            return {f"p{q}": None for q in qs}
        if len(vals) == 1:
            v = float(vals[0])
            return {f"p{q}": v for q in qs}
        return _pct(vals, qs)


class RuntimeMetrics:
    """Accumulates per-request + per-step records during a serve run."""

    def __init__(self, full_depth: int, n_lanes: int,
                 window: float | None = None, window_samples: int = 4096):
        self.full_depth = int(full_depth)   # segments (sim: nodes)/token
        self.n_lanes = int(n_lanes)
        self.records: dict[int, RequestRecord] = {}
        self.itl: list[float] = []          # inter-token gaps
        self.steps = 0
        self.seg_batch = 0                  # launched segment count
        self.seg_policy = 0                 # per-lane probed count
        self.lane_steps = 0                 # occupied lane-tokens
        self.served_nodes = collections.Counter()   # node -> tokens
        self.t_start: float = 0.0
        self.t_end: float = 0.0
        self.window: float | None = None
        self._win_ttft: SlidingWindow | None = None
        self._win_itl: SlidingWindow | None = None
        self._win_tok: SlidingWindow | None = None
        if window is not None:
            self.enable_window(window, window_samples)

    def enable_window(self, span: float,
                      window_samples: int = 4096) -> None:
        """Turn on bounded sliding-window accounting (streaming mode).

        Besides the window rings, this BOUNDS the global inter-token-gap
        buffer: a streaming serve can run indefinitely, so ``summary``'s
        token-latency percentiles then cover the most recent samples
        only instead of growing without limit.
        """
        self.window = float(span)
        self._win_ttft = SlidingWindow(span, window_samples)
        self._win_itl = SlidingWindow(span, window_samples)
        # value = (rid, served_node): goodput needs the owning request
        self._win_tok = SlidingWindow(span, window_samples)
        bound = 16 * int(window_samples)
        self.itl = collections.deque(self.itl, maxlen=bound)

    # ------------------------------------------------------------------
    # event hooks (called by the server loop)
    # ------------------------------------------------------------------

    def on_admit(self, req, now: float) -> None:
        self.records[req.rid] = RequestRecord(
            rid=req.rid, arrival=req.arrival, admitted=now,
            strategy=req.strategy, deadline=req.deadline)

    def on_step(self, seg_batch: int, seg_policy: int,
                n_occupied: int) -> None:
        self.steps += 1
        self.seg_batch += int(seg_batch)
        self.seg_policy += int(seg_policy)
        self.lane_steps += int(n_occupied)

    def on_token(self, rid: int, served_node: int, now: float,
                 token: int | None = None) -> None:
        rec = self.records[rid]
        if rec.first_token is None:
            rec.first_token = now
            if self._win_ttft is not None:
                self._win_ttft.push(now, now - rec.arrival)
        else:
            self.itl.append(now - rec._last_token)
            if self._win_itl is not None:
                self._win_itl.push(now, now - rec._last_token)
        rec._last_token = now
        rec.n_tokens += 1
        rec.served_depth_sum += int(served_node)
        self.served_nodes[int(served_node)] += 1
        if self._win_tok is not None:
            self._win_tok.push(now, (rid, int(served_node)))
        if token is not None:
            rec.tokens.append(int(token))

    def on_finish(self, rid: int, now: float) -> None:
        rec = self.records[rid]
        rec.finished = now
        rec.ended = now
        rec.status = "completed"

    def on_reap(self, req, now: float, status: str) -> None:
        """Terminal accounting for a cancelled / timed-out request.

        ``finished`` stays None — a reaped request never completes, so
        it can never enter the goodput numerator or distort TTFT
        percentiles — but the partial-token work it consumed remains in
        its record (and in throughput), which is exactly the gap the
        lossmap's ``cancelled`` cause accounts for.  Queue-reaped
        requests that were never admitted get a record here."""
        if status not in ("cancelled", "timed_out"):
            raise ValueError(f"unknown terminal status {status!r}")
        rec = self.records.get(req.rid)
        if rec is None:
            rec = RequestRecord(
                rid=req.rid, arrival=req.arrival,
                strategy=req.strategy, deadline=req.deadline)
            self.records[req.rid] = rec
        rec.ended = now
        rec.status = status

    # ------------------------------------------------------------------
    # aggregation
    # ------------------------------------------------------------------

    def summary(self, slo: float | None = None) -> dict:
        recs = list(self.records.values())
        done = [r for r in recs if r.finished is not None]
        cancelled = [r for r in recs if r.status == "cancelled"]
        timed_out = [r for r in recs if r.status == "timed_out"]
        duration = max(self.t_end - self.t_start, 1e-9)
        tokens = sum(r.n_tokens for r in recs)
        # TTFT percentiles over non-reaped records only: a request
        # cancelled mid-queue-wait has no first token, and one reaped
        # just after its first token would drag the percentiles toward
        # the reap schedule rather than the scheduler's behavior.
        ttfts = [r.ttft for r in recs
                 if r.ttft is not None and r.status not in
                 ("cancelled", "timed_out")]
        e2es = [r.e2e for r in done]
        # deadline slack: deadline minus terminal time for every
        # terminal record carrying a deadline (negative == missed)
        slack = [r.deadline - r.ended for r in recs
                 if r.deadline is not None and r.ended is not None]

        met_slo = None
        goodput = None
        if slo is not None:
            ok = [r for r in done
                  if r.ttft is not None and r.ttft <= slo]
            met_slo = len(ok) / max(len(done), 1)
            goodput = sum(r.n_tokens for r in ok) / duration

        full_b = self.steps * self.full_depth
        full_l = self.lane_steps * self.full_depth
        return {
            "duration": duration,
            "requests": len(recs),
            "completed": len(done),
            "cancelled": len(cancelled),
            "timed_out": len(timed_out),
            "deadline_slack": (_pct(slack) if slack else None),
            "tokens": tokens,
            "throughput_tok_s": tokens / duration,
            "throughput_req_s": len(done) / duration,
            "ttft": _pct(ttfts),
            "token_latency": _pct(self.itl),
            "e2e_latency": _pct(e2es, qs=(50, 95)),
            "slo": slo,
            "slo_attainment": met_slo,
            "goodput_tok_s": goodput,
            "steps": self.steps,
            "segments_saved_batch": (1.0 - self.seg_batch / full_b
                                     if full_b else None),
            "segments_saved_lane": (1.0 - self.seg_policy / full_l
                                    if full_l else None),
            "mean_served_node": (sum(r.served_depth_sum for r in recs)
                                 / tokens if tokens else None),
        }

    def window_summary(self, now: float, slo: float | None = None) -> dict:
        """Trailing-window estimates over the bounded rings.

        Explicit edge semantics: an EMPTY window reports zero
        throughput/goodput, ``samples == 0``, all-None percentiles and
        a None mean served node — never NaNs, never stale data.  The
        per-window ``goodput_tok_s`` counts window tokens whose owning
        request's TTFT met the SLO — the quantity the control plane's
        gear selection watches.
        """
        if self._win_tok is None:
            raise RuntimeError("sliding window disabled — pass window= "
                               "to RuntimeMetrics or call enable_window")
        toks = self._win_tok.values(now)
        span = min(self.window, max(float(now) - self.t_start, 1e-9))
        goodput = None
        if slo is not None:
            ok = 0
            for rid, _node in toks:
                ttft = self.records[rid].ttft
                if ttft is not None and ttft <= slo:
                    ok += 1
            goodput = ok / span
        return {
            "now": float(now),
            "window": self.window,
            "samples": len(toks),
            "throughput_tok_s": len(toks) / span,
            "goodput_tok_s": goodput,
            "mean_served_node": (sum(n for _, n in toks) / len(toks)
                                 if toks else None),
            "ttft": self._win_ttft.percentiles(now),
            "token_latency": self._win_itl.percentiles(now),
        }

    def to_json(self, path: str, slo: float | None = None,
                extra: dict | None = None,
                max_records: int | None = 4096) -> dict:
        """Write summary + per-request records; returns the payload.

        ``max_records`` bounds the per-request section so hours-long
        soak runs cannot grow the artifact without bound: the MOST
        RECENT records (by arrival) are kept and the drop is counted
        in ``requests_dropped``.  ``max_records=None`` keeps all.
        """
        recs = sorted(self.records.values(), key=lambda r: r.arrival)
        dropped = 0
        if max_records is not None and len(recs) > max_records:
            dropped = len(recs) - int(max_records)
            recs = recs[dropped:]
        payload = {
            "summary": self.summary(slo),
            "requests": [r.as_dict() for r in recs],
            "requests_dropped": dropped,
        }
        if extra:
            payload.update(extra)
        with open(path, "w") as f:
            json.dump(payload, f, indent=1)
        return payload
