"""Goodput-loss attribution from span intervals (DESIGN.md §13).

A roofline prices what the hardware (or the sim's cost model)
could serve; `RuntimeMetrics.summary` reports what actually counted
under the TTFT SLO.  This module decomposes the gap between the two
into CAUSES, read purely off the span stream's timestamps — no new
instrumentation, no device syncs.

Per finished request, the interval from arrival to first token is
partitioned exactly (the buckets sum to TTFT):

  * ``queue_wait``    — queued → first admission attempt that blocked,
    or → admission when never blocked: pure scheduling wait.
  * ``page_blocked``  — first ``page_blocked`` refusal → admission:
    the wait charged to KV-page pressure, not lane scarcity.
  * ``esc_wait`` / ``esc_catchup`` — escalation intervals overlapping
    the pre-first-token window (waiting for a deep lane vs replaying
    the prefix through the deep rung).
  * ``prefill``       — admission → first token, net of escalation
    overlap: prompt prefill sharing the step budget.
  * ``gear_transient``— any of the above reclassified when it overlaps
    a ``gear_transient_s`` window after a ``gear_switch`` (the cost of
    switching, not of the steady state).

Escalation intervals after the first token are tallied into the same
``esc_*`` totals (they stretch streams, not TTFT) but never into the
TTFT partition.

Under the fault plane (DESIGN.md §14) two more causes keep the
partition exact:

  * ``cancelled``     — a reaped request's wait from its last
    lifecycle edge (admission, else arrival) to its ``cancel`` /
    ``deadline_miss`` event; its emitted tokens are charged here
    wholesale in `goodput_lossmap` (they never count as goodput).
  * ``stall``         — any bucket time overlapping a scripted
    ``rung_stall`` window, reclassified the same way gear transients
    are (transient windows take precedence where the two overlap).

`goodput_lossmap` then attributes the tokens of every SLO-missing
request across its TTFT buckets proportionally, prices them per second,
and — when a roofline ceiling is supplied — adds the capacity the serve
never even attempted (``unserved_capacity``).  The result is an
``obs_metrics/v1``-exportable dict `ServeReport.add_lossmap` renders.
"""

from __future__ import annotations

from typing import Any, Iterable

from repro_torch.serving.obs.trace import Event

__all__ = ["stall_decomposition", "goodput_lossmap", "sim_token_ceiling",
           "STALL_CAUSES"]

STALL_CAUSES = ("queue_wait", "page_blocked", "prefill", "esc_wait",
                "esc_catchup", "gear_transient", "cancelled", "stall")


def _merge(windows: list[tuple[float, float]]) -> list[tuple[float, float]]:
    if not windows:
        return []
    windows = sorted(windows)
    out = [windows[0]]
    for s, e in windows[1:]:
        if s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def _overlap(s: float, e: float,
             windows: list[tuple[float, float]]) -> float:
    tot = 0.0
    for ws, we in windows:
        if we <= s:
            continue
        if ws >= e:
            break
        tot += min(e, we) - max(s, ws)
    return tot


def _intersect(a: list[tuple[float, float]],
               b: list[tuple[float, float]]) -> list[tuple[float, float]]:
    """Intersection of two merged window lists (both sorted)."""
    out = []
    for s, e in a:
        for ws, we in b:
            lo, hi = max(s, ws), min(e, we)
            if hi > lo:
                out.append((lo, hi))
    return _merge(out)


def stall_decomposition(events: Iterable[Event], *,
                        gear_transient_s: float = 0.0,
                        ) -> dict[str, Any]:
    """Fold the event stream into per-request TTFT partitions plus
    stream-wide escalation totals.  Returns::

        {"requests": {rid: {"ttft": s, "tokens": n, "finished": bool,
                            "buckets": {cause: s, ...}}},
         "stalls_s": {cause: total s}, "transient_windows": [...]}
    """
    arrival: dict[int, float] = {}
    first_block: dict[int, float] = {}
    admit_t: dict[int, float] = {}
    first_tok: dict[int, float] = {}
    tokens: dict[int, int] = {}
    finished: set[int] = set()
    reap_t: dict[int, float] = {}
    # escalation interval capture: (rid, model) -> [t_esc, t_wait, t_grant]
    esc_open: dict[tuple[int, int], list] = {}
    esc_ivals: dict[int, list[tuple[float, float, str]]] = {}
    switches: list[float] = []
    stall_w: list[tuple[float, float]] = []

    def _close(key: tuple[int, int], t_end: float) -> None:
        t0, tw, tg = esc_open.pop(key)
        rid = key[0]
        ivals = esc_ivals.setdefault(rid, [])
        if tw is not None:
            ivals.append((tw, tg if tg is not None else t_end, "esc_wait"))
        start = tg if tg is not None else (tw if tw is not None else t0)
        if t_end > start:
            ivals.append((start, t_end, "esc_catchup"))

    for ev in events:
        k = ev.kind
        if k == "queued":
            arrival.setdefault(ev.rid, ev.t)
        elif k == "page_blocked":
            first_block.setdefault(ev.rid, ev.t)
        elif k == "admitted":
            admit_t.setdefault(ev.rid, ev.t)
        elif k == "token":
            first_tok.setdefault(ev.rid, ev.t)
            tokens[ev.rid] = tokens.get(ev.rid, 0) + 1
        elif k == "escalate":
            esc_open[(ev.rid, ev.model)] = [ev.t, None, None]
        elif k == "esc_wait":
            st = esc_open.get((ev.rid, ev.model))
            if st is not None and st[1] is None:
                st[1] = ev.t
        elif k == "esc_grant":
            st = esc_open.get((ev.rid, ev.model))
            if st is not None:
                st[2] = ev.t
        elif k in ("esc_resolve", "recall", "deescalate"):
            if (ev.rid, ev.model) in esc_open:
                _close((ev.rid, ev.model), ev.t)
        elif k == "finish":
            finished.add(ev.rid)
            for key in [key for key in esc_open if key[0] == ev.rid]:
                _close(key, ev.t)
        elif k in ("cancel", "deadline_miss"):
            reap_t.setdefault(ev.rid, ev.t)
            for key in [key for key in esc_open if key[0] == ev.rid]:
                _close(key, ev.t)
        elif k == "rung_stall":
            d = dict(ev.data)
            stall_w.append((float(d.get("t0", ev.t)),
                            float(d.get("until", ev.t))))
        elif k == "gear_switch":
            switches.append(ev.t)

    transient = _merge([(t, t + gear_transient_s) for t in switches]) \
        if gear_transient_s > 0 else []
    stall_w = _merge(stall_w)
    # transient windows win where the two overlap (the partition must
    # charge each second exactly once)
    stall_x = _intersect(stall_w, transient)

    requests: dict[int, dict[str, Any]] = {}
    stalls = {c: 0.0 for c in STALL_CAUSES}
    for rid, tq in arrival.items():
        ta = admit_t.get(rid)
        t1 = first_tok.get(rid)
        buckets = {c: 0.0 for c in STALL_CAUSES}
        ivals: list[tuple[float, float, str]] = []
        if ta is not None:
            tb = first_block.get(rid)
            if tb is not None and tq <= tb <= ta:
                ivals.append((tq, tb, "queue_wait"))
                ivals.append((tb, ta, "page_blocked"))
            else:
                ivals.append((tq, ta, "queue_wait"))
            if t1 is not None and t1 > ta:
                # prefill = admit→first-token net of escalation overlap
                esc_in = [(max(s, ta), min(e, t1), c)
                          for s, e, c in esc_ivals.get(rid, ())
                          if e > ta and s < t1]
                esc_s = sum(e - s for s, e, _ in esc_in)
                ivals.extend(esc_in)
                ivals.append((ta, t1, "prefill"))
                buckets["prefill"] -= esc_s   # net out the overlap
        tr = reap_t.get(rid)
        if tr is not None and t1 is None:
            # reaped before its first token: the tail from the last
            # lifecycle edge to the reap is the cancel's cost
            start = ta if ta is not None else tq
            if tr > start:
                ivals.append((start, tr, "cancelled"))
        for s, e, c in ivals:
            dur = max(0.0, e - s)
            hot = _overlap(s, e, transient)
            st = _overlap(s, e, stall_w) - _overlap(s, e, stall_x)
            buckets[c] += dur - hot - st
            buckets["gear_transient"] += hot
            buckets["stall"] += st
        ttft = (t1 - tq) if t1 is not None else None
        requests[rid] = {"ttft": ttft, "tokens": tokens.get(rid, 0),
                         "finished": rid in finished,
                         "reaped": rid in reap_t, "buckets": buckets}
        for c, v in buckets.items():
            stalls[c] += v
        # post-first-token escalation time: stream stretch, not TTFT
        if t1 is not None:
            for s, e, c in esc_ivals.get(rid, ()):
                if e > t1:
                    stalls[c] += e - max(s, t1)
    return {"requests": requests, "stalls_s": stalls,
            "transient_windows": transient, "stall_windows": stall_w}


def sim_token_ceiling(n_lanes: int, seg_time: float, overhead: float,
                      mean_probes: float = 1.0) -> float:
    """The sim cost model's token roofline (lane accounting): every
    lane emits one token per step and a step costs ``overhead +
    seg_time * mean_probes`` virtual seconds — the same identity the
    control plane's `GearPlanner` prices gears with."""
    return n_lanes / (overhead + seg_time * float(mean_probes))


def goodput_lossmap(events: Iterable[Event], *, slo: float,
                    duration: float | None = None,
                    ceiling_tok_s: float | None = None,
                    gear_transient_s: float = 0.0) -> dict[str, Any]:
    """Decompose ``ceiling - goodput`` into attributed causes.

    Tokens of every SLO-missing request are split across its TTFT
    buckets proportionally and priced per second of serve duration;
    ``unserved_capacity`` absorbs the ceiling the serve never attempted
    (only when an explicit roofline ceiling is supplied).
    """
    events = list(events)
    decomp = stall_decomposition(events, gear_transient_s=gear_transient_s)
    if duration is None:
        duration = max((ev.t for ev in events), default=0.0)
    duration = float(duration) or 1.0

    total_tokens = 0
    good_tokens = 0
    missed = 0
    reaped = 0
    loss_tokens = {c: 0.0 for c in STALL_CAUSES}
    for rid, rec in decomp["requests"].items():
        total_tokens += rec["tokens"]
        if rec.get("reaped"):
            # a reaped request's tokens never count as goodput — the
            # answer was abandoned — so they are charged to the cancel
            # wholesale, keeping the partition exact
            reaped += 1
            loss_tokens["cancelled"] += rec["tokens"]
            continue
        ttft = rec["ttft"]
        if ttft is None:
            continue
        if ttft <= slo:
            good_tokens += rec["tokens"]
            continue
        missed += 1
        buckets = rec["buckets"]
        mass = sum(buckets.values())
        if mass <= 0:
            # zero-width partition (e.g. instant admission + token):
            # charge the scheduling bucket so no token goes unattributed
            loss_tokens["queue_wait"] += rec["tokens"]
            continue
        for c, v in buckets.items():
            loss_tokens[c] += rec["tokens"] * (v / mass)

    throughput = total_tokens / duration
    goodput = good_tokens / duration
    loss_rate = {c: v / duration for c, v in loss_tokens.items()}
    ceiling = ceiling_tok_s if ceiling_tok_s is not None else throughput
    if ceiling_tok_s is not None:
        loss_rate["unserved_capacity"] = max(0.0, ceiling - throughput)
    return {
        "schema": "obs_lossmap/v1",
        "slo": float(slo),
        "duration_s": duration,
        "throughput_tok_s": throughput,
        "goodput_tok_s": goodput,
        "ceiling_tok_s": float(ceiling),
        "loss_total_tok_s": max(0.0, ceiling - goodput),
        "loss_tok_s": loss_rate,
        "stalls_s": decomp["stalls_s"],
        "requests_missed": missed,
        "requests_reaped": reaped,
        "requests_total": len(decomp["requests"]),
    }
