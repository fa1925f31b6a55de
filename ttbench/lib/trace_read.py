"""Readers of the program's tracer events and of a ``torch.profiler``
Chrome trace (``chip_smoke.py``'s ``_step_split``, ``_merged_us`` and
``_chrome_device_stats``, copied and extended)."""

from __future__ import annotations

import collections
import json
import math

__all__ = ["step_split", "merged_us", "load_trace", "annotations",
           "span_stats", "DEVICE_CATS"]

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def step_split(events):
    """Server step times read off the tracer's events ``(t, kind,
    lane)``: a step ends with its ``counter`` event and starts at the
    counter before it, or, when that counter left every lane idle (the
    server then waits for an arrival), at the admission that ends the
    wait.  A step carried a prefill chunk if a ``prefill_chunk`` event
    falls inside it.  Returns ``[(end, seconds, carried_chunk), ...]``
    in step order."""
    out = []
    occ, start, idle, carried = 0, None, True, False
    for t, kind, lane in events:
        if kind == "admitted":
            occ += 1
            if idle:
                start = t
        elif kind in ("finish", "cancel", "deadline_miss"):
            occ -= lane >= 0
            idle = idle or (occ == 0 and kind != "finish")
        elif kind in ("prefill_chunk", "token"):
            idle = False
            carried = carried or kind == "prefill_chunk"
        elif kind == "counter":
            if start is not None:
                out.append((t, t - start, carried))
            start, idle, carried = t, occ == 0, False
    return out


def merged_us(spans) -> float:
    """Microseconds covered by the union of (start, end) spans."""
    total, end = 0.0, -math.inf
    for a, b in sorted(spans):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def _gaps(dev):
    """The idle intervals between the union of device spans."""
    out, end = [], None
    for a, b in sorted(dev):
        if end is not None and a > end:
            out.append((end, a))
        end = b if end is None else max(end, b)
    return out


def load_trace(path) -> list:
    """The complete ("X") events of a Chrome trace."""
    with open(path) as f:
        return [e for e in json.load(f)["traceEvents"]
                if e.get("ph") == "X" and "dur" in e]


def annotations(evs) -> dict:
    """``record_function`` ranges by name: (start, end) in trace us."""
    return {e["name"]: (e["ts"], e["ts"] + e["dur"]) for e in evs
            if str(e.get("cat", "")).lower() == "user_annotation"}


def span_stats(evs, span=None, top: int = 10) -> dict:
    """Of the events inside ``span`` (start, end in trace us; the whole
    trace when None): the span's length, device busy (the union of
    kernels, copies and sets, clipped to the span), the device ops by
    total time, the longest idle gaps named by the innermost host op
    running at their middle, and the device time by op name.  Times in
    seconds."""
    if span is None:
        span = (min(e["ts"] for e in evs),
                max(e["ts"] + e["dur"] for e in evs))
    a0, a1 = span
    dev = [e for e in evs if str(e.get("cat", "")).lower() in DEVICE_CATS
           and a0 <= e["ts"] < a1]
    if not dev:
        raise RuntimeError("profile: the span holds no device event")
    spans = [(e["ts"], min(e["ts"] + e["dur"], a1)) for e in dev]
    busy = merged_us(spans)
    by_name = collections.Counter()
    for e in dev:
        by_name[e["name"]] += e["dur"] / 1e6
    host = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in evs
                  if str(e.get("cat", "")).lower() == "cpu_op"
                  and e["ts"] < a1 and e["ts"] + e["dur"] > a0)
    edges = [(a0, a0)] + sorted(spans) + [(a1, a1)]
    gaps = sorted(_gaps(edges), key=lambda g: g[0] - g[1])[:top]
    named = []
    for a, b in gaps:
        mid, inner = (a + b) / 2, "(no host op)"
        for s, e, name in host:
            if s > mid:
                break
            if e >= mid:
                inner = name          # a later start is a deeper op
        named.append([inner[:120], (b - a) / 1e6])
    return {"window_s": (a1 - a0) / 1e6, "busy_s": busy / 1e6,
            "by_name": dict(by_name),
            "device_ops": [[k[:120], v]
                           for k, v in by_name.most_common(top)],
            "idle_gaps": named}
