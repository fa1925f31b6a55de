"""Serve loop (`serving/runtime/server.py`): the 95th percentile of the
time from a request's due time to its admission to a lane, over every
request due in the window (one not admitted by the window's end counts
its wait until then).  From the tracer's ``admitted`` events."""

from ttbench.lib.stats import pct


def read(run):
    if not run.events:
        return None
    admitted = {rid: t for t, kind, _, rid, _ in run.events
                if kind == "admitted"}
    waits = [min(admitted.get(r["rid"], run.seconds), run.seconds)
             - r["arrival"] for r in run.reqs]
    return 1e3 * pct(waits, 95) if waits else None
