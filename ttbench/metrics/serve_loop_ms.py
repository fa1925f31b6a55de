"""Serve loop (`serving/runtime/server.py`): the mean host time of a
turn's own work (arrivals, reaping, admission, token bookkeeping, lane
release), over the window's turns that ran a step: the ``loop_s`` field
of the tracer's ``counter`` events (`serving/obs/probe.py`)."""


def read(run):
    vals = [d["loop_s"] for t, kind, _, _, d in run.events or ()
            if kind == "counter" and t <= run.seconds and "loop_s" in d]
    return 1e3 * sum(vals) / len(vals) if vals else None
