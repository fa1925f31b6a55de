"""Token step (`serving/engine.py`, `serving/runtime/scheduler.py`): the
mean host time a turn spends blocked in host-device transfers (the
segment, head and chunk gates, the step's final reads, every upload),
over the window's steps.  The ``sync_s`` field of the tracer's
``counter`` events."""


def read(run):
    vals = [d["sync_s"] for t, kind, _, _, d in run.events or ()
            if kind == "counter" and t <= run.seconds and "sync_s" in d]
    return 1e3 * sum(vals) / len(vals) if vals else None
