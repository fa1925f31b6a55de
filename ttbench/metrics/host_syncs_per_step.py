"""Token step (`serving/engine.py`, `serving/runtime/scheduler.py`): the
mean number of host-device transfers a turn makes, each of which blocks
the host (reads: the gates and the final reads; uploads: every
`EngineStepper._dev`), over the window's steps.  The ``reads`` and
``uploads`` fields of the tracer's ``counter`` events."""


def read(run):
    vals = [d["reads"] + d["uploads"] for t, kind, _, _, d in run.events
            or () if kind == "counter" and t <= run.seconds
            and "reads" in d]
    return sum(vals) / len(vals) if vals else None
