"""Token step (`serving/engine.py`): the mean host time of the token
step and the stepper's work after it, less the time blocked in syncs:
the host's dispatch of a step, over the window's steps.  The
``step_host_s`` field of the tracer's ``counter`` events."""


def read(run):
    vals = [d["step_host_s"] for t, kind, _, _, d in run.events or ()
            if kind == "counter" and t <= run.seconds
            and "step_host_s" in d]
    return 1e3 * sum(vals) / len(vals) if vals else None
