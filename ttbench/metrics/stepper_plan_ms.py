"""Stepper (`serving/runtime/scheduler.py`): the mean host time of
`EngineStepper.step` before the token step (the chunk plan, the pool's
step plan, the page ops, the chunk build), less its uploads, over the
window's steps: the ``plan_s`` field of the tracer's ``counter``
events."""


def read(run):
    vals = [d["plan_s"] for t, kind, _, _, d in run.events or ()
            if kind == "counter" and t <= run.seconds and "plan_s" in d]
    return 1e3 * sum(vals) / len(vals) if vals else None
