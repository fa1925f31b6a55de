"""Device: the mean time the card sat idle between the last op of one
step and the first op of the next (two CUDA events a step), over the
window's steps that followed a step with no wait between.  The
``idle_before_s`` field of the tracer's ``counter`` events; on the card
only."""


def read(run):
    vals = [d["idle_before_s"] for t, kind, _, _, d in run.events or ()
            if kind == "counter" and t <= run.seconds
            and "idle_before_s" in d]
    return 1e3 * sum(vals) / len(vals) if vals else None
