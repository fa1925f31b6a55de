"""Stepper (`serving/runtime/scheduler.py`): the mean host time of the
window's steps that carried a prefill chunk (their total over their
count), from the tracer's events."""

from ttbench.lib.layer import window_steps


def read(run):
    steps = [dt for dt, chunk in window_steps(run) if chunk]
    return 1e3 * sum(steps) / len(steps) if steps else None
