"""What several per-layer readers share: the window's steps from the
tracer's events and from the step log, and the roofline of a kernel."""

from __future__ import annotations

from ttbench.lib.peaks import F32_FLOP_S, HBM_BYTES_S
from ttbench.lib.trace_read import step_split

__all__ = ["window_steps", "logged_steps", "profile", "roofline"]


def window_steps(run):
    """``[(seconds, carried_chunk)]`` of the steps that ended inside the
    window, from the tracer's events (traced runs only)."""
    if not run.events:
        return []
    evs = [(t, kind, lane) for t, kind, lane, _, _ in run.events]
    return [(dt, chunk) for end, dt, chunk in step_split(evs)
            if end <= run.seconds]


def logged_steps(run):
    """The step log's `Step`s that ended inside the window."""
    return [s for s in run.steps if s.t1 <= run.seconds]


def profile(run):
    """The traced run's profiled phase (a `Run` with ``profile``), or
    None."""
    phase = getattr(run, "phase", None)
    return phase if phase is not None and phase.profile else None


def roofline(run, kernel: str, symbol: str):
    """Percent of the least time the launches of ``kernel`` in the
    profiled span B could take (each launch: the larger of its bytes
    over the HBM rate and its operations over the f32 peak) over the
    device time of the kernels whose name holds ``symbol`` there."""
    phase = profile(run)
    prof = phase.profile if phase else None
    if not prof or "b" not in prof or kernel not in prof["launches"]:
        return None
    cost = prof["launches"][kernel]                 # (launches, 2)
    least = sum(max(b / HBM_BYTES_S, f / F32_FLOP_S) for b, f in cost)
    spent = sum(v for k, v in prof["b"]["by_name"].items() if symbol in k)
    if spent <= 0 or least <= 0:
        return None
    return 100.0 * least / spent
