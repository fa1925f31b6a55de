"""`StepProbe` — where a wall-clock serve turn's host time goes, and
every host-device transfer of the step path, counted and timed (the
cascade's handoff uploads between rungs are not: the report says so).

The server makes one when a `SpanTracer` rides a serve whose stepper
runs in wall time, hands it to the stepper (`EngineStepper.probe`),
and the stepper hands it to the token step.  Without a tracer there is
no probe, and each site of the step path costs one ``probe is not
None`` check: no clock is read, no CUDA event recorded, no range
opened.

At any instant of a turn the host's time is charged to one PART:

  loop       the server's own work: arrivals, reaping, admission
             (`EngineStepper.admit` included), token bookkeeping,
             lane release
  plan       `EngineStepper.step` before the token step: the chunk
             plan, the pool's step plan, the page ops, the chunk build
  step_host  the token step and the stepper's work after it: the
             host's dispatch of the step
  sync       blocked in a host-device transfer: a gate (`flag`), the
             final reads, an upload; the site does the transfer itself
             between `enter` and `leave`, which counts it
  trace      inside `SpanTracer.emit` (the event built, kept and handed
             to the listeners): the server sets the tracer's ``timer``
             to the probe, so every emit is charged here

`enter` charges the time since the last switch to the current part and
makes another current; `leave` returns to the one before.  So the parts
of a turn sum to the turn, apart from the probe's own clock reads.
`end_turn` gives the turn's record, which the server adds to the turn's
``counter`` event (``turn_s``, ``<part>_s``, ``reads``, ``uploads``,
``upload_bytes``, ``idle_before_s``, and the counts the stepper gives
`count`: ``chunk_graph_replays`` and ``chunk_graph_captures`` where it
graphs its chunk pass), and adds it to ``totals``.  That
``counter`` emit itself falls after the record is taken, outside every
turn.

While a ``torch.profiler`` session records (checked once a turn), the
parts also open ``record_function`` ranges on the profiler's clock:
``tt.turn`` holds ``tt.admit``, ``tt.plan``, ``tt.token_step`` and
``tt.tokens``; ``tt.token_step`` holds a ``tt.segment`` a launched
segment, ``tt.fold``, ``tt.head`` and ``tt.chunk``; ``tt.sync`` wraps
each transfer.  An emit opens none: a chat turn emits about 200 events.

On the card the stepper marks each step's first and last device op
with a CUDA event (`step_start`, `step_end`); the time from the last
step's end to this one's start is the device's idle time between the
two steps (``idle_before_s``), read once the step's final read has
completed both, so it adds no sync.  A step after an idle wait
(`waited`) and the serve's first step have none.  On the ring caches a
stop-the-world admission's prefill runs between two steps and falls in
that gap; a chunked serve runs its prompts inside the step.
"""

from __future__ import annotations

from time import perf_counter as _clock

import torch
from torch.autograd.profiler import record_function

__all__ = ["StepProbe"]

PARTS = ("loop", "plan", "step_host", "sync", "trace")


class StepProbe:
    """A serve's per-turn host-time split and transfer counts."""

    def __init__(self):
        self.totals = {"turns": 0, "turn_s": 0.0,
                       **{f"{p}_s": 0.0 for p in PARTS},
                       "reads": 0, "uploads": 0, "upload_bytes": 0,
                       "idle_before_s": 0.0, "idle_steps": 0}
        self.profiling = False
        self._ranges: list = []       # open record_function ranges
        self._stack: list = []        # (part to return to, range opened)
        self._start = None            # this step's first-op event
        self._end = None              # the last step's last-op event
        self._new_turn()

    # ------------------------------------------------------------ turns
    def begin_turn(self) -> None:
        """The top of a loop turn: what came before belongs to no turn."""
        self.close()
        self._new_turn()
        self.profiling = torch._C._autograd._profiler_enabled()
        self.push("tt.turn")

    def _new_turn(self) -> None:
        self.t0 = self.mark = _clock()
        self.part = "loop"
        self.acc = dict.fromkeys(PARTS, 0.0)
        self.reads = self.uploads = self.upload_bytes = 0
        self.idle = None
        self.counts: dict = {}

    def end_turn(self) -> dict:
        """The turn's record, for its ``counter`` event."""
        t = _clock()
        self.acc[self.part] += t - self.mark
        self.mark = t
        out = {"turn_s": t - self.t0}
        for p in PARTS:
            out[f"{p}_s"] = self.acc[p]
        out.update(reads=self.reads, uploads=self.uploads,
                   upload_bytes=self.upload_bytes, **self.counts)
        if self.idle is not None:
            out["idle_before_s"] = self.idle
            self.totals["idle_steps"] += 1
        tot = self.totals
        tot["turns"] += 1
        for k, v in out.items():
            tot[k] = tot.get(k, 0) + v
        return out

    def close(self) -> None:
        """Close every range still open (a turn that ended in a wait)."""
        while self._ranges:
            self._ranges.pop().__exit__(None, None, None)
        self._stack.clear()

    # ------------------------------------------------------------ parts
    def enter(self, part: str, name: str | None = None) -> None:
        """Make ``part`` current (and open range ``name``) until
        `leave`."""
        t = _clock()
        self.acc[self.part] += t - self.mark
        self.mark = t
        opened = name is not None and self.profiling
        if opened:
            self.push(name)
        self._stack.append((self.part, opened))
        self.part = part

    def leave(self, reads: int = 0, uploads: int = 0,
              nbytes: int = 0) -> None:
        """Return to the part before the last `enter`, counting the
        ``reads`` and ``uploads`` (of ``nbytes`` in all) made in it."""
        t = _clock()
        self.acc[self.part] += t - self.mark
        self.mark = t
        self.part, opened = self._stack.pop()
        if opened:
            self.pop()
        self.reads += reads
        self.uploads += uploads
        self.upload_bytes += nbytes

    def push(self, name: str) -> None:
        """Open range ``name`` (while the profiler records)."""
        if self.profiling:
            rf = record_function(name)
            rf.__enter__()
            self._ranges.append(rf)

    def pop(self) -> None:
        if self.profiling:
            self._ranges.pop().__exit__(None, None, None)

    def count(self, **counts: int) -> None:
        """Add named counts to the turn's record (and the totals)."""
        for k, v in counts.items():
            self.counts[k] = self.counts.get(k, 0) + v

    # ------------------------------------------------------------ transfers
    def flag(self, t: torch.Tensor) -> bool:
        """``bool(t)`` of a one-element device tensor, a gate's read: the
        token step binds ``bool`` or this once a step."""
        self.enter("sync", "tt.sync")
        v = bool(t)
        self.leave(reads=1)
        return v

    # ------------------------------------------------------------ device idle
    def step_start(self, device) -> None:
        """Before a step's first device op."""
        if device.type == "cuda":
            self._start = torch.cuda.Event(enable_timing=True)
            self._start.record()

    def step_end(self, device) -> None:
        """After a step's final read: its events are complete."""
        if device.type != "cuda":
            return
        if self._end is not None and self._start is not None:
            gap = self._end.elapsed_time(self._start) / 1e3
            self.idle = gap if self.idle is None else self.idle + gap
        self._end = torch.cuda.Event(enable_timing=True)
        self._end.record()
        self._start = None

    def waited(self) -> None:
        """The server waited for work: the next step has no idle gap."""
        self._end = None
