"""The continuous-batching serve loop.

Data flow per iteration:

    workload arrivals -> RequestQueue -> LaneScheduler.admit
        -> stepper.admit (page allocation + prefill cursor)
        -> stepper.step  (one token for every decoding lane, one
                          prefill chunk for the admitting lanes)
        -> metrics.on_token / lane recycling on completion

Time is wall time.  The JAX package's observability, control and fault
planes and its model-free simulation stepper are not part of the port
yet.
"""

from __future__ import annotations

import time

import numpy as np

from repro_torch.serving.runtime.metrics import RuntimeMetrics
from repro_torch.serving.runtime.request import RequestQueue
from repro_torch.serving.runtime.scheduler import LaneScheduler

__all__ = ["Server", "build_bank"]


def build_bank(requests, make_strategy, default: tuple):
    """Resolve the distinct per-request ``(strategy, lam)`` pairs into a
    static strategy bank.

    Returns ``(strategies, sid_of)`` — the tuple the token step runs
    over and the lane->member resolver the scheduler stamps on each
    admission.  ``make_strategy(name, lam)`` builds one member;
    ``default`` fills a request's missing fields (the launcher's
    factory is `repro_torch.launch.serve.build_strategy` with its
    knobs).
    """
    def key_of(req):
        return (req.strategy or default[0],
                req.lam if req.lam is not None else default[1])

    keys: list = []
    for req in sorted(requests, key=lambda r: r.rid):
        k = key_of(req)
        if k not in keys:
            keys.append(k)
    if not keys:
        keys = [default]
    strategies = tuple(make_strategy(name, lam) for name, lam in keys)
    index = {k: i for i, k in enumerate(keys)}
    return strategies, lambda req: index[key_of(req)]


class Server:
    """Open-loop continuous-batching server over an `EngineStepper`."""

    def __init__(self, stepper, scheduler: LaneScheduler, sid_of):
        self.stepper = stepper
        self.scheduler = scheduler
        self.sid_of = sid_of
        self._t0 = 0.0

    def _now(self) -> float:
        return time.perf_counter() - self._t0

    def serve(self, requests) -> RuntimeMetrics:
        """Run the full open-loop session: admit every request at its
        arrival time (first come, first served), decode until all
        streams drain, return metrics.  The stepper runs once before
        the serving clock starts, so latency percentiles do not count
        kernel builds."""
        sched = self.scheduler
        stepper = self.stepper
        stepper.warmup()
        metrics = RuntimeMetrics(stepper.full_depth, sched.n_lanes)
        queue = RequestQueue("fifo")
        pending = sorted(requests, key=lambda r: (r.arrival, r.rid))
        self._t0 = time.perf_counter()
        metrics.t_start = self._now()

        while pending or len(queue) or sched.busy():
            now = self._now()
            while pending and pending[0].arrival <= now:
                queue.push(pending.pop(0))
            for lane, req in sched.admit(queue, self.sid_of,
                                         can_admit=stepper.reserve):
                stepper.admit(lane, req)
                metrics.on_admit(req, self._now())
            if not sched.busy():
                if not pending:
                    if len(queue):
                        raise RuntimeError(
                            "admission deadlock: queued requests but no "
                            "lane busy and no pending arrivals")
                    break
                # every lane idle: sleep to the next arrival
                gap = pending[0].arrival - self._now()
                if gap > 0:
                    time.sleep(gap)
                continue

            emitted, served, sb, sp, emit = stepper.step(
                sched.occupied_mask(), sched.sid)
            tnow = self._now()
            # emit marks lanes whose entry is a real token this step;
            # lanes mid-prefill are occupied but still silent
            metrics.on_step(sb, sp, int(np.asarray(emit).sum()))
            for lane in np.flatnonzero(emit):
                req = sched.lane_req[lane]
                metrics.on_token(req.rid, int(served[lane]), tnow,
                                 token=int(emitted[lane]))
                if sched.consume_token(lane):
                    metrics.on_finish(req.rid, tnow)
                    stepper.release(lane)   # pages back to the pool
                    sched.release(lane)

        metrics.t_end = self._now()
        return metrics
