"""Requests and the admission queue (DESIGN.md §7).

A `Request` is one generation job: a fixed-length prompt bucket, a token
budget, and — the T-Tamer knob the runtime exposes PER REQUEST rather
than per process — an optional strategy name / lambda override that the
scheduler maps onto a member of its strategy bank.

`RequestQueue` orders admission: ``"fifo"`` by arrival time, ``"edf"``
earliest-deadline-first (requests without a deadline sort last).  Both
orderings are fully deterministic — ties break on the request id — which
is what the admission-order-invariance tests lean on.
"""

from __future__ import annotations

import dataclasses
import heapq

import numpy as np

__all__ = ["Request", "RequestQueue"]


@dataclasses.dataclass
class Request:
    """One streaming generation request."""

    rid: int                       # unique id (also the determinism seed)
    prompt: np.ndarray             # (prompt_len,) int32 token bucket
    max_tokens: int                # decode-token budget
    arrival: float = 0.0           # seconds (sim: virtual units) from t=0
    lam: float | None = None       # per-request trade-off (None: server's)
    strategy: str | None = None    # registry name (None: server default)
    deadline: float | None = None  # absolute deadline for EDF ordering
    cancel_at: float | None = None  # client hang-up time (fault plane)

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32)
        if self.prompt.ndim != 1:
            raise ValueError(f"prompt must be 1-D, got {self.prompt.shape}")
        if self.max_tokens < 1:
            raise ValueError("max_tokens must be >= 1")


class RequestQueue:
    """Deterministic admission queue with FIFO or EDF ordering.

    ``deadline_of`` supplies a fallback deadline for EDF when a request
    carries none (e.g. ``arrival + slo``) — evaluated at push time, so
    the requests themselves are never mutated.
    """

    ORDERS = ("fifo", "edf")

    def __init__(self, order: str = "fifo", deadline_of=None):
        if order not in self.ORDERS:
            raise ValueError(f"unknown queue order {order!r}; "
                             f"choose from {self.ORDERS}")
        self.order = order
        self.deadline_of = deadline_of
        self._heap: list = []

    def _key(self, req: Request):
        if self.order == "fifo":
            return (req.arrival, req.rid)
        dl = req.deadline
        if dl is None and self.deadline_of is not None:
            dl = self.deadline_of(req)
        if dl is None:
            dl = float("inf")
        return (dl, req.arrival, req.rid)

    def push(self, req: Request) -> None:
        # rid in the entry keeps the heap total-ordered without ever
        # comparing Request objects
        heapq.heappush(self._heap, (self._key(req), req.rid, req))

    def pop(self) -> Request:
        return heapq.heappop(self._heap)[2]

    def peek(self) -> Request:
        return self._heap[0][2]

    def reap(self, predicate) -> list[Request]:
        """Remove and return every queued request for which
        ``predicate(req)`` is true — the fault plane's pre-admission
        sweep for cancelled / expired requests.  The surviving heap is
        re-heapified, so ordering semantics are untouched."""
        reaped = [req for _, _, req in self._heap if predicate(req)]
        if reaped:
            self._heap = [e for e in self._heap if not predicate(e[2])]
            heapq.heapify(self._heap)
        return reaped

    def requests(self) -> list[Request]:
        """Snapshot of all queued requests (arbitrary order)."""
        return [req for _, _, req in self._heap]

    def __len__(self) -> int:
        return len(self._heap)
