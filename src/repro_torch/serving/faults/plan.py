"""`FaultPlan` — a deterministic chaos script for a serve.

A plan is a pure value: which rids cancel and when, which rids carry
deadlines, which model rungs freeze over which virtual-time windows,
and how many KV pages a pressure event steals over which windows.
Everything is derived from a seed with `numpy.random.default_rng`, so
the same (seed, workload) pair always produces the same plan, and a
planned serve replays bit-identically — faults are part of the
workload, not noise on top of it.

Request-borne faults (`cancel_at`, `deadline`) are *stamped onto the
requests* with `stamp()` before the serve starts.  Serve-borne faults
(rung stalls, page squeezes) are read off the plan by the stepper/pool
at each step's `now`.

Schema: `as_doc()` / `from_doc()` round-trip the plan as the JAX
package's ``faults/v1`` JSON block (`save` / `load`, the launcher's
``--faults PLAN.json``).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Iterable, Sequence

import numpy as np

__all__ = ["FaultPlan"]


class FaultPlan:
    """Seeded script of faults to inject into one serve.

    ``cancel_at`` / ``deadline`` map rid → absolute virtual time.
    ``stalls`` is a list of ``(model, t0, t1)`` windows during which
    every lane of that model rung is frozen.  ``squeezes`` is a list of
    ``(t0, t1, pages)`` windows during which ``pages`` KV pages are
    withheld from the pool's free headroom.
    """

    def __init__(self, *, seed: int = 0,
                 cancel_at: dict[int, float] | None = None,
                 deadline: dict[int, float] | None = None,
                 stalls: Iterable[Sequence] = (),
                 squeezes: Iterable[Sequence] = ()):
        self.seed = int(seed)
        self.cancel_at = {int(k): float(v)
                          for k, v in (cancel_at or {}).items()}
        self.deadline = {int(k): float(v)
                         for k, v in (deadline or {}).items()}
        self.stalls = [(int(m), float(t0), float(t1))
                       for m, t0, t1 in stalls]
        self.squeezes = [(float(t0), float(t1), int(p))
                         for t0, t1, p in squeezes]

    # --------------------------------------------------------- generate
    @classmethod
    def generate(cls, requests, *, seed: int,
                 cancel_rate: float = 0.0,
                 cancel_after: tuple[float, float] = (0.5, 4.0),
                 deadline=None,
                 stalls: Iterable[Sequence] = (),
                 squeezes: Iterable[Sequence] = ()) -> "FaultPlan":
        """Draw a plan for ``requests`` from ``seed``.

        ``cancel_rate`` is the per-request probability of a client
        hang-up, landing ``cancel_after`` ~ U(lo, hi) seconds after
        arrival.  ``deadline`` is either a scalar (every request gets
        ``arrival + deadline``) or a ``(lo, hi)`` window drawn
        uniformly per request.  ``stalls`` / ``squeezes`` pass through
        verbatim — they are serve-time windows, not per-request draws.
        """
        rng = np.random.default_rng(seed)
        cancel_at: dict[int, float] = {}
        deadlines: dict[int, float] = {}
        for req in requests:
            if cancel_rate > 0.0 and rng.random() < cancel_rate:
                lo, hi = cancel_after
                cancel_at[req.rid] = float(req.arrival
                                           + rng.uniform(lo, hi))
            if deadline is not None:
                if isinstance(deadline, (tuple, list)):
                    lo, hi = deadline
                    deadlines[req.rid] = float(req.arrival
                                               + rng.uniform(lo, hi))
                else:
                    deadlines[req.rid] = float(req.arrival
                                               + float(deadline))
        return cls(seed=seed, cancel_at=cancel_at, deadline=deadlines,
                   stalls=stalls, squeezes=squeezes)

    # ------------------------------------------------------------ stamp
    def stamp(self, requests) -> list:
        """Return new `Request` objects with the plan's request-borne
        faults written onto them.  Requests the plan does not touch are
        returned unchanged (same object)."""
        out = []
        for req in requests:
            ca = self.cancel_at.get(req.rid)
            dl = self.deadline.get(req.rid)
            if ca is None and dl is None:
                out.append(req)
                continue
            changes: dict[str, Any] = {}
            if ca is not None:
                changes["cancel_at"] = ca
            if dl is not None:
                changes["deadline"] = dl
            out.append(dataclasses.replace(req, **changes))
        return out

    # ---------------------------------------------------- serve queries
    def stall_active(self, model: int, t: float) -> bool:
        return any(m == model and t0 <= t < t1
                   for m, t0, t1 in self.stalls)

    def stall_window(self, model: int, t: float):
        """The ``(t0, t1)`` stall window covering ``t`` for ``model``,
        or None."""
        for m, t0, t1 in self.stalls:
            if m == model and t0 <= t < t1:
                return (t0, t1)
        return None

    def stall_overlap(self, model: int, t0: float, t1: float) -> float:
        """Total stall time for ``model`` inside ``[t0, t1]`` — the
        liveness allowance of an escalation targeting a frozen rung."""
        total = 0.0
        for m, s0, s1 in self.stalls:
            if m == model:
                total += max(0.0, min(t1, s1) - max(t0, s0))
        return total

    def squeeze_pages(self, t: float) -> int:
        return sum(p for t0, t1, p in self.squeezes if t0 <= t < t1)

    def next_change(self, t: float) -> float | None:
        """Earliest scripted boundary strictly after ``t`` — the wake
        time for a serve loop that would otherwise deadlock waiting for
        a stall or squeeze window to pass."""
        edges = [e for _, t0, t1 in self.stalls for e in (t0, t1)
                 if e > t]
        edges += [e for t0, t1, _ in self.squeezes for e in (t0, t1)
                  if e > t]
        return min(edges) if edges else None

    # ----------------------------------------------------------- schema
    def as_doc(self) -> dict[str, Any]:
        return {
            "schema": "faults/v1",
            "seed": self.seed,
            "cancel_at": {str(k): v
                          for k, v in sorted(self.cancel_at.items())},
            "deadline": {str(k): v
                         for k, v in sorted(self.deadline.items())},
            "stalls": [list(w) for w in self.stalls],
            "squeezes": [list(w) for w in self.squeezes],
        }

    @classmethod
    def from_doc(cls, doc: dict[str, Any]) -> "FaultPlan":
        if doc.get("schema") != "faults/v1":
            raise ValueError(
                f"not a faults/v1 doc: {doc.get('schema')!r}")
        return cls(
            seed=doc.get("seed", 0),
            cancel_at={int(k): float(v)
                       for k, v in doc.get("cancel_at", {}).items()},
            deadline={int(k): float(v)
                      for k, v in doc.get("deadline", {}).items()},
            stalls=doc.get("stalls", ()),
            squeezes=doc.get("squeezes", ()),
        )

    @classmethod
    def load(cls, path: str) -> "FaultPlan":
        with open(path) as f:
            return cls.from_doc(json.load(f))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.as_doc(), f, indent=2)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"FaultPlan(seed={self.seed}, "
                f"cancels={len(self.cancel_at)}, "
                f"deadlines={len(self.deadline)}, "
                f"stalls={len(self.stalls)}, "
                f"squeezes={len(self.squeezes)})")
