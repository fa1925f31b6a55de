"""`ParetoTracker` — the streaming empirical accuracy-latency frontier
(DESIGN.md §15).

Every finished request is one point ``(latency, served-loss)``; the
tracker keeps the non-dominated set (lower latency AND lower loss)
incrementally, with per-gear attribution so an adaptive serve shows
WHICH gear produced each frontier point.  The offline Pareto sweeps
(`benchmarks.bench_runtime`) compare whole configurations; this is the
same axis pair measured live, per request, inside one serve.

Dominance is minimize-both: point q dominates p when ``q.latency <=
p.latency`` and ``q.loss <= p.loss`` (exact ties count as dominated,
first-come-wins, so the frontier stays small under identical sim
points).  Each ``add`` is O(frontier), which stays tiny in practice —
frontiers over thousands of serve points hold a few dozen entries.

`as_doc` exports the ``obs_pareto/v1`` schema `benchmarks.check_trace
--pareto` validates.
"""

from __future__ import annotations

from typing import Any

__all__ = ["ParetoTracker"]


class ParetoTracker:
    """Incremental non-dominated (latency, served-loss) set."""

    def __init__(self) -> None:
        self.n_points = 0
        self.by_gear: dict[str, int] = {}       # gear -> points seen
        self._frontier: list[dict[str, Any]] = []   # sorted by latency

    def add(self, rid: int, latency_s: float, loss: float,
            gear: str = "fixed") -> bool:
        """Fold one finished request in; True if it joined the frontier."""
        self.n_points += 1
        self.by_gear[gear] = self.by_gear.get(gear, 0) + 1
        lat, loss = float(latency_s), float(loss)
        for q in self._frontier:
            if q["latency_s"] <= lat and q["loss"] <= loss:
                return False            # dominated (ties lose too)
        self._frontier = [
            q for q in self._frontier
            if not (lat <= q["latency_s"] and loss <= q["loss"])]
        self._frontier.append({"rid": int(rid), "latency_s": lat,
                               "loss": loss, "gear": gear})
        self._frontier.sort(key=lambda q: (q["latency_s"], q["loss"]))
        return True

    @property
    def frontier(self) -> list[dict[str, Any]]:
        return list(self._frontier)

    def as_doc(self) -> dict[str, Any]:
        by_gear = {}
        for gear, n in sorted(self.by_gear.items()):
            by_gear[gear] = {
                "points": n,
                "frontier": sum(1 for q in self._frontier
                                if q["gear"] == gear)}
        return {
            "schema": "obs_pareto/v1",
            "points": self.n_points,
            "frontier_size": len(self._frontier),
            "frontier": [
                {"rid": q["rid"],
                 "latency_s": round(q["latency_s"], 9),
                 "loss": round(q["loss"], 9),
                 "gear": q["gear"]}
                for q in self._frontier],
            "by_gear": by_gear,
        }
