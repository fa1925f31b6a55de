"""`RegretMeter` — the decision-quality plane (DESIGN.md §15).

T-Tamer's separation theorem — recall strategies attain the optimal
accuracy-latency trade-off, no-recall strategies admit no constant-
factor approximation — is checked offline by the benchmark sweeps.
This module turns the optimality gap into LIVE telemetry: for every
finished request, how far did the serve land from that request's
offline-optimal walk, and which decision cost it?

The meter is a pure `SpanTracer` listener, exactly like the
`InvariantLedger`: it adds zero producers, zero device syncs, and a
traced serve with the meter armed is bit-identical to one without (the
listener-purity test pins this).  Everything it needs already rides
the span stream — ``token`` events carry the served node, its bank-row
loss and the walk's deepest probed node; ``recall ... denied=True``
marks governor demotions; ``gear_switch`` marks control transients.

ORACLE.  In **exact** mode (sim steppers, which replay a trace bank)
the meter holds the same ``(T, n)`` loss bank the stepper decides
from, so request ``rid``'s token ``t`` maps to row ``(rid * 9973 + t)
% T`` — the runtime's own deterministic row assignment.  The offline
optimum for every row is solved ONCE per lambda from the calibrated
`Cascade` tables via the existing `solve_skip` / `simulate_skip`
machinery and memoized, so the oracle is O(1) amortized per request.
Per-token regret is measured on the served-loss axis::

    regret(t) = max(0, lam * (loss[row, served] - oracle_loss[row]))

clipped at zero because a realized serve can BEAT the oracle's loss by
overpaying latency — that surplus shows on the Pareto frontier, not in
regret.  When the serve follows the oracle policy (``skip_recall`` on
the same calibration), regret is exactly zero by construction — which
is precisely the paper's theorem as a measurable signal.

In **expected** mode (engine steppers with no trace bank) the realized
loss comes off the token event and the oracle degrades to the solved
tables' expected optimal objective ``tables.value`` — an approximate
floor (it includes explore cost), honest enough for trend telemetry
and labelled as such in the report verdict.

CAUSE PARTITION.  Each positive-regret token lands in exactly ONE
bucket (mirror of `obs/lossmap.py`'s exact-partition style; the
partition-exactness test pins causes summing to total):

  * ``governor_denied``   — a ``recall ... denied=True`` landed for
    this rid in the same step (the degrade governor demoted the walk).
  * ``gear_transient``    — the token falls inside ``gear_transient_s``
    after a ``gear_switch`` (the cost of switching, not steady state).
  * ``escalated_too_late``— the walk served DEEPER than the oracle's
    stop: it paid extra rungs and still lost loss (overthinking the
    paper's Section-3 regime).
  * ``recall_forgone``    — the walk probed at least as deep as the
    oracle's serve node but served a shallower, worse one: the right
    answer was in hand and recall was not used.
  * ``exited_too_early``  — everything else: the walk stopped before
    the oracle's serve node (underthinking).

`regret_events` is the offline mirror over an exported event ring,
with `audit_events`-style ring-overflow honesty: a truncated ring
(``dropped > 0``) demotes the verdict to ``unverifiable`` and moves
the numbers into ``suspect`` rather than asserting them.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Any

import numpy as np
import torch

from repro_torch.core import skip_dp
from repro_torch.core.support import quantize
from repro_torch.serving.obs.pareto import ParetoTracker
from repro_torch.serving.obs.trace import Event, SpanTracer

__all__ = ["RegretMeter", "regret_events", "REGRET_CAUSES"]

REGRET_CAUSES = ("exited_too_early", "escalated_too_late",
                 "recall_forgone", "governor_denied", "gear_transient")

_ROW_PRIME = 9973     # the runtime's (rid, token) -> trace-row mapping


class RegretMeter:
    """Per-request regret vs the offline-optimal walk, as a listener.

    ``casc`` is the calibrated `Cascade` whose tables define the
    oracle; ``traces`` the raw ``(T, n)`` loss bank sim steppers replay
    (`bind` pulls it off the stepper when omitted).  ``gear_transient_s``
    reclassifies regret inside post-switch windows, same knob as the
    lossmap.  ``out_dir`` is where `finalize` drops ``regret.json`` /
    ``pareto.json`` when set.
    """

    def __init__(self, casc=None, *, traces=None,
                 gear_transient_s: float = 0.0,
                 out_dir: str | None = None, keep_worst: int = 5):
        self.casc = casc
        self.traces = None if traces is None else np.asarray(traces,
                                                             np.float32)
        self.gear_transient_s = float(gear_transient_s)
        self.out_dir = out_dir
        self.keep_worst = int(keep_worst)
        self.pareto = ParetoTracker()

        self.records: dict[int, dict[str, Any]] = {}   # finished rids
        self.finalized = False
        self._flight = None
        self._controller = None
        self._gear = "fixed"
        self._last_switch: float | None = None
        self._sid: dict[int, int] = {}     # rid -> strategy-bank slot
        self._oracle_memo: dict[float, tuple[np.ndarray, np.ndarray]] = {}
        self._value_of: tuple | None = None   # (tables, their value)

        # O(live-rids) per-request fold state, cleaned at finish/reap
        self._arrival: dict[int, float] = {}
        self._lam: dict[int, float] = {}
        self._tidx: dict[int, int] = {}
        self._sum: dict[int, float] = {}               # regret sum
        self._loss_sum: dict[int, float] = {}          # raw served loss
        self._causes: dict[int, dict[str, float]] = {}
        self._denied: set[int] = set()                 # pending demotions

    # ------------------------------------------------------------ wiring
    def bind(self, tracer: SpanTracer, *, stepper=None, flight=None,
             controller=None) -> None:
        """Attach as a chained listener.  ``stepper`` donates its trace
        bank when the meter was built without one (`SimStepper.bank` /
        `CascadeSimStepper.traces` — both the raw loss array); engine
        steppers have none and the meter serves expected mode.
        ``flight`` receives `note_regret` per finished request for the
        ``regret_burst`` trigger; ``controller`` names the initial
        gear."""
        if self.traces is None and stepper is not None:
            for attr in ("traces", "bank"):
                cand = getattr(stepper, attr, None)
                if isinstance(cand, np.ndarray) and cand.ndim == 2:
                    self.traces = cand
                    break
        self._flight = flight
        self._controller = controller
        if controller is not None:
            gear = getattr(controller, "gear", None)
            name = getattr(gear, "name", None)
            if name:
                self._gear = str(name)
        tracer.add_listener(self.observe)

    @property
    def mode(self) -> str:
        return "exact" if self.traces is not None else "expected"

    # ------------------------------------------------------------ oracle
    def _oracle(self, lam: float) -> tuple[np.ndarray, np.ndarray]:
        """(oracle_loss, oracle_node) over the whole trace bank at
        ``lam`` — solved once per lambda and memoized, so the per-token
        lookup is one array index.  ``oracle_loss`` is in the
        lam-scaled domain `simulate_skip` serves in."""
        key = round(float(lam), 9)
        hit = self._oracle_memo.get(key)
        if hit is not None:
            return hit
        casc = self.casc
        mode = casc.skip_mode or ("cascade" if casc.boundaries
                                  else "cumulative")
        tables = casc.solve_skip(mode)
        scaled = np.asarray(key * self.traces, np.float32)
        # one bin lookup over the whole bank on the tables' device, then
        # back to the host: the per-token work below reads numpy only
        bins = quantize(casc.support, torch.from_numpy(scaled)).cpu().numpy()
        served, _, probed = skip_dp.simulate_skip(
            tables, scaled, bins, np.asarray(casc.edge_costs))
        node = np.where(probed, scaled, np.inf).argmin(axis=1)
        # degenerate stop-immediately rows (nothing probed): fall back
        # to the row's best node so regret stays finite and >= 0
        empty = ~probed.any(axis=1)
        if empty.any():
            node[empty] = scaled[empty].argmin(axis=1)
            served = np.where(empty, scaled[np.arange(len(scaled)), node],
                              served)
        out = (np.asarray(served, np.float64), node.astype(np.int64))
        self._oracle_memo[key] = out
        return out

    def _oracle_value(self) -> float:
        """Expected-mode floor: the tables' optimal expected objective
        (read off the device once per set of tables, not per token)."""
        casc = self.casc
        mode = casc.skip_mode or ("cascade" if casc.boundaries
                                  else "cumulative")
        tables = casc.solve_skip(mode)
        if self._value_of is None or self._value_of[0] is not tables:
            self._value_of = (tables, float(tables.value))
        return self._value_of[1]

    # ------------------------------------------------------------ stream
    def observe(self, ev: Event) -> None:
        kind = ev.kind
        if kind == "queued":
            self._arrival[ev.rid] = ev.t
            lam = dict(ev.data).get("lam")
            if lam is not None:
                self._lam[ev.rid] = float(lam)
        elif kind == "token":
            self._on_token(ev)
        elif kind == "recall":
            if dict(ev.data).get("denied"):
                self._denied.add(ev.rid)
        elif kind == "gear_switch":
            d = dict(ev.data)
            self._gear = str(d.get("dst_name", d.get("dst", self._gear)))
            self._last_switch = ev.t
        elif kind == "finish":
            self._on_finish(ev)
        elif kind in ("cancel", "deadline_miss"):
            # abandoned stream: regret is undefined for an answer
            # nobody received — drop the fold state, count nothing
            self._drop(ev.rid)

    def _cause_of(self, ev: Event, node: int, deepest: int,
                  oracle_node: int) -> str:
        if ev.rid in self._denied:
            return "governor_denied"
        if (self._last_switch is not None and self.gear_transient_s > 0
                and ev.t - self._last_switch <= self.gear_transient_s):
            return "gear_transient"
        if node > oracle_node:
            return "escalated_too_late"
        if node < oracle_node and deepest >= oracle_node:
            return "recall_forgone"
        return "exited_too_early"

    def _on_token(self, ev: Event) -> None:
        rid = ev.rid
        t = self._tidx.get(rid, 0)
        self._tidx[rid] = t + 1
        d = dict(ev.data)
        sid = d.get("sid")
        if sid is not None:
            self._sid[rid] = int(sid)
        node = int(d.get("node", -1))
        if node < 0 or self.casc is None:
            self._denied.discard(rid)
            return
        lam = self._lam.get(rid, float(self.casc.lam))
        deepest = int(d.get("deepest", node))
        if self.traces is not None:
            row = (rid * _ROW_PRIME + t) % len(self.traces)
            oracle_loss, oracle_node = self._oracle(lam)
            raw = float(self.traces[row, node])
            regret = max(0.0, lam * raw - float(oracle_loss[row]))
            cause = self._cause_of(ev, node, deepest,
                                   int(oracle_node[row]))
        else:
            loss = d.get("loss")
            if loss is None:
                self._denied.discard(rid)
                return
            raw = float(loss)
            regret = max(0.0, lam * raw - self._oracle_value())
            if rid in self._denied:
                cause = "governor_denied"
            elif (self._last_switch is not None
                  and self.gear_transient_s > 0
                  and ev.t - self._last_switch <= self.gear_transient_s):
                cause = "gear_transient"
            elif d.get("esc"):
                cause = "escalated_too_late"
            else:
                cause = "exited_too_early"
        self._denied.discard(rid)
        self._sum[rid] = self._sum.get(rid, 0.0) + regret
        self._loss_sum[rid] = self._loss_sum.get(rid, 0.0) + raw
        if regret > 0.0:
            causes = self._causes.setdefault(
                rid, {c: 0.0 for c in REGRET_CAUSES})
            causes[cause] += regret

    def _on_finish(self, ev: Event) -> None:
        rid = ev.rid
        n = self._tidx.get(rid, 0)
        if n == 0:
            self._drop(rid)
            return
        regret = self._sum.get(rid, 0.0) / n
        causes = {c: v / n for c, v in self._causes.get(
            rid, {c: 0.0 for c in REGRET_CAUSES}).items()}
        loss_mean = self._loss_sum.get(rid, 0.0) / n
        arrival = self._arrival.get(rid, ev.t)
        latency = max(0.0, ev.t - arrival)
        # gear attribution: admission-time routing (the strategy-bank
        # slot the controller's swap pointed new admissions at) when a
        # controller is bound; the last gear_switch name otherwise
        gear = self._gear
        if self._controller is not None and rid in self._sid:
            try:
                gear = self._controller.gear_name_of(self._sid[rid])
            except (IndexError, KeyError):
                pass
        self.records[rid] = {
            "rid": rid, "t": float(ev.t), "tokens": n,
            "regret": regret, "causes": causes,
            "latency_s": latency, "loss_mean": loss_mean,
            "gear": gear,
        }
        self.pareto.add(rid, latency, loss_mean, gear=gear)
        if self._flight is not None:
            note = getattr(self._flight, "note_regret", None)
            if note is not None:
                note(ev.t, rid, regret)
        self._drop(rid)

    def _drop(self, rid: int) -> None:
        for store in (self._arrival, self._lam, self._tidx, self._sum,
                      self._loss_sum, self._causes, self._sid):
            store.pop(rid, None)
        self._denied.discard(rid)

    # ------------------------------------------------------------ report
    def counter_points(self) -> list[tuple[float, float]]:
        """(finish-time, per-request regret) samples for the exporter's
        pid-2 Perfetto counter track."""
        return sorted((rec["t"], rec["regret"])
                      for rec in self.records.values())

    def regret_digest(self) -> str:
        """sha256 over rid-sorted per-request regret + cause splits —
        golden-pinnable on the sim's virtual clock, same idiom as the
        tracer's `span_digest`."""
        h = hashlib.sha256()
        for rid in sorted(self.records):
            rec = self.records[rid]
            causes = ",".join(f"{c}={rec['causes'][c]:.9f}"
                              for c in REGRET_CAUSES)
            h.update(f"{rid}:{rec['regret']:.9f}:{causes}".encode())
            h.update(b"\n")
        return h.hexdigest()

    def finalize(self, t_end: float | None = None) -> dict[str, Any]:
        """Idempotent end-of-serve hook; writes the ``out_dir`` sinks
        once and returns `report`."""
        if not self.finalized:
            self.finalized = True
            if self.out_dir:
                os.makedirs(self.out_dir, exist_ok=True)
                with open(os.path.join(self.out_dir, "regret.json"),
                          "w") as f:
                    json.dump(self.report(), f, indent=1, default=float)
                with open(os.path.join(self.out_dir, "pareto.json"),
                          "w") as f:
                    json.dump(self.pareto.as_doc(), f, indent=1,
                              default=float)
        return self.report()

    def report(self, *, unverifiable: bool = False) -> dict[str, Any]:
        regrets = np.asarray([self.records[r]["regret"]
                              for r in sorted(self.records)], np.float64)
        causes = {c: 0.0 for c in REGRET_CAUSES}
        tokens = 0
        for rec in self.records.values():
            tokens += rec["tokens"]
            for c in REGRET_CAUSES:
                causes[c] += rec["causes"][c]
        worst = sorted(self.records.values(),
                       key=lambda r: -r["regret"])[:self.keep_worst]
        doc: dict[str, Any] = {
            "schema": "obs_regret/v1",
            "mode": self.mode,
            "requests": len(self.records),
            "tokens": tokens,
            "regret_mean": float(regrets.mean()) if len(regrets) else 0.0,
            "regret_p99": (float(np.percentile(regrets, 99))
                           if len(regrets) else 0.0),
            "regret_max": float(regrets.max()) if len(regrets) else 0.0,
            "regret_total": float(regrets.sum()),
            "causes": causes,
            "worst": [{k: v for k, v in rec.items() if k != "t"}
                      for rec in worst],
            "digest": self.regret_digest(),
            "verdict": "unverifiable" if unverifiable else self.mode,
        }
        if unverifiable:
            # audit_events-style honesty: a truncated ring cannot
            # support the numbers — move them aside, assert nothing
            doc["suspect"] = {
                "regret_mean": doc["regret_mean"],
                "regret_p99": doc["regret_p99"],
                "regret_max": doc["regret_max"],
                "regret_total": doc["regret_total"],
                "causes": doc.pop("causes"),
            }
            for key in ("regret_mean", "regret_p99", "regret_max",
                        "regret_total"):
                doc[key] = None
            doc["causes"] = {}
            doc["worst"] = []
        return doc

    def stats(self) -> dict[str, Any]:
        return {"requests": len(self.records),
                "pareto_points": self.pareto.n_points,
                "frontier": len(self.pareto.frontier)}


def regret_events(events, *, dropped: int = 0,
                  **meter_kwargs) -> dict[str, Any]:
    """Offline regret over an exported event ring (or `Event` list).

    With ``dropped == 0`` the ring is the complete stream and the
    report is exactly what a live meter would have said.  With
    ``dropped > 0`` token counts (and hence row indices) may be wrong
    for any rid — the verdict demotes to ``unverifiable`` and the
    numbers move into ``suspect``, mirroring `audit_events`.
    """
    meter = RegretMeter(**meter_kwargs)
    for ev in events:
        if not isinstance(ev, Event):
            d = dict(ev)
            data = tuple(sorted(
                (k, v) for k, v in d.items()
                if k not in ("t", "kind", "rid", "lane", "model")))
            ev = Event(float(d["t"]), str(d["kind"]),
                       int(d.get("rid", -1)), int(d.get("lane", -1)),
                       int(d.get("model", -1)), data)
        meter.observe(ev)
    report = meter.report(unverifiable=dropped > 0)
    report["events_dropped"] = int(dropped)
    return report
