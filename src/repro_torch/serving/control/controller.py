"""`AdaptiveController` — the control loop the `Server` drives.

Wiring (all three hooks are host-side and step-synchronous):

  * ``begin(metrics, stepper)`` — binds the telemetry window to the
    run's metrics, installs the `BankSwap` as the stepper's
    ``bank_source`` (the per-step array feed) and taps the stepper's
    observed outcomes for the `Recalibrator`.  Steppers without a
    ``bank_source`` attribute (a bare engine stepper) still get gear
    SWITCHING — admission routing via ``sid_of`` and host knobs via
    ``apply_gear`` — but online recalibration is disabled for them.
  * ``on_arrivals(times)`` — feeds the load signal.
  * ``on_step_end(now, queue_depth)`` — the decision point, called at
    the one instant no token step is in flight: flush tapped outcome
    rows, read the telemetry, pick the gear for the observed arrival
    rate (with ``hold``-step hysteresis so a single noisy window never
    thrashes the bank), land at most one swap, and run a due
    recalibration.

Swaps are atomic by construction: they land between steps, in-flight
lanes keep their admitted ``sid``, and publishes are signature-guarded
copies into the slot's reserved tensors — the swap-safety tests pin all
three properties.
"""

from __future__ import annotations

import numpy as np

from repro_torch.serving.control.gears import GearBank, GearPlanner
from repro_torch.serving.control.recalibrate import Recalibrator
from repro_torch.serving.control.swap import BankSwap
from repro_torch.serving.control.telemetry import TelemetryWindow

__all__ = ["AdaptiveController"]


class AdaptiveController:
    """Telemetry -> gear selection -> swap/publish, between steps."""

    # observability plane: gear switches and recalibrations land as
    # events on the tracer the server installs with its obs bundle
    tracer = None

    def __init__(self, bank: GearBank, *, span: float,
                 slo: float | None = None, hold: int = 3,
                 lead: float = 0.0,
                 recal_interval: float | None = None,
                 recal_min_rows: int = 256, recal_max_rows: int = 4096,
                 planner: GearPlanner | None = None,
                 start: int | None = None):
        if hold < 1:
            raise ValueError("hold must be >= 1")
        self.bank = bank
        # default start: the best gear (slot 0) — an idle server serves
        # quality; load pushes it down the bank
        self.swap = BankSwap(bank.strategies,
                             start=0 if start is None else int(start))
        self.telemetry = TelemetryWindow(span, slo=slo)
        self.hold = int(hold)
        # slope lead-time: a trailing-window rate estimate LAGS a ramp
        # by ~span/2, so on a steep diurnal rise the controller would
        # hold a near-saturated gear until the queue already pays for
        # it.  Projecting the rate forward by ``lead`` seconds of the
        # measured slope (rising side only — falling ramps err toward
        # the cheaper gear, the SLO-safe direction) turns the
        # inflection DETECTOR into the inflection REACTION.
        self.lead = float(lead)
        self.recal: Recalibrator | None = None
        self._recal_cfg = None
        if recal_interval is not None:
            self._recal_cfg = (float(recal_interval), int(recal_min_rows),
                               int(recal_max_rows), planner)
        self.stepper = None
        self._row_buf: list = []
        self._want: int | None = None
        self._streak = 0

    # ---- lifecycle (Server hooks) ------------------------------------

    def begin(self, metrics, stepper) -> None:
        self.telemetry.bind(metrics)
        self.stepper = stepper
        if hasattr(stepper, "bank_source"):
            # the reserved storages go where the step decides, once,
            # before the serve's first step
            self.swap.to(stepper.device)
            stepper.bank_source = self.swap
            stepper.row_tap = self._tap
            if self._recal_cfg is not None:
                interval, min_rows, max_rows, planner = self._recal_cfg
                self.recal = Recalibrator(
                    self.bank, self.swap, interval=interval,
                    min_rows=min_rows, max_rows=max_rows, planner=planner)
        # engine-style steppers without a bank_source: gear switching
        # only (sid routing + host knobs); no online recalibration
        self._apply(self.bank[self.swap.gear])

    def sid_of(self, req) -> int:
        """Admission-time routing — pass this as the Server's sid_of."""
        return self.swap.sid_of(req)

    def on_arrivals(self, times) -> None:
        self.telemetry.on_arrivals(times)

    def _tap(self, losses, served) -> None:
        # called mid-step from the stepper; buffer only — all folding
        # happens at the step boundary
        self._row_buf.append((losses, served))

    def on_step_end(self, now: float, queue_depth: int) -> None:
        if self._row_buf:
            for losses, served in self._row_buf:
                picked = losses[np.arange(len(served)), served]
                self.telemetry.on_losses(now, picked)
                if self.recal is not None:
                    self.recal.observe(losses, served)
            self._row_buf.clear()
        esc = getattr(self.stepper, "esc", None)
        self.telemetry.on_gauges(
            queue_depth=queue_depth,
            escalations=sum(esc.lanes_in_use(m)
                            for m in range(1, len(esc.bank)))
            if esc is not None else 0)
        self._select_gear(now)
        if self.recal is not None and self.recal.due(now):
            n_rows = self.recal.n_rows
            self.recal.recalibrate(now)
            if self.tracer is not None:
                self.tracer.emit("recal", t=now, n_rows=n_rows)

    # ---- gear selection ----------------------------------------------

    def _select_gear(self, now: float) -> None:
        rate = self.telemetry.arrival_rate(now)
        if self.lead > 0.0:
            rate += self.lead * max(self.telemetry.rate_slope(now), 0.0)
        want = self.bank.slot_for_rate(rate)
        if want == self.swap.gear:
            self._want, self._streak = None, 0
            return
        if want == self._want:
            self._streak += 1
        else:
            self._want, self._streak = want, 1
        if self._streak >= self.hold:
            prev = self.swap.gear
            self.swap.swap_to(want, now)
            self._apply(self.bank[want])
            if self.tracer is not None:
                self.tracer.emit(
                    "gear_switch", t=now, src=int(prev), dst=int(want),
                    src_name=self.bank[prev].name,
                    dst_name=self.bank[want].name)
            self._want, self._streak = None, 0

    def _apply(self, gear) -> None:
        apply = getattr(self.stepper, "apply_gear", None)
        if apply is not None:
            apply(gear)

    # ---- reporting ---------------------------------------------------

    @property
    def gear(self):
        """The currently active gear."""
        return self.bank[self.swap.gear]

    def gear_name_of(self, slot: int) -> str:
        """Gear label for a strategy-bank slot — the Pareto frontier's
        per-gear attribution reads routing off the active gear's name
        rather than the raw slot index."""
        return self.bank[int(slot)].name

    def stats(self) -> dict:
        return {
            "gear": self.gear.name,
            "gear_switches": len(self.swap.switches),
            "switches": [
                {"t": t, "from": self.bank[a].name, "to": self.bank[b].name}
                for t, a, b in self.swap.switches],
            "recalibrations": self.recal.recals if self.recal else 0,
            "publishes": len(self.swap.publishes),
            "gears": self.bank.describe(),
        }
