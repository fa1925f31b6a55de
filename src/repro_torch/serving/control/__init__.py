"""repro_torch.serving.control — the adaptive control plane.

Closes the loop from telemetry to strategy: everything before this
package is feed-forward (offline calibration -> frozen tables -> serve);
this package WRITES BACK into the decision layer while the server runs.

    TelemetryWindow  — sliding-window load/quality estimates + the
                       load-level signal and inflection detection.
    GearPlanner      — offline bank of load-indexed gear plans, each a
                       provably-optimal T-Tamer strategy for its regime.
    Recalibrator     — online re-fit of `Cascade` tables from observed
                       outcomes, re-solved off the hot path.
    BankSwap         — atomic strategy-bank exchange between token
                       steps: an in-place copy into reserved tensors +
                       a host-side gear pointer, never a rebuilt step,
                       never a dropped lane.
    AdaptiveController — the glue the `Server` drives via its
                       begin / on_arrivals / on_step_end hooks.
"""

from repro_torch.serving.control.controller import AdaptiveController
from repro_torch.serving.control.gears import (Gear, GearBank, GearPlanner,
                                         GearSpec)
from repro_torch.serving.control.recalibrate import Recalibrator
from repro_torch.serving.control.swap import BankSwap
from repro_torch.serving.control.telemetry import TelemetrySnapshot, TelemetryWindow

__all__ = [
    "TelemetryWindow", "TelemetrySnapshot",
    "GearSpec", "Gear", "GearBank", "GearPlanner",
    "Recalibrator", "BankSwap", "AdaptiveController",
]
