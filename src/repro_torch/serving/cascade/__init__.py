"""repro_torch.serving.cascade — multi-model cascade serving (DESIGN.md
§10).

A ladder of 2+ models in ONE server process, routed per token as a
T-Tamer multi-stage decision process over the CONCATENATED node line:

  * `bank.ModelBank` — the ladder: per-model configs/params (real) or
    virtual cost knobs (sim), node-offset arithmetic, per-model lanes.
  * `router.CascadeRouter` — residency state machine: escalation onto
    deeper models, recall-policy de-escalation, commit-policy floors.
  * `scheduler.EscalationScheduler` — deeper-rung lane pools + per-model
    catch-up token budgets (escalation bursts cannot starve rung 0).
  * `sim.CascadeSimStepper` — virtual-clock stepper; its walk runs on
    an explicit device.
  * `engine.CascadeEngineStepper` — the real thing: one `EngineStepper`
    per rung over one combined strategy bank, walks handed off across
    models through the token step's escalation handoff, catch-up
    prefill through the chunked path, recall as a prefix-cache re-pin.

Both steppers drive the standard `serving.runtime.Server` loop
unchanged — a cascade is just a stepper whose "lane" is a request slot
that may span several models.
"""

from repro_torch.serving.cascade.bank import ModelBank, ModelSpec
from repro_torch.serving.cascade.engine import CascadeEngineStepper
from repro_torch.serving.cascade.metrics import CascadeStats
from repro_torch.serving.cascade.router import CascadeRouter
from repro_torch.serving.cascade.scheduler import EscalationScheduler
from repro_torch.serving.cascade.sim import CascadeSimStepper

__all__ = [
    "ModelSpec", "ModelBank", "CascadeRouter", "EscalationScheduler",
    "CascadeStats", "CascadeSimStepper", "CascadeEngineStepper",
]
