"""Fault-tolerance plane: deterministic chaos scripts and graceful
degradation.

`FaultPlan` scripts request cancellations, deadline squeezes, rung-stall
windows, and page-pressure events as a pure function of a seed — every
fault lands at a scripted virtual time, so a faulted serve replays
bit-identically.  `DegradeGovernor` turns deadline pressure into
demotion instead of failure: escalations whose catch-up cost cannot fit
the remaining budget are denied and the small rung's recalled answer is
served instead.
"""

from repro_torch.serving.faults.governor import DegradeGovernor
from repro_torch.serving.faults.plan import FaultPlan

__all__ = ["FaultPlan", "DegradeGovernor"]
