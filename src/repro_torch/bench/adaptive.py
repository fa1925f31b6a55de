"""The adaptive-vs-frozen diurnal legs: the control plane served end to
end on the model-free `SimStepper`.

The JAX package's ``benchmarks.bench_runtime.adaptive_vs_frozen``,
rebuilt on the port: the same numpy
calibration traces (`adaptive_setup`), drifted serve mix
(`adaptive_serve_mix`), seeded diurnal workload (peak 12.5 req/s over
30 s, period 15 s) and controller settings (telemetry span 1.5 s, hold
20 steps, slope lead 1.5 s, recalibration every 2.5 s once 192 rows are
in).  `leg` serves the adaptive leg (``slot=None``) or one frozen gear
under a tracer, whose token events give each row its decision
attribution (tokens, latency and served loss by exit node, gear and
escalation); `adaptive_vs_frozen` returns the reference's row keys,
which its ``benchmarks.adaptive_smoke.check`` reads.  The decision program runs
on ``device``; tables are solved on the CPU, so two devices decide from
the same bits.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core import traces
from repro_torch.serving import runtime as rt
from repro_torch.serving.control.controller import AdaptiveController
from repro_torch.serving.control.gears import GearPlanner, GearSpec
from repro_torch.serving.obs import Observability, decision_attribution
from repro_torch.serving.runtime.workload import WorkloadSpec, make_workload

__all__ = ["adaptive_setup", "adaptive_serve_mix", "adaptive_requests",
           "leg", "adaptive_vs_frozen"]

# the reference bench's virtual cost model and load
SEG_TIME, OVERHEAD, SLO, LANES, N_NODES = 0.01, 0.002, 0.5, 4, 6
PEAK, PERIOD, DURATION = 12.5, 15.0, 30.0
SEED, MIX_SEED, UTIL = 7, 1, 0.9
SPAN, HOLD, LEAD = 1.5, 20, 1.5
RECAL_INTERVAL, RECAL_MIN_ROWS = 2.5, 192
SPECS = (GearSpec("quality", 0.95), GearSpec("balanced", 0.92),
         GearSpec("turbo", 0.75))


def _overthink_rows(rng, t, n):
    """Serve-time drift rows: losses RISE with depth (overthinking)."""
    start = rng.uniform(0.02, 0.12, (t, 1))
    drift = np.linspace(0.0, 0.3, n)[None, :] * rng.uniform(0.3, 1.0,
                                                            (t, 1))
    noise = rng.normal(0, 0.02, (t, n))
    for i in range(1, n):
        noise[:, i] = 0.7 * noise[:, i - 1] + 0.3 * noise[:, i]
    return np.clip(start + drift + noise, 1e-4, 1.0)


def adaptive_serve_mix(seed: int = MIX_SEED, t: int = 4_000) -> np.ndarray:
    """The drifted SERVE distribution: 3/4 overthinking-up rows, 1/4
    uniformly hard rows — a mix the calibration never saw."""
    rng = np.random.default_rng(seed)
    hard, _, _ = traces.ee_like_traces(rng, t, N_NODES, overthink_prob=0.1,
                                       difficulty_spread=0.3)
    easy = _overthink_rows(rng, t, N_NODES)
    mask = rng.uniform(size=t) < 0.75
    return np.where(mask[:, None], easy, hard).astype(np.float64)


def adaptive_setup(seed: int = 0):
    """A FRESH (planner, bank): the `Recalibrator` re-fits gears in
    place, so every leg solves its own."""
    rng = np.random.default_rng(seed)
    calib, _, flops = traces.ee_like_traces(rng, 3_000, N_NODES,
                                            overthink_prob=0.05)
    planner = GearPlanner(calib, flops, k=16, seg_time=SEG_TIME,
                          overhead=OVERHEAD, n_lanes=LANES,
                          mean_tokens=18.0, utilization=UTIL)
    return planner, planner.plan(SPECS)


def adaptive_requests():
    spec = WorkloadSpec(rate=PEAK, duration=DURATION, prompt_len=8,
                        max_tokens=(4, 32), seed=SEED)
    return make_workload("diurnal", spec, period=PERIOD)


def leg(requests, serve_rows, *, slot=None, device="cuda"):
    """One leg: the adaptive controller (``slot=None``) or the frozen
    gear ``slot``, traced.  Returns ``(metrics, stepper, controller,
    bank, attribution)``."""
    planner, bank = adaptive_setup()
    ctl = None
    if slot is None:
        ctl = AdaptiveController(
            bank, span=SPAN, slo=SLO, hold=HOLD, lead=LEAD,
            recal_interval=RECAL_INTERVAL, recal_min_rows=RECAL_MIN_ROWS,
            planner=planner)
    stepper = rt.SimStepper(bank.strategies, serve_rows, n_lanes=LANES,
                            seg_time=SEG_TIME, overhead=OVERHEAD,
                            device=device)
    sid_of = ctl.sid_of if ctl else (lambda r: slot)
    obs = Observability()
    server = rt.Server(stepper, rt.LaneScheduler(LANES), sid_of, slo=SLO,
                       controller=ctl, obs=obs)
    metrics = server.serve(requests)
    # sids ARE gear-bank slots here, so attribution names each token's
    # gear
    attribution = decision_attribution(
        obs.tracer.events, gear_of=lambda sid: bank[int(sid)].name)
    return metrics, stepper, ctl, bank, attribution


def _row(metrics, stepper, n_requests, **extra) -> dict:
    completed = sum(1 for r in metrics.records.values()
                    if r.finished is not None)
    return {"summary": metrics.summary(slo=SLO),
            "served_loss_mean": stepper.mean_served_loss,
            "completed": completed, "n_requests": n_requests, **extra}


def adaptive_vs_frozen(device="cuda") -> tuple[list[dict], tuple]:
    """The adaptive leg and every frozen gear's, on the same requests
    and serve mix: the rows, with the reference bench's keys, and the
    adaptive leg's ``(metrics, stepper, controller)``."""
    requests = adaptive_requests()
    rows_in = adaptive_serve_mix()
    metrics_ad, stepper_ad, ctl, bank, attribution = leg(
        requests, rows_in, device=device)
    stats = ctl.stats()
    rows = [_row(metrics_ad, stepper_ad, len(requests),
                 name=f"runtime_sim_adaptive_r{PEAK:g}",
                 adaptive="adaptive", gear=stats["gear"],
                 gear_switches=stats["gear_switches"],
                 recalibrations=stats["recalibrations"],
                 decide_cache_size=stepper_ad.decide_cache_size(),
                 controller=stats, attribution=attribution)]
    for slot, gear in enumerate(bank):
        metrics, stepper, _, _, attribution = leg(requests, rows_in,
                                                  slot=slot, device=device)
        rows.append(_row(metrics, stepper, len(requests),
                         name=f"runtime_sim_frozen_{gear.name}_r{PEAK:g}",
                         adaptive=f"frozen_{gear.name}", gear=gear.name,
                         gear_switches=0, recalibrations=0,
                         attribution=attribution))
    return rows, (metrics_ad, stepper_ad, ctl)
