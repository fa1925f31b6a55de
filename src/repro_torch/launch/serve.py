"""Serving launcher of the port: initializes a model from a seed,
calibrates a `Cascade` on numpy-seeded prompts, builds the requested
strategy from the registry, and serves through the segment engine —
either one batched generation on ring caches (default) or a seeded
open-loop workload with continuous batching (``--server``), on per-lane
ring caches (``--kv ring``, the default) or the paged KV pool, with
stop-the-world or chunked (``--prefill-chunk``) admission:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch paper-ee-100m \
      --flash --dp-kernel --batch 8 --tokens 16

  PYTHONPATH=src python -m repro_torch.launch.serve --arch paper-ee-100m \
      --server --kv paged --prefill-chunk 16 --paged-kernel \
      --policy recall_index --lanes 8 --rate 8 --duration 2 --tokens 16

  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-130m \
      --server --ssd-kernel --dp-kernel --lanes 8 --rate 8 --duration 2

  PYTHONPATH=src python -m repro_torch.launch.serve --server \
      --cascade paper-ee-100m:paper-ee-100m --paged-kernel \
      --prefill-chunk 16 --page-size 16 --policy skip_recall \
      --escalate-policy recall --lanes 8 --cascade-lanes 4

``--policy`` takes any online name of ``repro_torch.strategy.available()``
(the JAX launcher's: ``recall_index``, ``tree_index``, ``skip_recall``,
``norecall_threshold``, ``recall_threshold``, ``norecall_patience``,
``always_first``, ``always_last``) and its aliases ``recall`` /
``threshold`` / ``none``; ``--threshold`` and ``--patience`` tune the
baselines.  The hindsight oracles are refused.  ``--server`` replays a
seeded open-loop workload (``--workload poisson|bursty|diurnal``) in
``--order fifo|edf`` (EDF deadlines: arrival + ``--slo-ms``), ends a
stream early on ``--eos``, and reports throughput, latency percentiles,
goodput under ``--slo-ms`` and segments saved.

``--cascade A:B[:C]`` serves a MULTI-MODEL ladder in one process
(`repro_torch.serving.cascade`): the strategy's node line spans every
model, escalation chunk-prefills the stream onto deeper models through
the paged pool, and ``--escalate-policy recall`` makes revisiting an
earlier model a page-table re-pin (``commit`` pins a stream to the
model it escalated to).  Rung m's weights come from seed ``--seed +
m``; the calibration prompts from a ``torch.Generator`` seeded with
``--seed + 1``.

``--adaptive`` serves a gear bank (``--gears name:lam,...``, each gear a
``skip_recall`` strategy priced by a `GearPlanner` on 128 x 32
calibration prompts drawn with numpy from ``--seed + 1``) under the
`AdaptiveController`, which switches the gear new admissions use from
the observed arrival rate; the engine stepper has no swappable array
bank, so ``--recal-interval`` (online re-fits) applies to the sim
steppers only, as in the reference.  The fault plane: ``--faults
PLAN.json`` serves under a ``faults/v1`` chaos script (scripted
cancellations, deadlines, rung stalls, page squeezes), ``--cancel-rate``
and ``--deadline-ms`` draw seeded per-request cancellations and
deadlines (``--seed + 7``; expired requests are reaped), the
`DegradeGovernor` denies escalations a deadline cannot afford or a
stalled rung cannot serve (``--no-governor`` turns it off), and
``--kv-reclaim FRAC`` arms the paged pool's sliding-window reclamation
above that occupancy.

Every ``--server`` mode can be observed (`repro_torch.serving.obs`):
``--trace-out`` writes a Chrome/Perfetto trace of the request lifecycle
and every per-token decision, ``--metrics-out`` the metrics registry
the console report renders from, ``--flight-recorder DIR`` arms anomaly
post-mortem bundles, ``--obs-dir DIR`` writes all of those plus the
lossless event log and the invariant ledger's report into DIR,
``--regret`` arms the regret meter and the Pareto frontier, and
``--profile-dir DIR`` captures a ``torch.profiler`` trace (host, and
the card's kernels and copies) around the serve loop.

It runs on the card (``--device cuda``, the default) and refuses to go
on when CUDA is missing; ``--device cpu`` runs the same path with the
kernels' plain PyTorch versions.  ``--paged-kernel`` sends every paged
decode and every prefill chunk through the CUDA kernels, ``--flash``
every whole-prompt prefill (calibration, stop-the-world admission, the
one-shot batch) through the flash-attention kernel, ``--ssd-kernel``
the SSD chunks of those prefills (SSM models) through the ssd-chunk
kernel, and ``--dp-kernel`` the calibration's line solve through the
Bellman-backup kernel.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

from repro_torch import strategy
from repro_torch.configs import get_config
from repro_torch.models import model as M
from repro_torch.models.param import materialize
from repro_torch.serving import runtime as rt
from repro_torch.serving.control import (AdaptiveController, GearPlanner,
                                         GearSpec)
from repro_torch.serving.engine import Engine, GenerationStats
from repro_torch.serving.faults import DegradeGovernor, FaultPlan
from repro_torch.serving.obs import (FlightRecorder, InvariantLedger,
                                     Observability, RegretMeter)
from repro_torch.serving.obs.export import (profiler_capture, write_events,
                                            write_trace)
from repro_torch.serving.obs.lossmap import goodput_lossmap
from repro_torch.serving.obs.report import ServeReport, segments_saved_line
from repro_torch.serving.runtime.workload import WorkloadSpec, make_workload

__all__ = ["main", "ServeRun", "BatchRun", "ALIASES", "ONLINE",
           "build_strategy", "parse_gears"]

CALIB_PROMPTS, CALIB_LEN, CALIB_K = 512, 64, 24
# the cascade's calibration: prompts x length, support size (the JAX
# launcher's _calibrate_multi)
MULTI_PROMPTS, MULTI_LEN, MULTI_K = 128, 32, 16
# the --adaptive gear bank's calibration: prompts x length, ring length,
# support size (the JAX launcher's _build_adaptive)
GEAR_PROMPTS, GEAR_LEN, GEAR_CACHE, GEAR_K = 128, 32, 40, 12

# the reference launcher's aliases
ALIASES = {
    "recall": "recall_index",
    "threshold": "norecall_threshold",
    "none": "always_last",
}
# hindsight-only strategies (online=False in the registry) cannot serve
ONLINE = strategy.available(online_only=True)
RAW_CONFIDENCE = ("norecall_threshold", "recall_threshold",
                  "norecall_patience")


def build_strategy(name: str, casc: strategy.Cascade, *, threshold: float,
                   patience: int, lam: float | None = None):
    """Registry dispatch with the per-family CLI knobs applied.

    ``lam`` is the per-request override a request carries; the threshold
    and patience family compares raw 1 - confidence (its lam is pinned
    to 1.0), so a per-request lam there is refused rather than dropped.
    ``skip_recall`` takes cumulative edge costs on one model (skipped
    segments still run their backbone) and the cascade's ladder on
    several.
    """
    if name in RAW_CONFIDENCE:
        if lam is not None:
            raise ValueError(
                f"{name} serves raw confidences (lam fixed at 1.0); "
                "per-request lam is not supported for this family — "
                "tune --threshold/--patience instead")
        if name == "norecall_patience":
            return strategy.make(name, casc, patience=patience, lam=1.0)
        return strategy.make(name, casc, threshold=threshold, lam=1.0)
    kwargs = {} if lam is None else {"lam": lam}
    if name == "skip_recall":
        kwargs["mode"] = ("cascade" if casc.boundaries is not None
                          else "cumulative")
    return strategy.make(name, casc, **kwargs)


@dataclasses.dataclass
class ServeRun:
    """What one ``main`` call served, for callers that check it
    (``cascade_stats`` only for ``--cascade``; ``obs`` when an
    observability flag was given).  ``calib_s`` is the calibration's
    host time, synchronized with the device (0 when nothing was
    calibrated)."""

    requests: list
    metrics: rt.RuntimeMetrics
    stepper: object               # EngineStepper | CascadeEngineStepper
    cascade: strategy.Cascade
    cascade_stats: dict | None = None
    controller: AdaptiveController | None = None
    faults: FaultPlan | None = None
    obs: Observability | None = None
    calib_s: float = 0.0


@dataclasses.dataclass
class BatchRun:
    """What one one-shot ``main`` call (no ``--server``) generated."""

    prompts: np.ndarray            # (batch, prompt_len) i32
    stats: GenerationStats
    calib_s: float = 0.0           # as `ServeRun.calib_s`


def _timed(device, fn, *a, **k):
    """``fn(*a, **k)`` and its host time, synchronized with ``device``
    so device work the call queued is inside the time."""
    t0 = time.perf_counter()
    out = fn(*a, **k)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out, time.perf_counter() - t0


def _device(name: str) -> torch.device:
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {name}: CUDA is not available here "
                         "(pass --device cpu to run on the CPU)")
    return dev


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="paper-ee-100m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--policy", default="recall_index",
                    choices=sorted(set(ONLINE) | set(ALIASES)))
    ap.add_argument("--lam", type=float, default=0.5)
    ap.add_argument("--threshold", type=float, default=0.4,
                    help="exit threshold on 1 - confidence for the "
                         "threshold policies")
    ap.add_argument("--patience", type=int, default=2,
                    help="agreeing ramps before norecall_patience exits")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default cuda; the "
                         "launcher never falls back to the CPU)")
    ap.add_argument("--server", action="store_true",
                    help="serve an open-loop workload with continuous "
                         "batching instead of one fixed batch")
    ap.add_argument("--rate", type=float, default=8.0,
                    help="mean arrivals/sec")
    ap.add_argument("--duration", type=float, default=5.0,
                    help="arrival window in seconds")
    ap.add_argument("--slo-ms", type=float, default=1000.0,
                    help="TTFT SLO for goodput accounting (and the EDF "
                         "deadline: arrival + SLO)")
    ap.add_argument("--lanes", type=int, default=None,
                    help="lane count (default: --batch)")
    ap.add_argument("--workload", default="poisson",
                    choices=("poisson", "bursty", "diurnal"))
    ap.add_argument("--order", default="fifo", choices=("fifo", "edf"))
    ap.add_argument("--eos", type=int, default=None,
                    help="token id that ends a stream early (lane is "
                         "recycled immediately)")
    ap.add_argument("--kv", default="ring", choices=("ring", "paged"),
                    help="decode KV memory: per-lane ring caches or the "
                         "paged pool with shared-prefix reuse")
    ap.add_argument("--page-size", type=int, default=16,
                    help="tokens per KV page")
    ap.add_argument("--pages", type=int, default=None,
                    help="total pool pages (default: lanes x "
                         "ceil(cache_len/page_size) + 1)")
    ap.add_argument("--paged-kernel", action="store_true",
                    help="run paged decode and prefill chunks through the "
                         "CUDA kernels (plain PyTorch on --device cpu)")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="co-schedule admission prefill with decode in "
                         "chunks of this many prompt tokens instead of "
                         "stop-the-world batch-1 prefills (--kv paged)")
    ap.add_argument("--prefill-budget", type=int, default=None,
                    help="max prompt tokens prefilled per step across "
                         "all admitting lanes (default: --prefill-chunk)")
    ap.add_argument("--cascade", default=None,
                    help="serve a MULTI-MODEL cascade: ':'-separated "
                         "arch names in escalation order (shared "
                         "tokenization required), all in one process on "
                         "the paged pool with chunked prefill.  Implies "
                         "--server")
    ap.add_argument("--escalate-policy", default="recall",
                    choices=("recall", "commit"),
                    help="cascade residency policy: 'recall' retains "
                         "the source model (recall = page re-pin; "
                         "deeper rungs released after --escalate-"
                         "patience idle tokens), 'commit' pins the "
                         "stream to the escalated model for good")
    ap.add_argument("--escalate-patience", type=int, default=4,
                    help="recall policy: de-escalate a rung after this "
                         "many consecutive tokens that never probed it")
    ap.add_argument("--cascade-lanes", type=int, default=None,
                    help="decode lanes per deeper cascade rung "
                         "(default: max(1, --lanes // 2))")
    ap.add_argument("--flash", action="store_true",
                    help="run every whole-prompt prefill (calibration, "
                         "stop-the-world admission, the one-shot batch) "
                         "through the flash-attention kernel: the port's "
                         "handle on the reference's prefill(use_flash=True)")
    ap.add_argument("--ssd-kernel", action="store_true",
                    help="run the SSD chunks of every whole-prompt prefill "
                         "(calibration, stop-the-world admission, the "
                         "one-shot batch) of an SSM model through the "
                         "ssd-chunk kernel: the port's handle on the "
                         "reference's prefill(use_ssd_kernel=True)")
    ap.add_argument("--dp-kernel", action="store_true",
                    help="run the calibration's line solve through the "
                         "Bellman-backup kernel: the port's handle on the "
                         "reference's solve_line(use_kernel=True)")
    ap.add_argument("--adaptive", action="store_true",
                    help="serve under the adaptive control plane: a gear "
                         "bank of recall strategies selected from live "
                         "load telemetry.  Implies --server")
    ap.add_argument("--gears",
                    default="quality:0.95,balanced:0.92,turbo:0.75",
                    help="the --adaptive gear bank: comma-separated "
                         "name:lam pairs (quality-first order is "
                         "derived from solved work, not list order)")
    ap.add_argument("--recal-interval", type=float, default=None,
                    help="seconds of serve time between online table "
                         "re-fits from observed outcomes (--adaptive; "
                         "sim steppers only — the engine path serves "
                         "gear switching without recalibration)")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-request deadline budget from arrival: "
                         "expired requests are reaped mid-stream "
                         "(pages released, counted timed_out) and "
                         "escalations the deadline cannot afford are "
                         "denied by the degrade governor")
    ap.add_argument("--cancel-rate", type=float, default=0.0,
                    help="seeded per-request probability of a client "
                         "cancellation shortly after arrival (chaos "
                         "input; deterministic in --seed)")
    ap.add_argument("--faults", default=None, metavar="PLAN.json",
                    help="serve under a faults/v1 chaos script "
                         "(FaultPlan.save): scripted cancellations, "
                         "deadlines, rung-stall windows and KV page "
                         "squeezes")
    ap.add_argument("--kv-reclaim", type=float, default=None,
                    metavar="FRAC",
                    help="paged-KV occupancy watermark in (0,1]: above "
                         "it admission pressure clips attention history "
                         "off the longest lanes (sliding-window "
                         "reclamation) instead of refusing admission")
    ap.add_argument("--no-governor", action="store_true",
                    help="serve faults WITHOUT the degrade governor "
                         "(escalations park past their deadlines)")
    ap.add_argument("--json", default=None,
                    help="write runtime metrics JSON here")
    ap.add_argument("--trace-out", default=None,
                    help="write a Chrome/Perfetto trace-event JSON of "
                         "the serve here (open in ui.perfetto.dev; "
                         "--server modes only)")
    ap.add_argument("--metrics-out", default=None,
                    help="write the metrics-registry snapshot JSON "
                         "here (every number the console report "
                         "shows, as labelled series)")
    ap.add_argument("--flight-recorder", default=None, metavar="DIR",
                    help="arm the anomaly flight recorder: post-mortem "
                         "bundles (triggering request's span history + "
                         "last events + metrics) land in DIR on TTFT-"
                         "SLO breach bursts, page exhaustion, stuck "
                         "escalation waiters, or gear thrash")
    ap.add_argument("--obs-dir", default=None, metavar="DIR",
                    help="one-flag observability bundle: write the "
                         "Perfetto trace, the lossless obs_trace/v1 "
                         "event log, the metrics snapshot, flight "
                         "bundles, AND the invariant-ledger report "
                         "into DIR (arms the audit ledger; subsumes "
                         "--trace-out/--metrics-out/--flight-recorder, "
                         "which still win for their own sink)")
    ap.add_argument("--regret", action="store_true",
                    help="arm the decision-quality regret meter: "
                         "per-request regret against the offline-optimal "
                         "walk over the calibrated tables, decomposed by "
                         "cause, plus the streaming accuracy-latency "
                         "Pareto frontier.  Report sections always; "
                         "regret.json + pareto.json under --obs-dir; a "
                         "regret counter track in --trace-out")
    ap.add_argument("--profile-dir", default=None, metavar="DIR",
                    help="capture a torch.profiler trace (host, and on "
                         "the card its kernels and copies) around the "
                         "serve loop into DIR/profile_trace.json; fails "
                         "rather than writing an empty capture")
    args = ap.parse_args(argv)
    if args.lanes is None:
        args.lanes = args.batch
    if args.cascade_lanes is None:
        args.cascade_lanes = max(1, args.lanes // 2)
    if args.cascade:
        args.server = True
    if args.adaptive:
        args.server = True
        if args.cascade:
            raise SystemExit("--adaptive and --cascade are separate "
                             "serving modes; pick one")
    return args


def _serve_batch(args, cfg, params, strat, device) -> BatchRun:
    """The one-shot path: one fixed batch of numpy-seeded prompts,
    prefilled together and decoded to ``--tokens`` on ring caches."""
    engine = Engine(params, cfg, strat, cache_len=args.cache_len,
                    use_flash=args.flash, use_ssd_kernel=args.ssd_kernel)
    prompts = np.random.default_rng(args.seed + 1).integers(
        0, cfg.vocab, (args.batch, args.prompt_len)).astype(np.int32)
    t0 = time.time()
    with torch.no_grad():
        stats = engine.generate(
            {"tokens": torch.as_tensor(prompts, device=device)},
            args.tokens)
    dt = time.time() - t0
    n_nodes = cfg.n_ramps + 1
    print(f"generated {args.batch}x{args.tokens} tokens in {dt:.2f}s "
          f"({args.batch * args.tokens / dt:.1f} tok/s)")
    print(segments_saved_line(stats.segments_run_batch,
                              stats.segments_run_policy,
                              steps=args.tokens, n_seg=len(cfg.segments),
                              lane_steps=args.tokens * args.batch))
    print(f"served-node histogram: "
          f"{np.bincount(stats.served_nodes.ravel(), minlength=n_nodes)}")
    return BatchRun(prompts=prompts, stats=stats)


def _workload(args, vocab: int, name: str) -> list:
    lo = max(1, min(4, args.tokens))
    spec = WorkloadSpec(rate=args.rate, duration=args.duration,
                        prompt_len=args.prompt_len, vocab=vocab,
                        max_tokens=(lo, args.tokens), seed=args.seed,
                        strategy=name)
    requests = make_workload(args.workload, spec)
    if not requests:
        print("workload produced no arrivals; raise --rate or --duration")
    return requests


def _fault_plan(args, requests):
    """The fault plane's launch wiring: load the ``--faults`` chaos
    script and/or draw seeded per-request faults from ``--deadline-ms``
    / ``--cancel-rate``, then stamp the request-borne faults onto the
    workload.  Returns ``(plan, stamped_requests)``; ``(None,
    requests)`` when no fault flag is set."""
    plan = None
    if args.faults:
        plan = FaultPlan.load(args.faults)
    if args.cancel_rate or args.deadline_ms is not None:
        gen = FaultPlan.generate(
            requests, seed=args.seed + 7, cancel_rate=args.cancel_rate,
            deadline=(args.deadline_ms / 1e3
                      if args.deadline_ms is not None else None))
        if plan is None:
            plan = gen
        else:
            # a scripted plan wins per rid; flags fill the gaps
            gen.cancel_at.update(plan.cancel_at)
            gen.deadline.update(plan.deadline)
            plan.cancel_at, plan.deadline = gen.cancel_at, gen.deadline
    if plan is not None:
        requests = plan.stamp(requests)
    return plan, requests


def _governor(args, plan):
    """A `DegradeGovernor` when faults are active and not opted out."""
    if plan is None or args.no_governor:
        return None
    return DegradeGovernor()


def _set_reclaim(args, *pools) -> None:
    """Arm ``--kv-reclaim`` on every paged pool the stepper built."""
    if args.kv_reclaim is None:
        return
    if not 0.0 < args.kv_reclaim <= 1.0:
        raise SystemExit(f"--kv-reclaim {args.kv_reclaim} outside (0, 1]")
    for pool in pools:
        if pool is not None:
            pool.reclaim_watermark = float(args.kv_reclaim)


def _build_obs(args, *, policy=None, boundaries=None, casc=None,
               ) -> Observability | None:
    """The observability plane, built only when asked — a ``None`` obs
    keeps every producer guard dead and the serve loop as it is without
    tracing.

    ``--obs-dir DIR`` is the one-flag bundle: it defaults every sink
    the separate flags name into DIR (trace.json, events.json,
    metrics.json, flight bundles) and additionally arms the
    `InvariantLedger` (audit contracts + ledger.json); explicit flags
    still win for their own sink.  ``--regret`` arms the `RegretMeter`
    against the serve's calibrated `Cascade` — another pure tracer
    listener, like the ledger.
    """
    if args.obs_dir:
        os.makedirs(args.obs_dir, exist_ok=True)
        args.trace_out = args.trace_out or \
            os.path.join(args.obs_dir, "trace.json")
        args.metrics_out = args.metrics_out or \
            os.path.join(args.obs_dir, "metrics.json")
        args.flight_recorder = args.flight_recorder or args.obs_dir
    if not (args.trace_out or args.metrics_out or args.flight_recorder
            or args.profile_dir or args.regret):
        return None
    flight = None
    if args.flight_recorder:
        os.makedirs(args.flight_recorder, exist_ok=True)
        flight = FlightRecorder(out_dir=args.flight_recorder)
    ledger = None
    if args.obs_dir:
        ledger = InvariantLedger(policy=policy, boundaries=boundaries,
                                 out_dir=args.obs_dir)
    regret = RegretMeter(casc) if args.regret else None
    return Observability(flight=flight, ledger=ledger, regret=regret,
                         profile_dir=args.profile_dir)


def _finish_obs(args, obs: Observability | None,
                report: ServeReport, *, faults=None) -> None:
    """Render the report, then the sinks: trace stats fold into the
    report first (so they land in the metrics snapshot too), then the
    Perfetto trace and the registry snapshot, if asked for.  A
    `FaultPlan` the serve ran under is embedded in the trace and events
    artifacts (``faults/v1``) so a replay reproduces the chaos."""
    if obs is not None:
        report.add_trace(obs.tracer, obs.flight)
        if obs.ledger is not None:
            report.add_ledger(obs.ledger.report())
        # always rendered, even for an empty or overflowed ring: an
        # explicit zero over silence
        report.add_lossmap(goodput_lossmap(
            obs.tracer.events, slo=args.slo_ms / 1e3))
        if obs.regret is not None:
            # listeners see every emission — a ring overflow does not
            # taint the meter, so the report stays asserted
            report.add_regret(obs.regret.report())
            report.add_pareto(obs.regret.pareto.as_doc())
    report.print()
    if obs is not None and args.trace_out:
        write_trace(obs.tracer, args.trace_out, faults=faults,
                    regret=obs.regret)
        print(f"wrote Perfetto trace to {args.trace_out} "
              "(load in ui.perfetto.dev)")
    if args.metrics_out:
        report.registry.to_json(args.metrics_out)
        print(f"wrote metrics snapshot to {args.metrics_out}")
    if obs is not None and args.obs_dir:
        write_events(obs.tracer, os.path.join(args.obs_dir, "events.json"),
                     faults=faults)
        if obs.ledger is not None:
            with open(os.path.join(args.obs_dir, "ledger.json"), "w") as f:
                json.dump(obs.ledger.report(), f, indent=1, default=float)
        if obs.regret is not None:
            with open(os.path.join(args.obs_dir, "regret.json"), "w") as f:
                json.dump(obs.regret.report(), f, indent=1, default=float)
            with open(os.path.join(args.obs_dir, "pareto.json"), "w") as f:
                json.dump(obs.regret.pareto.as_doc(), f, indent=1,
                          default=float)
        print(f"wrote observability bundle to {args.obs_dir} "
              "(trace + events + metrics + ledger"
              + (" + regret + pareto" if obs.regret is not None else "")
              + ")")
    if obs is not None and obs.flight is not None and obs.flight.bundles:
        print(f"flight recorder: {len(obs.flight.bundles)} anomaly "
              f"bundle(s) in {args.flight_recorder}")


def parse_gears(text: str):
    """``--gears`` grammar: comma-separated ``name:lam`` pairs (a bare
    ``lam`` gets an auto name), e.g. ``quality:0.95,turbo:0.75``."""
    specs = []
    for part in text.split(","):
        part = part.strip()
        if not part:
            continue
        if ":" in part:
            gname, lam = part.split(":", 1)
        else:
            gname, lam = f"g{part}", part
        specs.append(GearSpec(gname.strip(), float(lam)))
    if not specs:
        raise SystemExit(f"--gears {text!r} names no gears")
    return tuple(specs)


def _build_adaptive(args, cfg, params, device, *, mean_tokens, slo):
    """The --adaptive control plane: gear traces from the model's own
    losses on numpy-seeded prompts, the bank solved and priced, the
    controller built.  Capacity is priced in the sim cost model's
    virtual units (probes per token at nominal segment time) — gear
    ORDER and the relative thresholds are what selection runs on."""
    toks = np.random.default_rng(args.seed + 1).integers(
        0, cfg.vocab, (GEAR_PROMPTS, GEAR_LEN))
    with torch.no_grad():
        _, _, node_losses, _ = M.prefill(
            params, cfg, {"tokens": torch.as_tensor(toks, device=device)},
            GEAR_CACHE, use_flash=args.flash,
            use_ssd_kernel=args.ssd_kernel)
    rows = node_losses.cpu().numpy().astype(np.float64)
    n = rows.shape[1]
    planner = GearPlanner(rows, np.full(n, 1.0 / n), k=GEAR_K,
                          seg_time=0.01, overhead=0.002,
                          n_lanes=args.lanes, mean_tokens=mean_tokens,
                          device=device)
    gear_bank = planner.plan(parse_gears(args.gears))
    controller = AdaptiveController(
        gear_bank, span=max(2.0, args.duration / 5), slo=slo,
        recal_interval=args.recal_interval, planner=planner)
    print("gear bank (quality-first): " + ", ".join(
        f"{g.name}[slot {g.slot}] lam={g.spec.lam:g} "
        f"work={g.work:.2f} max_rate={g.max_rate:.1f}/s"
        for g in gear_bank))
    return gear_bank, controller


def _serve_traffic(args, cfg, params, casc, device) -> ServeRun | None:
    """The ``--server`` path: a seeded open-loop workload through the
    continuous-batching runtime."""
    name = ALIASES.get(args.policy, args.policy)
    requests = _workload(args, cfg.vocab, name)
    if not requests:
        return None

    controller = None
    slo = args.slo_ms / 1e3
    if args.adaptive:
        lo = max(1, min(4, args.tokens))
        gear_bank, controller = _build_adaptive(
            args, cfg, params, device, mean_tokens=(lo + args.tokens) / 2,
            slo=slo)
        bank, sid_of = gear_bank.strategies, controller.sid_of
        if args.recal_interval is not None:
            print("note: the engine stepper has no swappable array "
                  "bank — --adaptive serves gear SWITCHING here; "
                  "--recal-interval applies to sim steppers")
    else:

        def make_strategy(sname, lam):
            return build_strategy(sname, casc, threshold=args.threshold,
                                  patience=args.patience, lam=lam)

        bank, sid_of = rt.build_bank(requests, make_strategy, (name, None))
    plan, requests = _fault_plan(args, requests)
    stepper = rt.EngineStepper(params, cfg, bank, n_lanes=args.lanes,
                               cache_len=args.cache_len,
                               prompt_len=args.prompt_len, kv=args.kv,
                               page_size=args.page_size,
                               n_pages=args.pages,
                               paged_kernel=args.paged_kernel,
                               prefill_chunk=args.prefill_chunk,
                               prefill_budget=args.prefill_budget,
                               use_flash=args.flash,
                               use_ssd_kernel=args.ssd_kernel)
    if plan is not None:
        # single-model engine: request-borne faults plus page squeezes
        # (the Server reads the plan off the stepper each step)
        stepper.faults = plan
    _set_reclaim(args, stepper.pool)
    obs = _build_obs(args, casc=casc)
    server = rt.Server(stepper, rt.LaneScheduler(args.lanes), sid_of,
                       order=args.order, slo=slo, eos=args.eos,
                       controller=controller, obs=obs,
                       enforce_deadlines=bool(plan and plan.deadline))
    kv_desc = args.kv if args.kv == "ring" else (
        f"paged ({stepper.pool.n_pages} pages x {args.page_size} tokens)")
    if args.prefill_chunk:
        kv_desc += (f", chunked prefill ({args.prefill_chunk}-token "
                    f"chunks, {stepper.planner.budget} tokens/step)")
    policy_desc = (f"adaptive gears ({args.gears})" if controller
                   else f"policy {name}")
    print(f"serving {len(requests)} {args.workload} requests "
          f"(rate {args.rate}/s x {args.duration}s) on {args.lanes} lanes, "
          f"{policy_desc}, order {args.order}, kv {kv_desc}, device "
          f"{device}, paged kernels "
          f"{'on' if args.paged_kernel else 'off'}, flash "
          f"{'on' if args.flash else 'off'}, ssd kernel "
          f"{'on' if args.ssd_kernel else 'off'}, "
          f"SLO ttft<={args.slo_ms:.0f}ms ...")
    with torch.no_grad(), profiler_capture(args.profile_dir, device):
        metrics = server.serve(requests)
    report = ServeReport()
    report.add_runtime(metrics.summary(slo=slo), slo_ms=args.slo_ms)
    if controller is not None:
        report.add_adaptive(controller.stats())
    report.add_segments(metrics.seg_batch, metrics.seg_policy,
                        steps=metrics.steps, n_seg=len(cfg.segments),
                        lane_steps=metrics.lane_steps)
    pool_stats = None
    if stepper.pool is not None:
        pool_stats = stepper.pool.stats()
        report.add_pool(pool_stats)
    if args.prefill_chunk:
        report.add_chunked_prefill(stepper.chunk_stats)
    _finish_obs(args, obs, report, faults=plan)
    if args.json:
        extra = {"policy": name, "rate": args.rate, "lanes": args.lanes,
                 "kv": args.kv, "prefill_chunk": args.prefill_chunk,
                 "device": str(device), "paged_kernel": args.paged_kernel,
                 "flash": args.flash, "ssd_kernel": args.ssd_kernel}
        if controller is not None:
            extra["adaptive"] = controller.stats()
        if pool_stats is not None:
            extra["kv_pool"] = pool_stats
        if args.prefill_chunk:
            extra["chunked_prefill"] = stepper.chunk_stats
        metrics.to_json(args.json, slo=slo, extra=extra)
        print(f"wrote metrics JSON to {args.json}")
    return ServeRun(requests=requests, metrics=metrics, stepper=stepper,
                    cascade=casc, controller=controller, faults=plan,
                    obs=obs)


def _calibrate_multi(cfgs, params_list, tokens, lam, *,
                     k: int = MULTI_K) -> strategy.Cascade:
    """Multi-model calibration: every ladder model prefills the SAME
    ``(T, seq)`` prompts ``tokens``; the concatenated per-node losses
    become one `Cascade` with model boundaries, per-node costs weighted
    by each model's backbone FLOPs share."""
    device = params_list[0]["embed"]["table"].device
    tokens = torch.as_tensor(tokens).to(device)
    model_losses, weights = [], []
    for cfg, params in zip(cfgs, params_list):
        with torch.no_grad():
            _, _, node_losses, _ = M.prefill(params, cfg, {"tokens": tokens},
                                             tokens.shape[1] + 8)
        model_losses.append(node_losses.cpu().numpy())
        # FLOPs proxy: layers x d_model^2 (dense decode cost order)
        layers = sum(seg.n_layers for seg in cfg.segments)
        weights.append(layers * cfg.d_model ** 2)
    base = weights[0]
    model_costs = [
        (1.0 - lam) * np.full((ls.shape[1],), (w / base) / ls.shape[1])
        for ls, w in zip(model_losses, weights)]
    return strategy.Cascade.from_model_traces(model_losses, model_costs,
                                              k=k, lam=lam, solve=False,
                                              device=device)


def _serve_cascade(args, device) -> ServeRun | None:
    """``--cascade A:B[:C]`` — a ladder of models in ONE process, served
    as a T-Tamer multi-stage decision process on the paged pool."""
    from repro_torch.serving.cascade import (CascadeEngineStepper,
                                             ModelBank, ModelSpec)
    arch_names = args.cascade.split(":")
    if len(arch_names) < 2:
        raise SystemExit("--cascade needs at least two ':'-separated "
                         "arch names (e.g. qwen3-4b:qwen3-14b)")
    cfgs = [get_config(a, smoke=args.smoke) for a in arch_names]
    vocabs = {cfg.vocab for cfg in cfgs}
    if len(vocabs) > 1:
        # fail BEFORE the multi-model calibration
        raise SystemExit(
            f"--cascade models must share tokenization (one vocab); "
            f"got {sorted(vocabs)} for {arch_names}")
    params_list = [
        materialize(M.model_defs(cfg),
                    torch.Generator(device=device).manual_seed(args.seed + i),
                    device)
        for i, cfg in enumerate(cfgs)]
    ladder = " -> ".join(f"{a} ({cfg.n_ramps + 1} nodes)"
                         for a, cfg in zip(arch_names, cfgs))
    print(f"cascade ladder: {ladder} (random init demo)")

    name = ALIASES.get(args.policy, args.policy)
    n_total = sum(cfg.n_ramps + 1 for cfg in cfgs)
    if strategy.needs_tables(name):
        gen = torch.Generator(device=device).manual_seed(args.seed + 1)
        tokens = torch.randint(0, cfgs[0].vocab, (MULTI_PROMPTS, MULTI_LEN),
                               generator=gen, device=device)
        casc, calib_s = _timed(device, _calibrate_multi, cfgs,
                               params_list, tokens, args.lam)
    else:
        calib_s = 0.0
        casc = strategy.Cascade.uniform(
            n_total, lam=args.lam,
            boundaries=tuple(cfg.n_ramps + 1 for cfg in cfgs),
            device=device)

    lanes = [args.lanes] + [args.cascade_lanes] * (len(cfgs) - 1)
    # rung-indexed spec names keep prefix caches apart even when the
    # same arch appears twice (distinct weights = distinct KV bytes)
    bank = ModelBank([
        ModelSpec(f"{i}:{a}", cfg.n_ramps + 1, n_lanes=n, cfg=cfg,
                  params=p)
        for i, (a, cfg, p, n) in enumerate(
            zip(arch_names, cfgs, params_list, lanes))])
    requests = _workload(args, cfgs[0].vocab, name)
    if not requests:
        return None

    def make_strategy(sname, lam):
        return build_strategy(sname, casc, threshold=args.threshold,
                              patience=args.patience, lam=lam)

    plan, requests = _fault_plan(args, requests)
    strat_bank, sid_of = rt.build_bank(requests, make_strategy,
                                       (name, None))
    stepper = CascadeEngineStepper(
        bank, strat_bank, cache_len=args.cache_len,
        prompt_len=args.prompt_len, page_size=args.page_size,
        chunk=args.prefill_chunk or 8,
        budgets=([args.prefill_budget] * len(cfgs)
                 if args.prefill_budget else None),
        pages=([args.pages] * len(cfgs) if args.pages else None),
        policy=args.escalate_policy, patience=args.escalate_patience,
        paged_kernel=args.paged_kernel,
        faults=plan, governor=_governor(args, plan))
    _set_reclaim(args, *(st.pool for st in stepper.steppers))
    slo = args.slo_ms / 1e3
    obs = _build_obs(args, policy=args.escalate_policy,
                     boundaries=casc.boundaries, casc=casc)
    server = rt.Server(stepper, rt.LaneScheduler(args.lanes), sid_of,
                       order=args.order, slo=slo, eos=args.eos, obs=obs,
                       enforce_deadlines=bool(plan and plan.deadline))
    print(f"serving {len(requests)} {args.workload} requests "
          f"(rate {args.rate}/s x {args.duration}s) on a "
          f"{'->'.join(arch_names)} cascade "
          f"({'+'.join(str(n) for n in lanes)} lanes), policy {name}, "
          f"escalate-policy {args.escalate_policy} "
          f"(patience {args.escalate_patience}), device {device}, paged "
          f"kernels {'on' if args.paged_kernel else 'off'}, "
          f"SLO ttft<={args.slo_ms:.0f}ms ...")
    with torch.no_grad(), profiler_capture(args.profile_dir, device):
        metrics = server.serve(requests)
    cs = stepper.cascade_stats()
    report = ServeReport()
    report.add_runtime(metrics.summary(slo=slo), slo_ms=args.slo_ms)
    report.add_segments(metrics.seg_batch, metrics.seg_policy,
                        steps=metrics.steps, n_seg=bank.n_total,
                        lane_steps=metrics.lane_steps)
    report.add_cascade(cs)
    _finish_obs(args, obs, report, faults=plan)
    if args.json:
        extra = {"policy": name, "rate": args.rate, "lanes": args.lanes,
                 "cascade": args.cascade, "device": str(device),
                 "escalate_policy": args.escalate_policy,
                 "paged_kernel": args.paged_kernel, "cascade_stats": cs}
        metrics.to_json(args.json, slo=slo, extra=extra)
        print(f"wrote metrics JSON to {args.json}")
    return ServeRun(requests=requests, metrics=metrics, stepper=stepper,
                    cascade=casc, cascade_stats=cs, faults=plan, obs=obs,
                    calib_s=calib_s)


def main(argv=None) -> ServeRun | BatchRun | None:
    args = parse_args(argv)
    device = _device(args.device)
    if args.cascade:
        return _serve_cascade(args, device)
    cfg = get_config(args.arch, smoke=args.smoke)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = materialize(M.model_defs(cfg), gen, device)
    print("no checkpoint given — serving random init (demo mode)")

    name = ALIASES.get(args.policy, args.policy)
    if strategy.needs_tables(name):
        # table-backed strategies calibrate on the model's own losses,
        # over prompts drawn with numpy from --seed; the line or skip
        # solve runs when the strategy is built
        tokens = np.random.default_rng(args.seed).integers(
            0, cfg.vocab, (CALIB_PROMPTS, CALIB_LEN))
        casc, calib_s = _timed(device, strategy.Cascade.calibrate, params,
                               cfg, tokens, args.lam, k=CALIB_K,
                               solve=False, use_flash=args.flash,
                               use_ssd_kernel=args.ssd_kernel,
                               use_kernel=args.dp_kernel)
    else:
        calib_s = 0.0
        # topology/costs-only strategies skip the calibration prefill
        casc = strategy.Cascade.uniform(cfg.n_ramps + 1, lam=args.lam,
                                        device=device)
    strat = build_strategy(name, casc, threshold=args.threshold,
                           patience=args.patience)
    if casc.line_tables is not None:
        tables = casc.line_tables
        print(f"calibrated T-Tamer tables: n={tables.n} K={tables.k} "
              f"online-optimal value {float(tables.value):.4f}")
    print(f"strategy: {name} (registry: {', '.join(strategy.available())})")

    if args.server:
        run = _serve_traffic(args, cfg, params, casc, device)
    else:
        if args.kv != "ring":
            print("note: --kv paged applies to --server traffic mode; "
                  "the one-shot batch path always uses ring caches")
        if (args.trace_out or args.metrics_out or args.flight_recorder
                or args.obs_dir or args.regret):
            print("note: --trace-out/--metrics-out/--flight-recorder/"
                  "--obs-dir/--regret observe --server traffic "
                  "sessions; the one-shot batch path has no request "
                  "lifecycle to trace")
        run = _serve_batch(args, cfg, params, strat, device)
    if run is not None:
        run.calib_s = calib_s
    return run


if __name__ == "__main__":
    main()
