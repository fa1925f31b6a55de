"""Serving launcher of the port: initializes a model from a seed,
calibrates a `Cascade` on numpy-seeded prompts, builds the requested
strategy from the registry, and serves a seeded open-loop workload with
continuous batching on the paged KV pool and chunked prefill:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch paper-ee-100m \
      --server --kv paged --prefill-chunk 16 --paged-kernel \
      --policy recall_index --lanes 8 --rate 8 --duration 2 --tokens 16

It runs on the card (``--device cuda``, the default) and refuses to go
on when CUDA is missing; ``--device cpu`` runs the same path with the
kernels' plain PyTorch versions.  ``--paged-kernel`` sends every paged
decode and every prefill chunk through the CUDA kernels.
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch import strategy
from repro_torch.configs import get_config
from repro_torch.models import model as M
from repro_torch.models.param import materialize
from repro_torch.serving import runtime as rt
from repro_torch.serving.obs.report import ServeReport
from repro_torch.serving.runtime.workload import WorkloadSpec, make_workload

__all__ = ["main", "ServeRun"]

CALIB_PROMPTS, CALIB_LEN, CALIB_K = 512, 64, 24
SLO_S = 1.0        # the TTFT limit that goodput counts against


@dataclasses.dataclass
class ServeRun:
    """What one ``main`` call served, for callers that check it."""

    requests: list
    metrics: rt.RuntimeMetrics
    stepper: rt.EngineStepper
    cascade: strategy.Cascade


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
                    choices=strategy.available())
    ap.add_argument("--lam", type=float, default=0.5)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default cuda; the "
                         "launcher never falls back to the CPU)")
    ap.add_argument("--server", action="store_true",
                    help="serve an open-loop workload with continuous "
                         "batching; required, as it is the port's only "
                         "serving mode (kept so that the reference "
                         "launcher's command lines run unchanged)")
    ap.add_argument("--rate", type=float, default=8.0,
                    help="mean arrivals/sec")
    ap.add_argument("--duration", type=float, default=5.0,
                    help="arrival window in seconds")
    ap.add_argument("--lanes", type=int, default=8, help="lane count")
    ap.add_argument("--kv", default="paged", choices=("paged",),
                    help="decode KV memory: the paged pool, the port's "
                         "only one (kept so that the reference launcher's "
                         "command lines run unchanged)")
    ap.add_argument("--page-size", type=int, default=16,
                    help="tokens per KV page")
    ap.add_argument("--pages", type=int, default=None,
                    help="total pool pages (default: lanes x "
                         "ceil(cache_len/page_size) + 1)")
    ap.add_argument("--paged-kernel", action="store_true",
                    help="run paged decode and prefill chunks through the "
                         "CUDA kernels (plain PyTorch on --device cpu)")
    ap.add_argument("--prefill-chunk", type=int, default=16,
                    help="prompt tokens per prefill chunk, co-scheduled "
                         "with decode")
    ap.add_argument("--prefill-budget", type=int, default=None,
                    help="max prompt tokens prefilled per step across "
                         "all admitting lanes (default: --prefill-chunk)")
    ap.add_argument("--json", default=None,
                    help="write runtime metrics JSON here")
    return ap.parse_args(argv)


def main(argv=None) -> ServeRun | None:
    args = parse_args(argv)
    if not args.server:
        raise SystemExit("the port serves --server traffic only")
    device = _device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = materialize(M.model_defs(cfg), gen, device)
    print("no checkpoint given — serving random init (demo mode)")

    name = args.policy
    if strategy.needs_tables(name):
        # table-backed strategies calibrate on the model's own losses,
        # over prompts drawn with numpy from --seed
        tokens = np.random.default_rng(args.seed).integers(
            0, cfg.vocab, (CALIB_PROMPTS, CALIB_LEN))
        casc = strategy.Cascade.calibrate(params, cfg, tokens, args.lam,
                                          k=CALIB_K)
        tables = casc.line_tables
        print(f"calibrated T-Tamer tables: n={tables.n} K={tables.k} "
              f"online-optimal value {float(tables.value):.4f}")
    else:
        casc = strategy.Cascade.uniform(cfg.n_ramps + 1, lam=args.lam,
                                        device=device)
    print(f"strategy: {name} (registry: {', '.join(strategy.available())})")

    lo = max(1, min(4, args.tokens))
    spec = WorkloadSpec(rate=args.rate, duration=args.duration,
                        prompt_len=args.prompt_len, vocab=cfg.vocab,
                        max_tokens=(lo, args.tokens), seed=args.seed,
                        strategy=name)
    requests = make_workload("poisson", spec)
    if not requests:
        print("workload produced no arrivals; raise --rate or --duration")
        return None
    bank, sid_of = rt.build_bank(requests, rt.cascade_factory(casc),
                                 (name, None))
    stepper = rt.EngineStepper(params, cfg, bank, n_lanes=args.lanes,
                               cache_len=args.cache_len,
                               prompt_len=args.prompt_len,
                               page_size=args.page_size,
                               n_pages=args.pages,
                               paged_kernel=args.paged_kernel,
                               prefill_chunk=args.prefill_chunk,
                               prefill_budget=args.prefill_budget)
    server = rt.Server(stepper, rt.LaneScheduler(args.lanes), sid_of)
    print(f"serving {len(requests)} poisson requests "
          f"(rate {args.rate}/s x {args.duration}s) on {args.lanes} lanes, "
          f"policy {name}, kv paged ({stepper.pool.n_pages} pages x "
          f"{args.page_size} tokens), chunked prefill "
          f"({args.prefill_chunk}-token chunks, {stepper.planner.budget} "
          f"tokens/step), device {device}, paged kernels "
          f"{'on' if args.paged_kernel else 'off'}, "
          f"SLO ttft<={SLO_S * 1e3:.0f}ms ...")
    with torch.no_grad():
        metrics = server.serve(requests)
    report = ServeReport()
    report.add_runtime(metrics.summary(slo=SLO_S), slo_ms=SLO_S * 1e3)
    report.add_segments(metrics.seg_batch, metrics.seg_policy,
                        steps=metrics.steps, n_seg=len(cfg.segments),
                        lane_steps=metrics.lane_steps)
    pool_stats = stepper.pool.stats()
    report.add_pool(pool_stats)
    report.add_chunked_prefill(stepper.chunk_stats)
    report.print()
    if args.json:
        extra = {"policy": name, "rate": args.rate, "lanes": args.lanes,
                 "kv": args.kv, "prefill_chunk": args.prefill_chunk,
                 "device": str(device), "paged_kernel": args.paged_kernel,
                 "kv_pool": pool_stats,
                 "chunked_prefill": stepper.chunk_stats}
        metrics.to_json(args.json, slo=SLO_S, extra=extra)
        print(f"wrote metrics JSON to {args.json}")
    return ServeRun(requests=requests, metrics=metrics, stepper=stepper,
                    cascade=casc)


if __name__ == "__main__":
    main()
