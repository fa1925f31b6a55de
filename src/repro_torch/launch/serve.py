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
import time

import numpy as np
import torch

from repro_torch import strategy
from repro_torch.configs import get_config
from repro_torch.models import model as M
from repro_torch.models.param import materialize
from repro_torch.serving import runtime as rt
from repro_torch.serving.engine import Engine, GenerationStats
from repro_torch.serving.obs.report import ServeReport, segments_saved_line
from repro_torch.serving.runtime.workload import WorkloadSpec, make_workload

__all__ = ["main", "ServeRun", "BatchRun", "ALIASES", "ONLINE",
           "build_strategy"]

CALIB_PROMPTS, CALIB_LEN, CALIB_K = 512, 64, 24
# the cascade's calibration: prompts x length, support size (the JAX
# launcher's _calibrate_multi)
MULTI_PROMPTS, MULTI_LEN, MULTI_K = 128, 32, 16

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
    (``cascade_stats`` only for ``--cascade``)."""

    requests: list
    metrics: rt.RuntimeMetrics
    stepper: object               # EngineStepper | CascadeEngineStepper
    cascade: strategy.Cascade
    cascade_stats: dict | None = None


@dataclasses.dataclass
class BatchRun:
    """What one one-shot ``main`` call (no ``--server``) generated."""

    prompts: np.ndarray            # (batch, prompt_len) i32
    stats: GenerationStats


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
    ap.add_argument("--json", default=None,
                    help="write runtime metrics JSON here")
    args = ap.parse_args(argv)
    if args.lanes is None:
        args.lanes = args.batch
    if args.cascade_lanes is None:
        args.cascade_lanes = max(1, args.lanes // 2)
    if args.cascade:
        args.server = True
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


def _serve_traffic(args, cfg, params, casc, device) -> ServeRun | None:
    """The ``--server`` path: a seeded open-loop workload through the
    continuous-batching runtime."""
    name = ALIASES.get(args.policy, args.policy)
    requests = _workload(args, cfg.vocab, name)
    if not requests:
        return None

    def make_strategy(sname, lam):
        return build_strategy(sname, casc, threshold=args.threshold,
                              patience=args.patience, lam=lam)

    bank, sid_of = rt.build_bank(requests, make_strategy, (name, None))
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
    slo = args.slo_ms / 1e3
    server = rt.Server(stepper, rt.LaneScheduler(args.lanes), sid_of,
                       order=args.order, slo=slo, eos=args.eos)
    kv_desc = args.kv if args.kv == "ring" else (
        f"paged ({stepper.pool.n_pages} pages x {args.page_size} tokens)")
    if args.prefill_chunk:
        kv_desc += (f", chunked prefill ({args.prefill_chunk}-token "
                    f"chunks, {stepper.planner.budget} tokens/step)")
    print(f"serving {len(requests)} {args.workload} requests "
          f"(rate {args.rate}/s x {args.duration}s) on {args.lanes} lanes, "
          f"policy {name}, order {args.order}, kv {kv_desc}, device "
          f"{device}, paged kernels "
          f"{'on' if args.paged_kernel else 'off'}, flash "
          f"{'on' if args.flash else 'off'}, ssd kernel "
          f"{'on' if args.ssd_kernel else 'off'}, "
          f"SLO ttft<={args.slo_ms:.0f}ms ...")
    with torch.no_grad():
        metrics = server.serve(requests)
    report = ServeReport()
    report.add_runtime(metrics.summary(slo=slo), slo_ms=args.slo_ms)
    report.add_segments(metrics.seg_batch, metrics.seg_policy,
                        steps=metrics.steps, n_seg=len(cfg.segments),
                        lane_steps=metrics.lane_steps)
    pool_stats = None
    if stepper.pool is not None:
        pool_stats = stepper.pool.stats()
        report.add_pool(pool_stats)
    if args.prefill_chunk:
        report.add_chunked_prefill(stepper.chunk_stats)
    report.print()
    if args.json:
        extra = {"policy": name, "rate": args.rate, "lanes": args.lanes,
                 "kv": args.kv, "prefill_chunk": args.prefill_chunk,
                 "device": str(device), "paged_kernel": args.paged_kernel,
                 "flash": args.flash, "ssd_kernel": args.ssd_kernel}
        if pool_stats is not None:
            extra["kv_pool"] = pool_stats
        if args.prefill_chunk:
            extra["chunked_prefill"] = stepper.chunk_stats
        metrics.to_json(args.json, slo=slo, extra=extra)
        print(f"wrote metrics JSON to {args.json}")
    return ServeRun(requests=requests, metrics=metrics, stepper=stepper,
                    cascade=casc)


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
        casc = _calibrate_multi(cfgs, params_list, tokens, args.lam)
    else:
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
        paged_kernel=args.paged_kernel)
    slo = args.slo_ms / 1e3
    server = rt.Server(stepper, rt.LaneScheduler(args.lanes), sid_of,
                       order=args.order, slo=slo, eos=args.eos)
    print(f"serving {len(requests)} {args.workload} requests "
          f"(rate {args.rate}/s x {args.duration}s) on a "
          f"{'->'.join(arch_names)} cascade "
          f"({'+'.join(str(n) for n in lanes)} lanes), policy {name}, "
          f"escalate-policy {args.escalate_policy} "
          f"(patience {args.escalate_patience}), device {device}, paged "
          f"kernels {'on' if args.paged_kernel else 'off'}, "
          f"SLO ttft<={args.slo_ms:.0f}ms ...")
    with torch.no_grad():
        metrics = server.serve(requests)
    cs = stepper.cascade_stats()
    report = ServeReport()
    report.add_runtime(metrics.summary(slo=slo), slo_ms=args.slo_ms)
    report.add_segments(metrics.seg_batch, metrics.seg_policy,
                        steps=metrics.steps, n_seg=bank.n_total,
                        lane_steps=metrics.lane_steps)
    report.add_cascade(cs)
    report.print()
    if args.json:
        extra = {"policy": name, "rate": args.rate, "lanes": args.lanes,
                 "cascade": args.cascade, "device": str(device),
                 "escalate_policy": args.escalate_policy,
                 "paged_kernel": args.paged_kernel, "cascade_stats": cs}
        metrics.to_json(args.json, slo=slo, extra=extra)
        print(f"wrote metrics JSON to {args.json}")
    return ServeRun(requests=requests, metrics=metrics, stepper=stepper,
                    cascade=casc, cascade_stats=cs)


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
        casc = strategy.Cascade.calibrate(params, cfg, tokens, args.lam,
                                          k=CALIB_K, solve=False,
                                          use_flash=args.flash,
                                          use_ssd_kernel=args.ssd_kernel,
                                          use_kernel=args.dp_kernel)
    else:
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
        return _serve_traffic(args, cfg, params, casc, device)
    if args.kv != "ring":
        print("note: --kv paged applies to --server traffic mode; "
              "the one-shot batch path always uses ring caches")
    return _serve_batch(args, cfg, params, strat, device)


if __name__ == "__main__":
    main()
