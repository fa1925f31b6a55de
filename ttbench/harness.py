"""One run of one cell: set-up, the measured window, the metrics, the
comparison with the plain reference, the result line.

The window is ``[0, --seconds)`` of the arrival schedule, on the
server's clock.  Every request carries the window's end as its deadline
and the server reaps what is left then (``enforce_deadlines``), so the
run ends with the window; requests cut so are counted as attempted,
neither completed nor failed.  A pass-through around the stepper's
``step`` notes each step's host times, counters and tokens (and the
first token a finished prefill feeds, which the program does not emit),
and reads back, on vocabulary entries drawn from the seed, the logits of
the node each lane serves (the comparison judges them).
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import sys
import time
from pathlib import Path
from types import SimpleNamespace as Run
from typing import NamedTuple

import numpy as np
import torch

from ttbench.lib import traffic as traffic_lib
from ttbench.lib.stats import pct
from ttbench.lib.trace_read import annotations, load_trace, span_stats

__all__ = ["main", "Cell", "Step", "run_cell", "setup", "serve_window",
           "end_to_end", "sample"]

FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")
PROFILE_AT = 10.0      # the profiled phase's spans start here (steady)
PROFILE_S = 1.5        # each of the traced run's two profiled spans
SAMPLE_TOKENS = 300    # served tokens the comparison judges, at least
SAMPLE_MAX = 24        # requests it judges, at most
CHECK_COLS = 512       # vocabulary entries of the served logits read back


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _module(path: Path):
    """The Python file ``path`` as a module of its own."""
    spec = importlib.util.spec_from_file_location(
        "ttbench_found." + str(path.with_suffix("")).replace(
            os.sep, "_").replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cost_modules(directory: Path) -> dict:
    """``{launch name: module}`` of every kernel's cost module in
    ``directory`` (`ttbench.costs`)."""
    return {p.stem: _module(p) for p in sorted(directory.glob("*.py"))
            if not p.stem.startswith("_")}


class Cell:
    """A cell of ``BENCHMARK.json`` with its configuration, traffic,
    family, metric readers and kernels' cost modules, found by name
    under ``root / paths[0]``."""

    def __init__(self, root: Path, workload: str):
        bench = _json(root / "BENCHMARK.json")
        cells = {w["name"]: w for w in bench["workloads"]}
        if workload not in cells:
            raise SystemExit(f"no workload {workload!r} in BENCHMARK.json "
                             f"(have {sorted(cells)})")
        self.spec = cells[workload]
        self.name = workload
        configs = {c["name"]: c for c in bench["configs"]}
        self.config = _json(root / configs[self.spec["config"]]["file"])
        here = root / bench["paths"][0]
        self.mix = traffic_lib.load(
            here / "traffic" / f"{self.spec['traffic']}.json")
        self.family = _module(here / "families"
                              / f"{self.config['family']}.py")
        self.m = self.family.shapes(self.config)
        self.costs = cost_modules(here / "costs")

        def mine(metric):
            return workload in metric.get("workloads", (workload,))

        self.end_to_end = [x for x in bench["end_to_end"] if mine(x)]
        self.per_layer = [x for x in bench["per_layer"] if mine(x)]
        self.readers = {x["name"]: _module(here / "metrics"
                                           / f"{x['name']}.py")
                        for x in self.per_layer}


class Step(NamedTuple):
    """One server step, as the pass-through around ``stepper.step`` saw
    it (times on the server's clock)."""

    t0: float
    t1: float
    seg_batch: int            # segments launched
    seg_policy: int           # lane-segments the strategies probed
    emit: np.ndarray          # (lanes,) bool: lanes that emitted a token
    emitted: np.ndarray       # (lanes,) their tokens
    served: np.ndarray        # (lanes,) their served nodes
    rids: np.ndarray          # (lanes,) the lanes' requests (-1: free)
    chunk: bool               # carried a prefill chunk


class StepLog:
    """The pass-through around ``stepper.step``: a `Step` a step, and the
    first token each finished prefill feeds (the program does not emit
    it).  ``hooks`` run before a step with the server's clock (the
    profiled phase's profiler).  With ``cols`` (a device index tensor)
    it also keeps, a step, every lane's served logits on ``cols`` and
    their largest, as ``(lanes, len(cols) + 1)`` on the device: the
    token step's last `fold_readout` returns them (``best``), read
    without a host sync."""

    def __init__(self, server, stepper, cols=None):
        self.steps = []
        self.first = {}
        self.hooks = []
        self.rows = []
        inner = self.inner = stepper.step
        sched = server.scheduler
        self.fold = fold = _FoldReader() if cols is not None else None

        def step(occupied, sid):
            now = server._now()
            for hook in self.hooks:
                hook(now)
            n0 = stepper.chunk_stats["chunk_steps"]
            if fold is not None:
                fold.best = None
            out = inner(occupied, sid)
            if fold is not None:
                best = fold.best
                self.rows.append(None if best is None else torch.cat(
                    [best.index_select(1, cols),
                     best.amax(dim=1, keepdim=True)], dim=1))
            t1 = server._now()
            emitted, served, sb, sp, emit = out
            rids = np.fromiter((-1 if r is None else r.rid
                                for r in sched.lane_req), np.int64,
                               len(sched.lane_req))
            for lane in np.flatnonzero(np.asarray(occupied) & ~emit):
                self.first[int(rids[lane])] = int(emitted[lane])
            self.steps.append(Step(now, t1, int(sb), int(sp), emit.copy(),
                                   emitted.copy(), served.copy(), rids,
                                   stepper.chunk_stats["chunk_steps"] > n0))
            return out

        stepper.step = step

    def close(self, stepper) -> None:
        stepper.step = self.inner
        if self.fold is not None:
            self.fold.close()


class _FoldReader:
    """Wraps the token step's `fold_readout` while a window is served and
    keeps the ``best`` (lanes, vocab) it last returned: the served
    node's logits of every lane once the step is done."""

    def __init__(self):
        from repro_torch.serving import engine
        self.engine = engine
        self.best = None
        inner = self.inner = engine.fold_readout

        def fold(*a, **k):
            out = inner(*a, **k)
            self.best = out[2]
            return out

        engine.fold_readout = fold

    def close(self) -> None:
        self.engine.fold_readout = self.inner


def check_cols(vocab: int, seed: int) -> np.ndarray:
    """The vocabulary entries whose served logits the comparison reads,
    drawn from the run's seed."""
    rng = np.random.default_rng([seed, 1])
    return np.sort(rng.choice(vocab, min(CHECK_COLS, vocab), replace=False))


def _requests(cell, seconds, seed):
    return traffic_lib.make_requests(cell.mix, seconds, seed, cell.m.vocab)


def _program_requests(reqs, deadline=None):
    from repro_torch.serving.runtime.request import Request
    return [Request(rid=r["rid"], prompt=r["prompt"],
                    max_tokens=r["max_tokens"], arrival=r["arrival"],
                    strategy=r["strategy"], deadline=deadline)
            for r in reqs]


def _warm_requests(cell):
    """A few requests at time 0 that drive every shape the cell's serve
    uses: a prompt of two chunks and a part, a few tokens, each tier."""
    chunk = cell.config["serving"]["prefill_chunk"]
    rng = np.random.default_rng(0)
    out = []
    for i, tier in enumerate(cell.mix["tiers"] * 2):
        out.append({"rid": i, "arrival": 0.0,
                    "prompt": rng.integers(0, cell.m.vocab, 2 * chunk + 3,
                                           dtype=np.int64).astype(np.int32),
                    "max_tokens": 4, "strategy": tier["strategy"]})
    return out


def setup(cell, seed, device, laps):
    """The program set up as the cell's configuration states: kernels,
    the weights from ``seed``, the calibration and the solve, the
    stepper and a warm-up serve.  Appends (part, seconds) to ``laps``."""
    from repro_torch import strategy
    from repro_torch.kernels import build
    from repro_torch.launch.serve import build_strategy
    from repro_torch.models import model as M
    from repro_torch.models.param import check_params
    from repro_torch.serving import runtime as rt

    sv = cell.config["serving"]

    def lap(name, t0):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        laps.append((name, time.perf_counter() - t0))
        return time.perf_counter()

    t = time.perf_counter()
    if device.type == "cuda":
        for name in build.SOURCES:
            build.library(name)
    t = lap("kernels", t)
    cfg = cell.family.program_config(cell.config)
    params = cell.family.make_weights(cell.m, seed, device)
    check_params(M.model_defs(cfg), params)
    t = lap("weights", t)
    cal = cell.config["calibration"]
    calib_tokens = np.random.default_rng(seed).integers(
        0, cell.m.vocab, (cal["prompts"], cal["length"]))
    casc = strategy.Cascade.calibrate(
        params, cfg, calib_tokens, cal["lam"], k=cal["k"], solve=False,
        use_flash=sv["flash"], use_kernel=sv["dp_kernel"])
    t = lap("calibration", t)
    # the strategy bank of the mix's tiers; building a table strategy
    # solves its line DP (through the Bellman kernel)
    names = sorted({tier["strategy"] for tier in cell.mix["tiers"]})
    bank = tuple(build_strategy(name, casc, threshold=0.4, patience=2)
                 for name in names)

    def sid_of(req):
        return names.index(req.strategy)

    t = lap("solve", t)
    stepper = rt.EngineStepper(
        params, cfg, bank, n_lanes=sv["lanes"], cache_len=sv["cache_len"],
        prompt_len=2 * sv["prefill_chunk"] + 3, kv="paged",
        page_size=sv["page_size"], paged_kernel=sv["paged_kernel"],
        prefill_chunk=sv["prefill_chunk"],
        prefill_budget=sv["lanes"] * sv["prefill_chunk"],
        use_flash=sv["flash"])
    warm = rt.Server(stepper, rt.LaneScheduler(sv["lanes"]), sid_of)
    with torch.no_grad():
        warm.serve(_program_requests(_warm_requests(cell)), warmup=True)
    lap("warmup", t)
    return Run(params=params, sid_of=sid_of, stepper=stepper,
               calib_tokens=calib_tokens)


class _LaunchCost:
    """A launch recorder (`repro_torch.kernels.build.LAUNCH_RECORDERS`)
    that reckons the bytes and operations of each launch of a kernel
    with a cost module (``costs``, `cost_modules`; the benchmark's own
    by default) on the device from its tensors, without a host sync."""

    def __init__(self, costs: dict | None = None):
        self.fns = cost_modules(Path(__file__).parent / "costs") \
            if costs is None else costs
        self.costs = {name: [] for name in self.fns}

    def kernel(self, name, inputs, outputs):
        mod = self.fns.get(name)
        if mod is not None:
            self.costs[name].append(mod.cost(inputs, outputs))

    def totals(self) -> dict:
        out = {}
        for name, rows in self.costs.items():
            if rows:
                t = torch.stack([torch.stack(r) for r in rows]).cpu()
                out[name] = t.double().numpy()     # (launches, 2)
        return out


class _Profiled:
    """The profiled phase's ``torch.profiler`` session: span A (nothing
    added) from ``PROFILE_AT`` then span B (the launch recorder on),
    ``PROFILE_S`` each, marked in the trace by ``record_function``
    ranges.  A throwaway session first initializes the device tracing
    (8-10 s on the card), so starting the real one does not stall the
    serve; the real one is stopped and read after the serve."""

    def __init__(self, out_dir: Path, costs: dict):
        self.a0 = PROFILE_AT
        self.b0 = PROFILE_AT + PROFILE_S
        self.path = out_dir / "profile.json"
        self.acts = [torch.profiler.ProfilerActivity.CPU,
                     torch.profiler.ProfilerActivity.CUDA]
        self.prof = self.rf = None
        self.in_b = False
        self.cost = _LaunchCost(costs)
        self.laps = {}
        t = time.perf_counter()
        with torch.profiler.profile(activities=self.acts):
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()
        self.laps["init_s"] = time.perf_counter() - t

    def hook(self, now):
        from torch.autograd.profiler import record_function
        from repro_torch.kernels import build
        if self.prof is None and now >= self.a0:
            t = time.perf_counter()
            self.prof = torch.profiler.profile(activities=self.acts)
            self.prof.start()
            self.laps["start_s"] = time.perf_counter() - t
            self.rf = record_function("ttbench.span_a")
            self.rf.__enter__()
        elif self.prof is not None and not self.in_b and now >= self.b0:
            self.rf.__exit__(None, None, None)
            self.rf = record_function("ttbench.span_b")
            self.rf.__enter__()
            self.in_b = True
            build.LAUNCH_RECORDERS.append(self.cost)

    def finish(self) -> dict | None:
        from repro_torch.kernels import build
        if self.cost in build.LAUNCH_RECORDERS:
            build.LAUNCH_RECORDERS.remove(self.cost)
        if self.prof is None:
            return None
        t = time.perf_counter()
        torch.cuda.synchronize()
        self.rf.__exit__(None, None, None)
        self.prof.stop()
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.prof.export_chrome_trace(str(self.path))
        evs = load_trace(self.path)
        self.path.unlink()
        spans = annotations(evs)
        out = {"spans": spans, "launches": self.cost.totals(),
               "a": span_stats(evs, spans.get("ttbench.span_a"))}
        if "ttbench.span_b" in spans:
            out["b"] = span_stats(evs, spans["ttbench.span_b"])
        self.laps["read_s"] = time.perf_counter() - t
        print("profile: " + ", ".join(f"{k} {v:.3f}" for k, v in
                                      self.laps.items()), file=sys.stderr)
        return out


def serve_window(cell, prog, seconds, seed, trace, hooks=(),
                 check=True):
    """Serve the cell's traffic due in ``[0, seconds)``, every request
    reaped at ``seconds``; with ``trace`` a `SpanTracer` rides the serve
    and its events are kept.  ``hooks`` run before each step with the
    server's clock; with ``check`` the served logits the comparison
    judges are read back.  Returns the `Run` the metric readers read."""
    from repro_torch.serving import runtime as rt
    from repro_torch.serving.obs import Observability
    from repro_torch.serving.obs.trace import SpanTracer

    sv = cell.config["serving"]
    reqs = _requests(cell, seconds, seed)
    events = None
    obs = None
    if trace:
        events = []
        tracer = SpanTracer(capacity=1024)
        tracer.add_listener(lambda ev: events.append(
            (ev.t, ev.kind, ev.lane, ev.rid, dict(ev.data))))
        obs = Observability(tracer=tracer)
    server = rt.Server(prog.stepper, rt.LaneScheduler(sv["lanes"]),
                       prog.sid_of, enforce_deadlines=True, obs=obs)
    cols = check_cols(cell.m.vocab, seed) if check else None
    log = StepLog(server, prog.stepper, None if cols is None else
                  torch.as_tensor(cols, device=prog.stepper.device))
    log.hooks.extend(hooks)
    prog.stepper.caches = []          # the last serve's pool goes first
    gc_pauses = []
    t_gc = [0.0]

    def on_gc(phase, info):
        if phase == "start":
            t_gc[0] = time.perf_counter()
        else:
            gc_pauses.append(time.perf_counter() - t_gc[0])

    gc.callbacks.append(on_gc)
    try:
        with torch.no_grad():
            metrics = server.serve(
                _program_requests(reqs, deadline=float(seconds)),
                warmup=False)
    finally:
        gc.callbacks.remove(on_gc)
        log.close(prog.stepper)
    return Run(cell=cell, m=cell.m, seconds=float(seconds), reqs=reqs,
               steps=log.steps, first=log.first, records=metrics.records,
               events=events, n_lanes=sv["lanes"], profile=None,
               phase=None, rows=log.rows, cols=cols, gc_pauses=gc_pauses,
               pool=prog.stepper.pool, caches_bytes=sum(
                   t.numel() * t.element_size()
                   for t in _leaves(prog.stepper.caches)))


def profile_phase(cell, prog, seed, out_dir) -> dict | None:
    """The traced run's device profile, after its window: the cell's
    traffic served again from time 0, to steady state, for
    ``PROFILE_AT + 2 * PROFILE_S`` seconds under ``torch.profiler``
    (kept out of the window: once the profiler has run, a host-bound
    step is 25-45% slower on the card).  Returns the profile and the
    phase's own `Run` (its steps and events)."""
    if prog.stepper.device.type != "cuda":
        return None
    prof = _Profiled(out_dir, cell.costs)
    run = serve_window(cell, prog, PROFILE_AT + 2 * PROFILE_S, seed, True,
                       hooks=(prof.hook,), check=False)
    run.profile = prof.finish()
    run.profile_a0, run.profile_b0 = prof.a0, prof.b0
    return run


def end_to_end(run) -> dict:
    """The user's numbers over the window, from the step log."""
    w = run.seconds
    tok_t = {}
    n_tokens = 0
    for st in run.steps:
        if st.t1 > w:
            continue
        for lane in np.flatnonzero(st.emit):
            tok_t.setdefault(int(st.rids[lane]), []).append(st.t1)
            n_tokens += 1
    ttft, itl = [], []
    for r in run.reqs:
        ts = tok_t.get(r["rid"])
        ttft.append((ts[0] if ts else w) - r["arrival"])
        if ts:
            itl.extend(np.diff(ts).tolist())
    return {"tokens_per_s": n_tokens / w,
            "ttft_p95_ms": 1e3 * pct(ttft, 95),
            "itl_p95_ms": 1e3 * pct(itl, 95) if itl else None,
            "_ttft_p50_ms": 1e3 * pct(ttft, 50),
            "_itl_p50_ms": 1e3 * pct(itl, 50) if itl else None,
            "_tokens": n_tokens}


def window_stalls(run, device) -> str:
    """The window's longest steps (start and length), the garbage
    collector's pauses and the allocator's retries: what a run whose
    tail reads far off is looked at for."""
    longest = sorted(run.steps, key=lambda st: st.t0 - st.t1)[:3]
    steps = ", ".join(f"{1e3 * (st.t1 - st.t0):.1f} ms at {st.t0:.2f} s"
                      for st in longest)
    gcs = run.gc_pauses
    retries = torch.cuda.memory_stats(device).get("num_alloc_retries", 0) \
        if device.type == "cuda" else 0
    return (f"longest steps {steps}; gc {len(gcs)} pauses, "
            f"{1e3 * sum(gcs):.1f} ms, longest "
            f"{1e3 * max(gcs, default=0.0):.1f} ms; allocator retries "
            f"{retries}")


def lateness(run) -> dict:
    """How late each request reached the server's queue: the server
    pushes a request at the first loop turn after it is due, which is
    the end of the step running then (or the due time itself when the
    server was waiting)."""
    ends = np.asarray([s.t1 for s in run.steps if s.t1 <= run.seconds])
    starts = np.asarray([s.t0 for s in run.steps if s.t1 <= run.seconds])
    late = []
    for r in run.reqs:
        i = np.searchsorted(starts, r["arrival"], side="right") - 1
        busy = i >= 0 and ends[i] > r["arrival"]
        late.append(ends[i] - r["arrival"] if busy else 0.0)
    return {"p50_ms": 1e3 * pct(late, 50), "p99_ms": 1e3 * pct(late, 99),
            "max_ms": 1e3 * max(late, default=0.0)}


def sample(run, seed) -> list:
    """The finished requests the comparison judges: the longest of each
    strategy, then others drawn from ``seed`` until the sample holds
    ``SAMPLE_TOKENS`` served tokens."""
    done = [r for r in run.reqs
            if run.records.get(r["rid"]) is not None
            and run.records[r["rid"]].status == "completed"
            and r["rid"] in run.first]
    if not done:
        return []
    chosen = []
    for tier in sorted({r["strategy"] for r in done}):
        mine = [r for r in done if r["strategy"] == tier]
        chosen.append(max(mine, key=lambda r: (len(r["prompt"])
                                               + r["max_tokens"])))
    rest = [r for r in done if r not in chosen]
    rng = np.random.default_rng(seed)
    for i in rng.permutation(len(rest)):
        if (sum(r["max_tokens"] for r in chosen) >= SAMPLE_TOKENS
                or len(chosen) >= SAMPLE_MAX):
            break
        chosen.append(rest[i])
    # each sampled request's served rows, in the order it emitted them
    want = {r["rid"]: [] for r in chosen}
    for st, rows in zip(run.steps, run.rows):
        for lane in np.flatnonzero(st.emit):
            got = want.get(int(st.rids[lane]))
            if got is not None:
                got.append((rows, int(lane), int(st.served[lane])))
    out = []
    for r in chosen:
        toks = list(run.records[r["rid"]].tokens)
        seen = want[r["rid"]]
        if len(seen) != len(toks) or any(x is None for x, _, _ in seen):
            raise RuntimeError(f"request {r['rid']}: {len(toks)} tokens, "
                               f"{len(seen)} served rows read back")
        rows = torch.stack([x[lane] for x, lane, _ in seen]).cpu().numpy()
        out.append({"rid": r["rid"], "prompt": r["prompt"],
                    "first": run.first[r["rid"]], "tokens": toks,
                    "strategy": r["strategy"], "rows": rows[:, :-1],
                    "top": rows[:, -1],
                    "nodes": [node for _, _, node in seen]})
    return out


def reference_tables(cell, params, calib_tokens):
    """The reference's own calibration and tables, through the cell's
    family's reference."""
    from ttbench.reference.check import tables_of
    cal = cell.config["calibration"]
    return tables_of(cell.family.Model, cell.m, params, calib_tokens,
                     cal["lam"], cal["k"])


def judge(cell, params, tables, chosen, cols, control=False) -> dict:
    """The reference's readings on the sample: the program's, or with
    ``control`` the control's in its place at the same positions, through
    the cell's family's reference."""
    from ttbench.reference.check import served_gap
    out = served_gap(cell.family.Model, cell.m, params,
                     cell.config["serving"]["prefill_chunk"], tables,
                     chosen, cols, control=control)
    out["requests"] = len(chosen)
    return out


def verdict(cell, readings) -> tuple[bool, dict]:
    """``correct``, and each number compared beside its limit."""
    limit = cell.config["check"]["served_gap"]
    correct = bool(readings["tokens"] > 0
                   and readings["served_gap"] <= limit)
    return correct, {
        "served_gap": {"value": readings["served_gap"], "limit": limit},
        "judged_tokens": {"value": readings["tokens"], "limit": 1}}


def memory_in_use(run, params) -> dict:
    """Bytes the window held: the weights, and the pool's pages at the
    window's peak (what the traffic occupied, not what it reserved)."""
    pool = run.pool
    weights = sum(t.numel() * t.element_size() for t in _leaves(params))
    caches = run.caches_bytes
    per_page = caches / pool.n_pages
    return {"weights": weights, "pool": caches, "pool_pages": pool.n_pages,
            "pages_peak": pool.peak_pages,
            "in_use": weights + pool.peak_pages * per_page}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


def run_cell(root: Path, workload: str, seed: int, seconds: float,
             trace: bool, device, t_start: float) -> dict:
    """Set up, serve the window, read the metrics, judge the sample.
    Returns the result line's object."""
    cell = Cell(root, workload)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    laps = [("start", time.perf_counter() - t_start)]
    prog = setup(cell, seed, device, laps)
    setup_s = time.perf_counter() - t_start
    print("setup: " + ", ".join(f"{k} {v:.3f} s" for k, v in laps)
          + f"; setup_s {setup_s:.3f}", file=sys.stderr)
    t_win = time.perf_counter()
    run = serve_window(cell, prog, seconds, seed, trace)
    chunked = sum(1 for st in run.steps if st.chunk)
    print(f"window: {time.perf_counter() - t_win:.3f} s host, "
          f"{len(run.steps)} steps ({chunked} with a chunk), "
          f"{len(run.reqs)} requests due", file=sys.stderr)
    print("stalls: " + window_stalls(run, device), file=sys.stderr)
    mem = memory_in_use(run, prog.params)
    if trace:
        t_prof = time.perf_counter()
        run.phase = profile_phase(cell, prog, seed,
                                  root / "build" / "ttbench")
        print(f"profiled phase: {time.perf_counter() - t_prof:.3f} s host",
              file=sys.stderr)
    e2e = end_to_end(run)
    late = lateness(run)
    print(f"generator lateness: p50 {late['p50_ms']:.3f} ms, p99 "
          f"{late['p99_ms']:.3f} ms, max {late['max_ms']:.3f} ms",
          file=sys.stderr)
    status = {}
    for rec in run.records.values():
        status[rec.status] = status.get(rec.status, 0) + 1
    print(f"requests: {len(run.reqs)} due, by status {status}, ttft p50 "
          f"{e2e['_ttft_p50_ms']:.3f} ms, itl p50 {e2e['_itl_p50_ms']} ms, "
          f"{e2e['_tokens']} tokens", file=sys.stderr)
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    metrics = {}
    if trace:
        for x in cell.per_layer:
            value = cell.readers[x["name"]].read(run)
            if value is not None:
                metrics[x["name"]] = {"value": value, "unit": x["unit"]}
    else:
        e2e["setup_s"] = setup_s
        for x in cell.end_to_end:
            if e2e.get(x["name"]) is not None:
                metrics[x["name"]] = {"value": e2e[x["name"]],
                                      "unit": x["unit"]}
    if device.type == "cuda":
        print(f"memory: peak {peak} B; weights {mem['weights']} B, pool "
              f"{mem['pool']} B in {mem['pool_pages']} pages, "
              f"{mem['pages_peak']} pages at the window's peak; in use "
              f"{mem['in_use']:.0f} B", file=sys.stderr)
    chosen = sample(run, seed)
    params, calib_tokens = prog.params, prog.calib_tokens
    del prog, run.records
    stepper_gone(run)
    t_ref = time.perf_counter()
    if chosen:
        readings = judge(cell, params,
                         reference_tables(cell, params, calib_tokens),
                         chosen, run.cols)
    else:
        readings = {"served_gap": float("inf"), "tokens": 0,
                    "requests": 0}
    print(f"reference: {time.perf_counter() - t_ref:.3f} s, "
          f"{readings['requests']} requests, {readings['tokens']} tokens, "
          f"served nodes {readings.get('nodes')}, "
          f"{readings.get('other_node')} served at another node",
          file=sys.stderr)
    correct, check = verdict(cell, readings)
    result = {"correct": correct, "attempted": len(run.reqs), "failed": 0,
              "metrics": metrics, "device": device_info(device, peak)}
    if trace and run.phase is not None and run.phase.profile is not None:
        a = run.phase.profile["a"]
        result["device"]["busy_s"] = a["busy_s"]
        result["device"]["window_s"] = a["window_s"]
        result["breakdown"] = {"device_ops": a["device_ops"],
                               "idle_gaps": a["idle_gaps"]}
    result["check"] = check
    for name, c in check.items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    return result


def stepper_gone(run) -> None:
    """Free the program's state before the reference runs."""
    run.steps = run.events = run.rows = run.pool = None
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def device_info(device, peak) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1, "memory_peak_bytes": int(peak)}


def main(argv, root: Path, t_start: float) -> int:
    ap = argparse.ArgumentParser(description="one run of a benchmark cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = Cell(root, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.spec["chips"]:
        print(f"{args.workload}: needs {cell.spec['chips']} CUDA "
              "device(s); none here, and the benchmark never falls back "
              "to the CPU", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    result = run_cell(root, args.workload, args.seed, args.seconds,
                      bool(args.trace), device, t_start)
    found = forbidden_modules()
    if found:
        print(f"modules loaded that the benchmark must not load: {found}",
              file=sys.stderr)
        return 3
    print(json.dumps(result))
    return 0
