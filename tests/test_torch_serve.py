"""The port's serving path (repro_torch.serving, repro_torch.launch)
against the JAX package's, end to end on the smoke config.

  * The same requests, weights and tables served by the JAX
    `EngineStepper` (paged pool, chunked prefill, page-gather path) and
    by the port — once with the kernel switch on (plain versions on
    the CPU), once on its gather path: per request, tokens and served
    nodes are EQUAL, and so are the chunked-prefill stats and the
    segment counters.
  * The same for stop-the-world admission, on the ring caches (with and
    without the flash route, whose plain version runs on the CPU) and
    on the paged pool (pool stats equal too), for the attention smoke
    model and for the SSM one (mamba2-130m; ring, ring through the
    ssd-chunk route, paged).
  * The same seed gives the same workload in both packages.
  * The port's serve report renders the reference's lines from the same
    stats.
  * The launcher runs end to end on the CPU when asked to — the
    one-shot batch path by default, ``--server`` on ring caches by
    default, ``--flash --dp-kernel`` on both, ``--arch mamba2-130m
    --ssd-kernel --dp-kernel`` on both — and refuses to run without
    CUDA otherwise.
  * Nothing under src/repro_torch/, nor chip_smoke.py, imports jax or
    the JAX package.
"""

import ast
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro import strategy as jstrategy
from repro.configs import get_config
from repro.models import model as M
from repro.models.param import materialize
from repro.serving import runtime as jrt
from repro.serving.obs.report import ServeReport as JReport
from repro.serving.runtime.request import Request as JRequest
from repro.serving.runtime.workload import WorkloadSpec as JSpec
from repro_torch import strategy as tstrategy
from repro_torch.bridge import (chain_from_numpy, line_tables_from_numpy,
                                params_from_numpy, support_from_numpy,
                                to_tensor)
from repro_torch.launch import serve as tserve
from repro_torch.serving import runtime as trt
from repro_torch.serving.obs.report import ServeReport as TReport
from repro_torch.serving.runtime.request import Request as TRequest
from repro_torch.serving.runtime.workload import WorkloadSpec as TSpec

ROOT = Path(__file__).resolve().parents[1]
PROMPT_LEN = 12


def _setup(arch):
    torch.set_num_threads(2)
    cfg = get_config(arch, smoke=True)
    params = materialize(M.model_defs(cfg), jax.random.PRNGKey(0))
    casc = jstrategy.Cascade.calibrate(params, cfg, jax.random.PRNGKey(1),
                                       lam=0.5, k=8, t=64, seq=16)
    tparams = params_from_numpy(jax.tree.map(np.asarray, params))
    tcasc = tstrategy.Cascade(
        support=support_from_numpy(jax.tree.map(np.asarray, casc.support)),
        chain=chain_from_numpy(jax.tree.map(np.asarray, casc.chain)),
        costs=to_tensor(np.asarray(casc.costs)), lam=casc.lam,
        line_tables=line_tables_from_numpy(
            jax.tree.map(np.asarray, casc.solve_line())))
    return cfg, params, casc, tparams, tcasc


@pytest.fixture(scope="module")
def setup():
    return _setup("paper-ee-100m")


@pytest.fixture(scope="module")
def ssm_setup():
    return _setup("mamba2-130m")


def _requests(cls, cfg, n=6, seed=7):
    """Every other request repeats one base prompt (prefix-cache hits);
    all arrive at t = 0, so admission depends only on lane turnover."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, cfg.vocab, PROMPT_LEN, dtype=np.int32)
    out = []
    for rid in range(n):
        prompt = base.copy() if rid % 2 == 0 else rng.integers(
            0, cfg.vocab, PROMPT_LEN, dtype=np.int32)
        out.append(cls(rid=rid, prompt=prompt, max_tokens=2 + rid % 3,
                       arrival=0.0, strategy="recall_index"))
    return out


def _serve_logged(rt, stepper, sid_of, requests):
    """Serve and log, per request, the node that served each token."""
    sched = rt.LaneScheduler(2)
    nodes = {r.rid: [] for r in requests}
    step = stepper.step

    def logged(occupied, sid):
        out = step(occupied, sid)
        served, emit = out[1], out[-1]
        for lane in np.flatnonzero(emit):
            req = sched.lane_req[lane]
            if req is not None:       # None: the stepper's own warmup
                nodes[req.rid].append(int(served[lane]))
        return out

    stepper.step = logged
    metrics = rt.Server(stepper, sched, sid_of).serve(requests)
    return metrics, nodes


@pytest.fixture(scope="module")
def reference_run(setup):
    cfg, params, casc, _, _ = setup
    requests = _requests(JRequest, cfg)
    bank, sid_of = jrt.build_bank(requests, jrt.cascade_factory(casc),
                                  ("recall_index", None))
    stepper = jrt.EngineStepper(params, cfg, bank, n_lanes=2, cache_len=32,
                                prompt_len=PROMPT_LEN, kv="paged",
                                page_size=8, prefill_chunk=5,
                                prefill_budget=8)
    metrics, nodes = _serve_logged(jrt, stepper, sid_of, requests)
    return (requests, metrics, nodes, dict(stepper.chunk_stats),
            stepper.pool.stats())


@pytest.mark.parametrize("kernel", [True, False], ids=["kernel", "gather"])
def test_port_serves_what_the_reference_serves(setup, reference_run,
                                               kernel):
    cfg, _, _, tparams, tcasc = setup
    jreqs, jm, jnodes, jstats, _ = reference_run
    requests = _requests(TRequest, cfg)
    bank, sid_of = trt.build_bank(requests, trt.cascade_factory(tcasc),
                                  ("recall_index", None))
    stepper = trt.EngineStepper(tparams, cfg, bank, n_lanes=2, cache_len=32,
                                prompt_len=PROMPT_LEN, kv="paged",
                                page_size=8, prefill_chunk=5,
                                prefill_budget=8, paged_kernel=kernel)
    with torch.no_grad():
        tm, tnodes = _serve_logged(trt, stepper, sid_of, requests)
    for req in jreqs:
        assert tm.records[req.rid].tokens == jm.records[req.rid].tokens, \
            f"request {req.rid}"
        assert tnodes[req.rid] == jnodes[req.rid], f"request {req.rid}"
        assert tm.records[req.rid].n_tokens == req.max_tokens
    assert stepper.chunk_stats == jstats
    assert jstats["tokens_skipped"] > 0           # prefix hits exercised
    assert (tm.steps, tm.seg_batch, tm.seg_policy, tm.lane_steps) == \
        (jm.steps, jm.seg_batch, jm.seg_policy, jm.lane_steps)


@pytest.fixture(scope="module")
def stw_reference():
    """The JAX package's stop-the-world serves, one per (model, KV mode)
    (built on first use)."""
    runs = {}

    def get(setup, kv):
        cfg, params, casc, _, _ = setup
        if (cfg.name, kv) not in runs:
            requests = _requests(JRequest, cfg)
            bank, sid_of = jrt.build_bank(
                requests, jrt.cascade_factory(casc), ("recall_index", None))
            stepper = jrt.EngineStepper(params, cfg, bank, n_lanes=2,
                                        cache_len=32, prompt_len=PROMPT_LEN,
                                        kv=kv, page_size=8)
            metrics, nodes = _serve_logged(jrt, stepper, sid_of, requests)
            runs[cfg.name, kv] = (requests, metrics, nodes,
                                  None if stepper.pool is None
                                  else stepper.pool.stats())
        return runs[cfg.name, kv]

    return get


@pytest.mark.parametrize(
    "model,kv,kernel",
    [("attn", "ring", False), ("attn", "ring", True),
     ("attn", "paged", False), ("ssm", "ring", False),
     ("ssm", "ring", True), ("ssm", "paged", False)],
    ids=["ring", "ring-flash", "paged", "ssm-ring", "ssm-ring-ssd",
         "ssm-paged"])
def test_stop_the_world_serves_what_the_reference_serves(
        request, stw_reference, model, kv, kernel):
    """``kernel``: the flash route (attention) or the ssd-chunk route
    (SSM), whose plain versions run on the CPU."""
    setup = request.getfixturevalue("setup" if model == "attn"
                                    else "ssm_setup")
    cfg, _, _, tparams, tcasc = setup
    jreqs, jm, jnodes, jpool = stw_reference(setup, kv)
    requests = _requests(TRequest, cfg)
    bank, sid_of = trt.build_bank(requests, trt.cascade_factory(tcasc),
                                  ("recall_index", None))
    stepper = trt.EngineStepper(tparams, cfg, bank, n_lanes=2, cache_len=32,
                                prompt_len=PROMPT_LEN, kv=kv, page_size=8,
                                use_flash=kernel and model == "attn",
                                use_ssd_kernel=kernel and model == "ssm")
    with torch.no_grad():
        tm, tnodes = _serve_logged(trt, stepper, sid_of, requests)
    for req in jreqs:
        assert tm.records[req.rid].tokens == jm.records[req.rid].tokens, \
            f"request {req.rid}"
        assert tnodes[req.rid] == jnodes[req.rid], f"request {req.rid}"
        assert tm.records[req.rid].n_tokens == req.max_tokens
    assert (tm.steps, tm.seg_batch, tm.seg_policy, tm.lane_steps) == \
        (jm.steps, jm.seg_batch, jm.seg_policy, jm.lane_steps)
    if kv == "paged":
        assert stepper.pool.stats() == jpool
        assert jpool["prefix_hit_rate"] > 0       # prefix hits exercised
    else:
        assert stepper.pool is None


def test_report_renders_the_reference_lines(setup, reference_run):
    cfg = setup[0]
    _, jm, _, jstats, jpool = reference_run
    lines = []
    for cls in (JReport, TReport):
        rep = cls()
        rep.add_runtime(jm.summary(slo=1.0), slo_ms=1e3)
        rep.add_segments(jm.seg_batch, jm.seg_policy, steps=jm.steps,
                         n_seg=len(cfg.segments), lane_steps=jm.lane_steps)
        rep.add_pool(jpool)
        rep.add_chunked_prefill(jstats)
        lines.append(rep.lines())
    assert lines[1] == lines[0]
    assert len(lines[1]) == 7        # runtime 4, segments, pool, chunk


@pytest.mark.parametrize("workload", ["poisson", "bursty", "diurnal"])
def test_same_seed_same_workload(workload):
    kw = dict(rate=6.0, duration=3.0, prompt_len=9, vocab=512,
              max_tokens=(2, 7), seed=3, strategy="recall_index")
    jr = jrt.make_workload(workload, JSpec(**kw))
    tr = trt.make_workload(workload, TSpec(**kw))
    assert len(jr) == len(tr) > 0
    for a, b in zip(jr, tr):
        assert (a.rid, a.arrival, a.max_tokens, a.strategy, a.lam) == \
            (b.rid, b.arrival, b.max_tokens, b.strategy, b.lam)
        np.testing.assert_array_equal(a.prompt, b.prompt)


def test_launcher_serves_smoke_on_cpu(capsys):
    torch.set_num_threads(2)
    run = tserve.main(["--smoke", "--device", "cpu", "--server",
                       "--kv", "paged", "--paged-kernel", "--page-size",
                       "8", "--prefill-chunk", "8", "--lanes", "2",
                       "--rate", "6", "--duration", "0.5", "--tokens", "4",
                       "--prompt-len", "10"])
    assert run is not None and run.requests
    for req in run.requests:
        assert run.metrics.records[req.rid].n_tokens == req.max_tokens
    out = capsys.readouterr().out
    assert "calibrated T-Tamer tables: n=2 K=24" in out
    assert f"completed {len(run.requests)}/{len(run.requests)}" in out


def test_launcher_defaults_follow_the_reference():
    """--kv ring, no --prefill-chunk, --batch 8 and --lanes = --batch,
    as the reference launcher's defaults."""
    args = tserve.parse_args([])
    assert (args.kv, args.prefill_chunk, args.batch, args.lanes,
            args.server, args.flash, args.dp_kernel) == \
        ("ring", None, 8, 8, False, False, False)
    assert tserve.parse_args(["--batch", "3"]).lanes == 3
    assert tserve.parse_args(["--batch", "3", "--lanes", "5"]).lanes == 5


def test_launcher_one_shot_flash_dp_kernel_on_cpu(capsys):
    """No --server: the one-shot batch path prints the reference's three
    lines; --flash and --dp-kernel run the kernels' plain versions on
    the CPU (no launch is counted)."""
    torch.set_num_threads(2)
    from repro_torch.kernels import bellman_backup, flash_attention
    before = (flash_attention.launches, bellman_backup.launches)
    run = tserve.main(["--smoke", "--device", "cpu", "--flash",
                       "--dp-kernel", "--kv", "paged", "--batch", "3",
                       "--tokens", "4", "--prompt-len", "10",
                       "--cache-len", "16"])
    out = capsys.readouterr().out.splitlines()
    assert "note: --kv paged applies to --server traffic mode" in out[-4]
    assert out[-3].startswith("generated 3x4 tokens in ")
    assert out[-2].startswith("segments saved: batch ")
    assert out[-1].startswith("served-node histogram: [")
    assert run.stats.tokens.shape == run.stats.served_nodes.shape == (3, 4)
    assert ((0 <= run.stats.tokens) & (run.stats.tokens < 512)).all()
    assert run.prompts.shape == (3, 10)
    assert (flash_attention.launches, bellman_backup.launches) == before


def test_launcher_serves_ring_by_default_on_cpu(capsys):
    torch.set_num_threads(2)
    run = tserve.main(["--smoke", "--device", "cpu", "--server", "--flash",
                       "--dp-kernel", "--lanes", "2", "--rate", "6",
                       "--duration", "0.5", "--tokens", "4",
                       "--prompt-len", "10"])
    assert run is not None and run.requests
    assert run.stepper.kv == "ring" and run.stepper.pool is None
    assert run.stepper.use_flash
    for req in run.requests:
        assert run.metrics.records[req.rid].n_tokens == req.max_tokens
    out = capsys.readouterr().out
    assert ", kv ring, " in out and "flash on" in out
    assert f"completed {len(run.requests)}/{len(run.requests)}" in out


@pytest.mark.parametrize("server", [False, True], ids=["one_shot", "server"])
def test_launcher_serves_mamba_on_cpu(capsys, tmp_path, server):
    """--arch mamba2-130m --ssd-kernel --dp-kernel: calibration, then the
    one-shot batch or the ring server, the kernels' plain versions on
    the CPU (no launch is counted)."""
    torch.set_num_threads(2)
    from repro_torch.kernels import bellman_backup, ssd_chunk
    before = (ssd_chunk.launches, bellman_backup.launches)
    argv = ["--arch", "mamba2-130m", "--smoke", "--device", "cpu",
            "--ssd-kernel", "--dp-kernel", "--tokens", "4",
            "--prompt-len", "10"]
    if server:
        argv += ["--server", "--lanes", "2", "--rate", "6", "--duration",
                 "0.5", "--json", str(tmp_path / "metrics.json")]
    else:
        argv += ["--batch", "3", "--cache-len", "16"]
    run = tserve.main(argv)
    out = capsys.readouterr().out
    assert "calibrated T-Tamer tables: n=2 K=24" in out
    if server:
        assert run is not None and run.requests
        assert run.stepper.kv == "ring" and run.stepper.use_ssd_kernel
        for req in run.requests:
            assert run.metrics.records[req.rid].n_tokens == req.max_tokens
        assert "ssd kernel on" in out
        assert f"completed {len(run.requests)}/{len(run.requests)}" in out
        extra = json.loads((tmp_path / "metrics.json").read_text())
        assert extra["ssd_kernel"] is True
    else:
        assert run.stats.tokens.shape == (3, 4)
        assert out.splitlines()[-3].startswith("generated 3x4 tokens in ")
    assert (ssd_chunk.launches, bellman_backup.launches) == before


def test_launcher_refuses_to_run_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA is not available"):
        tserve.main(["--smoke", "--server"])


def _port_files():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def test_port_imports_neither_jax_nor_the_jax_package():
    files = _port_files()
    assert len(files) > 20 and files[-1].exists()
    names = {str(f.relative_to(ROOT)) for f in files}
    for mod in ("kernels/flash_attention", "kernels/bellman_backup",
                "kernels/ssd_chunk", "models/ssm", "configs/mamba2_130m"):
        assert f"src/repro_torch/{mod}.py" in names
    bad = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for name in names:
                if name.split(".")[0] in ("jax", "jaxlib", "repro"):
                    bad.append(f"{path.relative_to(ROOT)}:{node.lineno} "
                               f"imports {name}")
    assert not bad, "\n".join(bad)
