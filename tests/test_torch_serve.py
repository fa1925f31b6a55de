"""The port's serving path (repro_torch.serving, repro_torch.launch)
against the JAX package's, end to end on the smoke config.

  * The same requests, weights and tables served by the JAX
    `EngineStepper` (paged pool, chunked prefill, page-gather path) and
    by the port — once with the kernel switch on (plain versions on
    the CPU), once on its gather path: per request, tokens and served
    nodes are EQUAL, and so are the chunked-prefill stats and the
    segment counters.  Also on a trained checkpoint the reference wrote,
    each package loading it with its own ``checkpoint.load`` (what
    ``launch.serve --ckpt`` does), on synthetic prompts.
  * The same for stop-the-world admission, on the ring caches (with and
    without the flash route, whose plain version runs on the CPU) and
    on the paged pool (pool stats equal too), for the attention smoke
    model, for the SSM one (mamba2-130m; ring, ring through the
    ssd-chunk route, paged) and for the hybrid one (hymba-1.5b: ring,
    ring through the flash and ssd-chunk routes, paged, paged through
    every kernel route).
  * Both of those under every other online policy of the registry
    (tree_index, skip_recall, norecall_threshold, recall_threshold,
    norecall_patience, always_first, always_last), each built by the
    launchers' own ``build_strategy`` with the same knobs from the same
    bridged tables.
  * The same seed gives the same workload in both packages.
  * The port's serve report renders the reference's lines from the same
    stats.
  * The launcher runs end to end on the CPU when asked to — the
    one-shot batch path by default, ``--server`` on ring caches by
    default, ``--flash --dp-kernel`` on both, ``--arch mamba2-130m
    --ssd-kernel --dp-kernel`` on both, the reference's aliases and
    knobs — and refuses to run without CUDA otherwise; its ``--policy``
    choices are the reference launcher's, hindsight oracles refused.
  * Nothing under src/repro_torch/ (the control and fault planes, the
    dense, MoE and MLA configs, the MoE layer and the training modules
    included), nor
    chip_smoke.py, imports jax, the JAX package, msgpack or ml_dtypes,
    and zstandard only inside a ``try``.
"""

import ast
import collections
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import strategy as jstrategy
from repro.configs import get_config
from repro.data import pipeline as jdata
from repro.launch import serve as jserve
from repro.models import model as M
from repro.models.param import materialize
from repro.serving import runtime as jrt
from repro.serving.obs.report import ServeReport as JReport
from repro.serving.runtime.request import Request as JRequest
from repro.serving.runtime.workload import WorkloadSpec as JSpec
from repro.training import checkpoint as jckpt
from repro.training.loop import train as jtrain
from repro.training.optimizer import AdamWConfig as JAdamW
from repro_torch import strategy as tstrategy
from repro_torch.bridge import (chain_from_numpy, line_tables_from_numpy,
                                params_from_numpy, skip_tables_from_numpy,
                                support_from_numpy, to_tensor)
from repro_torch.launch import serve as tserve
from repro_torch.serving import runtime as trt
from repro_torch.serving.obs.report import ServeReport as TReport
from repro_torch.serving.runtime.request import Request as TRequest
from repro_torch.serving.runtime.workload import WorkloadSpec as TSpec
from repro_torch.training import checkpoint as tckpt

ROOT = Path(__file__).resolve().parents[1]
PROMPT_LEN = 12
# the fixture that gives each ``weights`` case its setup
SETUPS = {"init": "setup", "ckpt": "ckpt_setup"}
# the online policies besides recall_index, served under the launchers'
# default knobs
POLICIES = ("tree_index", "skip_recall", "norecall_threshold",
            "recall_threshold", "norecall_patience", "always_first",
            "always_last")
KNOBS = dict(threshold=0.4, patience=2)


def _setup(arch, params=None, tparams=None):
    """Config, reference weights (random init unless given), tables the
    reference calibrated on them, and both bridged to the port (the
    port's weights are ``tparams`` when given)."""
    torch.set_num_threads(2)
    cfg = get_config(arch, smoke=True)
    if params is None:
        params = materialize(M.model_defs(cfg), jax.random.PRNGKey(0))
    casc = jstrategy.Cascade.calibrate(params, cfg, jax.random.PRNGKey(1),
                                       lam=0.5, k=8, t=64, seq=16)
    if tparams is None:
        tparams = params_from_numpy(jax.tree.map(np.asarray, params))
    tcasc = tstrategy.Cascade(
        support=support_from_numpy(jax.tree.map(np.asarray, casc.support)),
        chain=chain_from_numpy(jax.tree.map(np.asarray, casc.chain)),
        costs=to_tensor(np.asarray(casc.costs)), lam=casc.lam,
        line_tables=line_tables_from_numpy(
            jax.tree.map(np.asarray, casc.solve_line())),
        skip_tables=skip_tables_from_numpy(
            jax.tree.map(np.asarray, casc.solve_skip("cumulative"))),
        edge_costs=np.asarray(casc.edge_costs), skip_mode="cumulative")
    return cfg, params, casc, tparams, tcasc


def _factory(serve_mod, casc):
    """A launcher's bank factory: its ``build_strategy`` with the
    default knobs."""
    def mk(name, lam):
        return serve_mod.build_strategy(name, casc, lam=lam, **KNOBS)
    return mk


@pytest.fixture(scope="module")
def setup():
    return _setup("paper-ee-100m")


@pytest.fixture(scope="module")
def ssm_setup():
    return _setup("mamba2-130m")


@pytest.fixture(scope="module")
def mla_setup():
    return _setup("deepseek-v2-lite-16b")


@pytest.fixture(scope="module")
def hybrid_setup():
    return _setup("hymba-1.5b")


# the fixture that gives each stop-the-world ``model`` case its setup
STW_SETUPS = {"attn": "setup", "ssm": "ssm_setup", "mla": "mla_setup",
              "hybrid": "hybrid_setup"}


def _requests(cls, cfg, n=6, seed=7, policy="recall_index",
              synthetic=False):
    """Every other request repeats one base prompt (prefix-cache hits);
    all arrive at t = 0, so admission depends only on lane turnover.
    Prompts are uniform over the vocab or, with ``synthetic``, rows of
    the synthetic training source (pattern spans a trained model
    continues)."""
    rng = np.random.default_rng(seed)
    if synthetic:
        rows = iter(jdata.SyntheticLM(jdata.DataConfig(
            vocab=cfg.vocab, seq_len=PROMPT_LEN + 1, global_batch=n + 1,
            seed=seed, easy_frac=1.0, span=PROMPT_LEN)).sample_batch(0)
            ["tokens"])

        def draw():
            return next(rows).astype(np.int32)
    else:
        def draw():
            return rng.integers(0, cfg.vocab, PROMPT_LEN, dtype=np.int32)
    base = draw()
    out = []
    for rid in range(n):
        prompt = base.copy() if rid % 2 == 0 else draw()
        out.append(cls(rid=rid, prompt=prompt, max_tokens=2 + rid % 3,
                       arrival=0.0, strategy=policy))
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
def ckpt_setup(tmp_path_factory):
    """`_setup` on a checkpoint: the smoke model trained by the
    reference (`tests/test_system.py`'s 60 steps) and written with its
    `checkpoint.save`; the reference serves its own `checkpoint.load`'s
    arrays, the port its `checkpoint.load`'s through the bridge, as
    ``launch.serve --ckpt`` does."""
    cfg = get_config("paper-ee-100m", smoke=True)
    params = materialize(M.model_defs(cfg), jax.random.PRNGKey(0))
    params, _, _ = jtrain(
        cfg, JAdamW(lr=3e-3, total_steps=60, warmup_steps=5), params,
        jdata.batches(jdata.DataConfig(vocab=cfg.vocab, seq_len=65,
                                       global_batch=8, easy_frac=0.8)),
        steps=60, log_every=60)
    path = jckpt.save(str(tmp_path_factory.mktemp("ckpt") / "state_60.ckpt"),
                      {"params": params}, 60)
    jstate, _ = jckpt.load(path)
    tstate, _ = tckpt.load(path)
    return _setup("paper-ee-100m",
                  params=jax.tree.map(jnp.asarray, jstate["params"]),
                  tparams=params_from_numpy(tstate["params"]))


@pytest.fixture(scope="module")
def chunked_reference(request):
    """The JAX package's chunked paged serves, one per (weights,
    policy) — the random init of ``setup`` or the trained checkpoint of
    ``ckpt_setup`` (built on first use)."""
    runs = {}

    def get(policy, weights="init"):
        if (weights, policy) not in runs:
            cfg, params, casc, _, _ = request.getfixturevalue(
                SETUPS[weights])
            requests = _requests(JRequest, cfg, policy=policy,
                                 synthetic=weights == "ckpt")
            bank, sid_of = jrt.build_bank(requests, _factory(jserve, casc),
                                          (policy, None))
            stepper = jrt.EngineStepper(params, cfg, bank, n_lanes=2,
                                        cache_len=32, prompt_len=PROMPT_LEN,
                                        kv="paged", page_size=8,
                                        prefill_chunk=5, prefill_budget=8)
            metrics, nodes = _serve_logged(jrt, stepper, sid_of, requests)
            runs[weights, policy] = (requests, metrics, nodes,
                                     dict(stepper.chunk_stats),
                                     stepper.pool.stats())
        return runs[weights, policy]

    return get


@pytest.fixture(scope="module")
def reference_run(chunked_reference):
    return chunked_reference("recall_index")


@pytest.mark.parametrize(
    "kernel,policy,weights",
    [(True, "recall_index", "init"), (False, "recall_index", "init")]
    + [(True, p, "init") for p in POLICIES]
    + [(True, "recall_index", "ckpt"), (False, "recall_index", "ckpt")],
    ids=["kernel", "gather"] + [f"kernel-{p}" for p in POLICIES]
    + ["ckpt-kernel", "ckpt-gather"])
def test_port_serves_what_the_reference_serves(request, chunked_reference,
                                               kernel, policy, weights):
    """The ``ckpt`` cases serve a trained checkpoint the reference wrote
    (each package loading it itself) on synthetic prompts."""
    _check_chunked_serve(request.getfixturevalue(SETUPS[weights]),
                         chunked_reference(policy, weights), kernel, policy,
                         synthetic=weights == "ckpt")


def _check_chunked_serve(setup, reference, kernel, policy, synthetic=False):
    cfg, _, _, tparams, tcasc = setup
    jreqs, jm, jnodes, jstats, _ = reference
    requests = _requests(TRequest, cfg, policy=policy, synthetic=synthetic)
    bank, sid_of = trt.build_bank(requests, _factory(tserve, tcasc),
                                  (policy, None))
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
    # the metrics' served-node counts are the reference's nodes
    assert tm.served_nodes == collections.Counter(
        n for nodes in jnodes.values() for n in nodes)
    assert (tm.steps, tm.seg_batch, tm.seg_policy, tm.lane_steps) == \
        (jm.steps, jm.seg_batch, jm.seg_policy, jm.lane_steps)


@pytest.fixture(scope="module", params=["granite-3-2b", "qwen3-4b",
                                        "starcoder2-3b", "qwen3-14b",
                                        "phi3.5-moe-42b-a6.6b"])
def dense_setup(request):
    """A token-input GQA config's smoke size (dense tied: qk-norm, SwiGLU
    or GeLU, GQA, a 64-token window; qwen3-14b: untied, GQA 5:1;
    phi3.5-moe: untied, MoE MLPs), its weights and tables bridged, and
    the reference's chunked paged serve under recall_index."""
    setup = _setup(request.param)
    cfg, params, casc, _, _ = setup
    requests = _requests(JRequest, cfg)
    bank, sid_of = jrt.build_bank(requests, _factory(jserve, casc),
                                  ("recall_index", None))
    stepper = jrt.EngineStepper(params, cfg, bank, n_lanes=2, cache_len=32,
                                prompt_len=PROMPT_LEN, kv="paged",
                                page_size=8, prefill_chunk=5,
                                prefill_budget=8)
    metrics, nodes = _serve_logged(jrt, stepper, sid_of, requests)
    return setup, (requests, metrics, nodes, dict(stepper.chunk_stats),
                   stepper.pool.stats())


@pytest.mark.parametrize("kernel", [True, False], ids=["kernel", "gather"])
def test_dense_port_serves_what_the_reference_serves(dense_setup, kernel):
    """`test_port_serves_what_the_reference_serves` on granite-3-2b,
    qwen3-4b, starcoder2-3b, qwen3-14b and phi3.5-moe: tokens, served
    nodes, chunk stats and segment counters equal."""
    setup, reference = dense_setup
    _check_chunked_serve(setup, reference, kernel, "recall_index")


@pytest.fixture(scope="module")
def stw_reference():
    """The JAX package's stop-the-world serves, one per (model, KV mode,
    policy) (built on first use)."""
    runs = {}

    def get(setup, kv, policy):
        cfg, params, casc, _, _ = setup
        if (cfg.name, kv, policy) not in runs:
            requests = _requests(JRequest, cfg, policy=policy)
            bank, sid_of = jrt.build_bank(
                requests, _factory(jserve, casc), (policy, None))
            stepper = jrt.EngineStepper(params, cfg, bank, n_lanes=2,
                                        cache_len=32, prompt_len=PROMPT_LEN,
                                        kv=kv, page_size=8)
            metrics, nodes = _serve_logged(jrt, stepper, sid_of, requests)
            runs[cfg.name, kv, policy] = (requests, metrics, nodes,
                                          None if stepper.pool is None
                                          else stepper.pool.stats())
        return runs[cfg.name, kv, policy]

    return get


@pytest.mark.parametrize(
    "model,kv,kernel,policy",
    [("attn", "ring", False, "recall_index"),
     ("attn", "ring", True, "recall_index"),
     ("attn", "paged", False, "recall_index"),
     ("ssm", "ring", False, "recall_index"),
     ("ssm", "ring", True, "recall_index"),
     ("ssm", "paged", False, "recall_index"),
     ("mla", "ring", False, "recall_index"),
     ("mla", "ring", True, "recall_index"),
     ("mla", "paged", False, "recall_index"),
     ("hybrid", "ring", False, "recall_index"),
     ("hybrid", "ring", True, "recall_index"),
     ("hybrid", "paged", False, "recall_index"),
     ("hybrid", "paged", True, "recall_index")]
    + [("attn", "ring", False, p) for p in POLICIES],
    ids=["ring", "ring-flash", "paged", "ssm-ring", "ssm-ring-ssd",
         "ssm-paged", "mla-ring", "mla-ring-flash", "mla-paged",
         "hybrid-ring", "hybrid-ring-kernels", "hybrid-paged",
         "hybrid-paged-kernels"]
    + [f"ring-{p}" for p in POLICIES])
def test_stop_the_world_serves_what_the_reference_serves(
        request, stw_reference, model, kv, kernel, policy):
    """``kernel``: the flash route (attention; an MLA model's attention
    never takes it, in either package) or the ssd-chunk route (SSM),
    whose plain versions run on the CPU.  ``mla``: deepseek-v2-lite's
    smoke size (MLA attention, MoE MLPs with a shared expert); its ring
    serve masks the inactive lanes' latent-cache slots by their
    ``pos`` leaf (an MLA cache has no ``k``).  ``hybrid``: hymba-1.5b's
    smoke size, whose segments hold attention and SSM state side by
    side; ``kernel`` takes the flash and ssd-chunk routes and, paged,
    the paged-decode switch."""
    setup = request.getfixturevalue(STW_SETUPS[model])
    cfg, _, _, tparams, tcasc = setup
    jreqs, jm, jnodes, jpool = stw_reference(setup, kv, policy)
    requests = _requests(TRequest, cfg, policy=policy)
    bank, sid_of = trt.build_bank(requests, _factory(tserve, tcasc),
                                  (policy, None))
    stepper = trt.EngineStepper(tparams, cfg, bank, n_lanes=2, cache_len=32,
                                prompt_len=PROMPT_LEN, kv=kv, page_size=8,
                                use_flash=kernel and model != "ssm",
                                use_ssd_kernel=kernel and model in (
                                    "ssm", "hybrid"),
                                paged_kernel=kernel and kv == "paged")
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


@pytest.mark.parametrize("arch,extra", [
    ("qwen3-14b", ["--kv", "paged", "--prefill-chunk", "8"]),
    ("phi3.5-moe-42b-a6.6b", ["--kv", "paged", "--prefill-chunk", "8"]),
    ("deepseek-v2-lite-16b", ["--kv", "paged"]),
    ("deepseek-v2-lite-16b", ["--kv", "ring"]),
    ("hymba-1.5b", ["--kv", "paged", "--ssd-kernel"]),
    ("hymba-1.5b", ["--kv", "ring", "--ssd-kernel"])],
    ids=["qwen3-14b", "phi3.5-moe", "deepseek-paged", "deepseek-ring",
         "hymba-paged", "hymba-ring"])
def test_launcher_serves_the_new_families_on_cpu(arch, extra):
    """``--arch`` takes the new token-input configs through the
    registry, with the kernel flags on (plain versions on the CPU; an
    MLA model's attention takes none of them): every request completes
    with its full token count."""
    torch.set_num_threads(2)
    run = tserve.main(["--arch", arch, "--smoke", "--device", "cpu",
                       "--server", "--paged-kernel", "--flash",
                       "--dp-kernel", "--page-size", "8", "--lanes", "2",
                       "--rate", "6", "--duration", "0.5", "--tokens", "4",
                       "--prompt-len", "10"] + extra)
    assert run is not None and run.requests
    for req in run.requests:
        assert run.metrics.records[req.rid].n_tokens == req.max_tokens


@pytest.mark.parametrize("arch", ["musicgen-large", "phi-3-vision-4.2b"])
def test_launcher_refuses_models_that_take_no_tokens(arch):
    """The launcher draws token prompts, so an embeds- or multimodal-input
    model is refused by name, before any weights are made."""
    with pytest.raises(SystemExit, match="token-input"):
        tserve.main(["--arch", arch, "--smoke", "--device", "cpu"])
    with pytest.raises(SystemExit, match="token-input"):
        tserve.main(["--cascade", f"paper-ee-100m:{arch}", "--smoke",
                     "--device", "cpu"])


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


def test_launcher_policy_choices_are_the_reference():
    """The port's --policy choices, aliases and online list are the JAX
    launcher's; every choice parses, the hindsight oracles do not."""
    assert tserve.ALIASES == jserve.ALIASES
    assert tserve.ONLINE == jserve.ONLINE
    choices = sorted(set(jserve.ONLINE) | set(jserve.ALIASES))
    for name in choices:
        assert tserve.parse_args(["--policy", name]).policy == name
    for name in ("oracle", "oracle_norecall"):
        with pytest.raises(SystemExit):
            tserve.parse_args(["--policy", name])
    args = tserve.parse_args([])
    assert (args.threshold, args.patience) == (0.4, 2)


def test_build_strategy_follows_the_reference(setup):
    """The threshold and patience family pins lam = 1.0 and refuses a
    per-request lam; skip_recall takes cumulative edge costs on one
    model; the others take the per-request lam."""
    _, _, casc, _, tcasc = setup
    for name in ("norecall_threshold", "recall_threshold",
                 "norecall_patience"):
        for mod, c in ((jserve, casc), (tserve, tcasc)):
            strat = mod.build_strategy(name, c, threshold=0.25, patience=3)
            assert strat.lam == 1.0
            with pytest.raises(ValueError, match="per-request lam"):
                mod.build_strategy(name, c, threshold=0.25, patience=3,
                                   lam=0.7)
        t = tserve.build_strategy(name, tcasc, threshold=0.25, patience=3)
        if name == "norecall_patience":
            assert t.patience == 3
        else:
            assert float(t.thresholds[0]) == pytest.approx(0.25)
    s = tserve.build_strategy("skip_recall", tcasc, threshold=0.4,
                              patience=2, lam=0.7)
    assert tcasc.skip_mode == "cumulative" and s.lam == 0.7
    assert tserve.build_strategy("tree_index", tcasc, threshold=0.4,
                                 patience=2).lam == tcasc.lam


@pytest.mark.parametrize("policy", ["threshold", "skip_recall"])
def test_launcher_takes_aliases_and_new_policies_on_cpu(capsys, policy):
    """--policy threshold (the alias of norecall_threshold) on the
    one-shot path and skip_recall on the ring server run end to end;
    skip_recall calibrates but solves no line tables."""
    torch.set_num_threads(2)
    argv = ["--smoke", "--device", "cpu", "--policy", policy,
            "--tokens", "4", "--prompt-len", "10"]
    if policy == "skip_recall":
        argv += ["--server", "--lanes", "2", "--rate", "6",
                 "--duration", "0.5"]
    else:
        argv += ["--batch", "3", "--cache-len", "16", "--threshold", "0.9"]
    run = tserve.main(argv)
    out = capsys.readouterr().out
    if policy == "threshold":
        assert "strategy: norecall_threshold (registry: " in out
        assert run.stats.tokens.shape == (3, 4)
    else:
        assert "strategy: skip_recall (registry: " in out
        assert "calibrated T-Tamer tables" not in out
        assert run.cascade.skip_mode == "cumulative"
        assert run.cascade.line_tables is None
        for req in run.requests:
            assert run.metrics.records[req.rid].n_tokens == req.max_tokens


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
                "kernels/ssd_chunk", "models/ssm", "configs/mamba2_130m",
                "kernels/ramp_exit", "core/skip_dp", "core/tree_dp",
                "core/traces", "core/brute_force", "core/impossibility",
                "core/pareto", "strategy/oracle", "strategy/skip",
                "configs/granite_3_2b", "configs/qwen3_4b",
                "configs/starcoder2_3b", "configs/qwen3_14b",
                "configs/musicgen_large", "configs/phi3_vision_4_2b",
                "configs/phi3_5_moe_42b", "configs/deepseek_v2_lite_16b",
                "models/moe", "serving/control/telemetry",
                "serving/control/gears", "serving/control/swap",
                "serving/control/recalibrate", "serving/control/controller",
                "bench/adaptive", "serving/faults/plan",
                "serving/faults/governor", "serving/obs/__init__",
                "serving/obs/trace", "serving/obs/registry",
                "serving/obs/export", "serving/obs/flight",
                "serving/obs/audit", "serving/obs/replay",
                "serving/obs/lossmap", "serving/obs/pareto",
                "serving/obs/regret", "serving/obs/report",
                "data/pipeline", "training/optimizer",
                "training/checkpoint", "training/loop", "launch/train",
                "examples/train_ee", "configs/hymba_1_5b", "models/quant",
                "launch/shapes", "launch/flops", "sharding/__init__",
                "sharding/rules", "sharding/ctx", "launch/mesh",
                "launch/op_cost", "launch/dryrun", "launch/diagnose"):
        assert f"src/repro_torch/{mod}.py" in names
    bad = []
    for path in files:
        tree = ast.parse(path.read_text(), str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for name in names:
                if name.split(".")[0] in ("jax", "jaxlib", "repro",
                                          "benchmarks", "msgpack",
                                          "ml_dtypes"):
                    bad.append(f"{path.relative_to(ROOT)}:{node.lineno} "
                               f"imports {name}")
        guarded = {id(n) for t in ast.walk(tree) if isinstance(t, ast.Try)
                   for b in t.body for n in ast.walk(b)}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import) and id(node) not in guarded \
                    and any(a.name == "zstandard" for a in node.names):
                bad.append(f"{path.relative_to(ROOT)}:{node.lineno} "
                           "imports zstandard outside a try")
    assert not bad, "\n".join(bad)
