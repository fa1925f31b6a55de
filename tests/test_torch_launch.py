"""The port's launcher (repro_torch.launch.serve) under the control
plane, on the CPU:

  * ``_build_adaptive``'s gear bank — calibrated on the model's own
    losses — equals the reference's gear order, slots and prices (within
    1e-9) when both packages get the same numpy prompts (the reference
    launcher draws its own with jax.random) and the same bridged
    weights;
  * ``--adaptive`` serves a diurnal workload on the engine stepper with
    gear switching (no recalibration there, as in the reference), every
    request complete, the gear bank and the controller's report
    printed;
  * the observability flags: ``--obs-dir --regret --trace-out`` on the
    single-model server and ``--trace-out --metrics-out
    --flight-recorder`` on ``--cascade`` write artifacts that the
    reference's `benchmarks.check_trace` validators accept;
    ``--profile-dir`` writes a Chrome trace, and a capture that should
    hold the card's events but holds none raises.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.launch import serve as jserve
from repro.models import model as M
from repro.models.param import materialize
from repro.serving import control as jcontrol
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config as t_get_config
from repro_torch.launch import serve as tserve

CPU = "cpu"
PRICE = dict(rel=1e-9, abs=1e-9)


def test_build_adaptive_follows_the_reference(capsys):
    """The launcher's gear bank from the model's own losses: the same
    numpy prompts (the reference draws its own with jax.random) and the
    same bridged weights give the reference's gear order, slots and
    prices."""
    torch.set_num_threads(2)
    cfg = get_config("qwen3-4b", smoke=True)
    params = materialize(M.model_defs(cfg), jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, params))
    args = tserve.parse_args(["--arch", "qwen3-4b", "--smoke", "--device",
                              "cpu", "--adaptive", "--lanes", "4"])
    bank, ctl = tserve._build_adaptive(
        args, t_get_config("qwen3-4b", smoke=True), tparams,
        torch.device(CPU), mean_tokens=10.0, slo=1.0)
    assert "gear bank (quality-first): " in capsys.readouterr().out
    toks = np.random.default_rng(args.seed + 1).integers(
        0, cfg.vocab, (tserve.GEAR_PROMPTS, tserve.GEAR_LEN))
    _, _, nl, _ = M.prefill(params, cfg,
                            {"tokens": jnp.asarray(toks, jnp.int32)},
                            cache_len=tserve.GEAR_CACHE)
    rows = np.asarray(nl, np.float64)
    n = rows.shape[1]
    jbank = jcontrol.GearPlanner(
        rows, np.full(n, 1.0 / n), k=tserve.GEAR_K, seg_time=0.01,
        overhead=0.002, n_lanes=4, mean_tokens=10.0).plan(
            jserve.parse_gears(args.gears))
    assert [(g.name, g.slot) for g in bank] == \
        [(g.name, g.slot) for g in jbank]
    for g, jg in zip(bank, jbank):
        assert g.work == pytest.approx(jg.work, **PRICE)
        assert g.max_rate == pytest.approx(jg.max_rate, **PRICE)
    assert ctl.bank is bank and ctl.recal is None


def test_launcher_serves_adaptive_on_cpu(capsys):
    """``--adaptive`` on the engine stepper: gear switching on a diurnal
    workload, every request complete, the gear bank and the controller's
    report printed."""
    torch.set_num_threads(2)
    run = tserve.main([
        "--arch", "qwen3-4b", "--smoke", "--device", "cpu", "--adaptive",
        "--policy", "always_last",
        "--kv", "paged", "--paged-kernel", "--prefill-chunk", "8",
        "--page-size", "8", "--lanes", "2", "--rate", "6", "--duration",
        "1", "--tokens", "4", "--prompt-len", "10", "--workload",
        "diurnal", "--recal-interval", "0.5"])
    out = capsys.readouterr().out
    assert "gear bank (quality-first): " in out
    assert "adaptive: final gear " in out
    assert "--recal-interval applies to sim steppers" in out
    st = run.controller.stats()
    assert st["recalibrations"] == 0 and len(st["gears"]) == 3
    assert not hasattr(run.stepper, "bank_source")
    for req in run.requests:
        assert run.metrics.records[req.rid].n_tokens == req.max_tokens


def _validated(path, validate):
    with open(path) as f:
        doc = json.load(f)
    assert validate(doc) == [], path
    return doc


def test_launcher_obs_bundle_on_cpu(tmp_path, capsys):
    """``--obs-dir`` with ``--regret`` (and ``--trace-out`` naming its
    own sink) on the chunked paged server: every artifact is written and
    valid, the ledger is clean, and the trace counts every token and
    every computed prompt token."""
    from benchmarks.check_trace import (validate_events, validate_ledger,
                                        validate_metrics, validate_pareto,
                                        validate_regret, validate_trace)
    torch.set_num_threads(2)
    obs_dir, trace = tmp_path / "obs", tmp_path / "own_trace.json"
    run = tserve.main([
        "--smoke", "--device", "cpu", "--server", "--kv", "paged",
        "--paged-kernel", "--prefill-chunk", "8", "--page-size", "8",
        "--lanes", "4", "--rate", "8", "--duration", "1", "--tokens", "6",
        "--prompt-len", "12", "--obs-dir", str(obs_dir), "--regret",
        "--trace-out", str(trace)])
    out = capsys.readouterr().out
    for head in ("trace: ", "ledger: ", "lossmap: ", "regret: ",
                 "pareto: "):
        assert head in out, head
    assert "(PASS)" in out
    doc = _validated(trace, validate_trace)
    assert not (obs_dir / "trace.json").exists()   # the flag's own sink
    events = _validated(obs_dir / "events.json", validate_events)
    _validated(obs_dir / "metrics.json", validate_metrics)
    ledger = _validated(obs_dir / "ledger.json", validate_ledger)
    _validated(obs_dir / "regret.json", validate_regret)
    _validated(obs_dir / "pareto.json", validate_pareto)
    assert ledger["total_violations"] == 0
    assert doc["otherData"]["span_digest"] == events["span_digest"]
    kinds = [ev["kind"] for ev in events["events"]]
    assert kinds.count("token") == run.metrics.summary()["tokens"]
    assert sum(ev["width"] for ev in events["events"]
               if ev["kind"] == "prefill_chunk") == \
        run.stepper.chunk_stats["tokens_computed"]
    assert run.obs.regret.report()["mode"] == "expected"
    assert run.calib_s > 0.0


def test_launcher_cascade_obs_on_cpu(tmp_path):
    """``--trace-out``, ``--metrics-out`` and ``--flight-recorder`` on the
    cascade path: the trace carries the escalations, the artifacts are
    valid."""
    from benchmarks.check_trace import validate_metrics, validate_trace
    torch.set_num_threads(2)
    run = tserve.main([
        "--smoke", "--device", "cpu", "--cascade",
        "paper-ee-100m:paper-ee-100m", "--paged-kernel", "--prefill-chunk",
        "8", "--page-size", "8", "--policy", "skip_recall", "--lanes", "2",
        "--cascade-lanes", "1", "--rate", "4", "--duration", "1",
        "--tokens", "4", "--prompt-len", "10", "--cache-len", "32",
        "--trace-out", str(tmp_path / "trace.json"), "--metrics-out",
        str(tmp_path / "metrics.json"), "--flight-recorder",
        str(tmp_path / "flight")])
    doc = _validated(tmp_path / "trace.json", validate_trace)
    _validated(tmp_path / "metrics.json", validate_metrics)
    kinds = {ev.kind for ev in run.obs.tracer.events}
    assert {"queued", "admitted", "prefill_chunk", "token", "finish",
            "counter"} <= kinds
    if run.cascade_stats["escalations"]:
        assert {"escalate", "esc_resolve"} <= kinds
        assert any(ev["pid"] == 1 for ev in doc["traceEvents"]
                   if ev["ph"] == "i")
    assert run.calib_s > 0.0


def test_launcher_profile_dir_writes_a_chrome_trace(tmp_path, monkeypatch):
    """``--profile-dir`` captures the serve loop with `torch.profiler`
    (host activity on the CPU); a capture meant for the card that holds
    no device event raises instead of writing an empty trace."""
    from repro_torch.serving.obs.export import PROFILE_TRACE, profiler_capture
    torch.set_num_threads(2)
    tserve.main([
        "--smoke", "--device", "cpu", "--server", "--kv", "paged",
        "--paged-kernel", "--prefill-chunk", "8", "--page-size", "8",
        "--lanes", "2", "--rate", "8", "--duration", "0.3", "--tokens",
        "3", "--prompt-len", "8", "--profile-dir", str(tmp_path / "prof")])
    with open(tmp_path / "prof" / PROFILE_TRACE) as f:
        trace = json.load(f)
    assert any(ev.get("cat") == "cpu_op" for ev in trace["traceEvents"])
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    with pytest.raises(RuntimeError, match="no device event"):
        with profiler_capture(str(tmp_path / "card"), device="cuda"):
            torch.ones(4).sum()
    assert not os.path.exists(tmp_path / "card" / PROFILE_TRACE)


def test_launcher_obs_flags_follow_the_reference():
    """The six observability flags and their defaults, as the reference
    launcher has them; an obs flag alone builds the plane."""
    args = tserve.parse_args([])
    assert (args.trace_out, args.metrics_out, args.flight_recorder,
            args.obs_dir, args.regret, args.profile_dir) == \
        (None, None, None, None, False, None)
    assert tserve._build_obs(args) is None
    obs = tserve._build_obs(tserve.parse_args(["--regret"]))
    assert obs.regret is not None and obs.ledger is None
