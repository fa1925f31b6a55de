"""The yardstick's copies equal today's originals, and the traffic
repeats for a seed."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from ttbench.lib import flops, kernel_bytes, shapes, trace_read, traffic

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent


def _mix(name):
    return traffic.load(HERE / "traffic" / f"{name}.json")


def _tiered():
    """The chat mix with one request in four on a full-depth tier."""
    return dict(_mix("chat-recall-ee100m"), tiers=[
        {"strategy": "recall_index", "share": 0.75},
        {"strategy": "always_last", "share": 0.25}])


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 11])
def test_poisson_arrivals_equal_the_programs(seed):
    from repro_torch.serving.runtime import workload
    a = traffic.poisson_arrivals(3.5, 0.0, 20.0,
                                 np.random.default_rng(seed))
    b = workload._poisson_arrivals(3.5, 0.0, 20.0,
                                   np.random.default_rng(seed))
    assert a == b and len(a) > 30


@pytest.mark.parametrize("name", ["chat-recall-ee100m", "rag-recall-granite",
                                  "tiered"])
def test_traffic_repeats_for_a_seed_and_offers_equal_work(name):
    mix = _tiered() if name == "tiered" else _mix(name)
    one = traffic.make_requests(mix, 20.0, 2**31 + 5, 1000)
    two = traffic.make_requests(mix, 20.0, 2**31 + 5, 1000)
    other = traffic.make_requests(mix, 20.0, 12345, 1000)
    key = ("arrival", "max_tokens", "strategy")
    assert [tuple(r[k] for k in key) for r in one] == \
        [tuple(r[k] for k in key) for r in two]
    assert all((a["prompt"] == b["prompt"]).all() for a, b in zip(one, two))
    # another seed: the same schedule, other prompts
    assert [tuple(r[k] for k in key) for r in one] == \
        [tuple(r[k] for k in key) for r in other]
    assert [len(r["prompt"]) for r in one] == \
        [len(r["prompt"]) for r in other]
    assert any((a["prompt"] != b["prompt"]).any()
               for a, b in zip(one, other))
    assert all(0 <= r["arrival"] < 20.0 for r in other)
    assert abs(len(one) - mix["rate"] * 20.0) < 5 * (mix["rate"]
                                                     * 20.0) ** 0.5
    for r in one:
        assert mix["prompt"]["min"] <= len(r["prompt"]) \
            <= mix["prompt"]["max"]
        assert mix["output"]["min"] <= r["max_tokens"] <= mix["output"]["max"]


def test_tier_shares_are_exact():
    reqs = traffic.make_requests(_tiered(), 30.0, 3, 100)
    n_last = sum(r["strategy"] == "always_last" for r in reqs)
    assert n_last == round(0.25 * len(reqs))


@pytest.mark.parametrize("arch", ["paper-ee-100m", "granite-3-2b"])
@pytest.mark.parametrize("kind,batch,seq", [("prefill", 4, 512),
                                            ("decode", 64, 1024),
                                            ("train", 8, 256)])
def test_flops_equal_the_programs(arch, kind, batch, seq):
    from repro_torch.configs import get_config
    from repro_torch.launch.flops import model_flops
    m = shapes.dense(json.loads((HERE / "configs" / f"{arch}.json")
                                .read_text()))
    want = model_flops(get_config(arch), kind=kind, global_batch=batch,
                       seq_len=seq)
    assert flops.model_flops(m, kind=kind, global_batch=batch,
                             seq_len=seq) == pytest.approx(want, rel=1e-12)


def test_prompt_flops_sum_to_a_prefill():
    m = shapes.dense(json.loads((HERE / "configs" / "paper-ee-100m.json")
                                .read_text()))
    whole = flops.prompt_flops(m, 0, 64, True)
    parts = sum(flops.prompt_flops(m, s, 16, s == 48) for s in range(0, 64,
                                                                     16))
    assert parts == pytest.approx(whole, rel=1e-12)


@pytest.fixture(scope="module")
def smoke(monkeypatch_module=None):
    """``chip_smoke.py`` imported on the CPU, its cases made there."""
    import importlib
    import sys
    real = torch.cuda.is_available
    torch.cuda.is_available = lambda: True
    try:
        sys.path.insert(0, str(ROOT))
        mod = importlib.import_module("chip_smoke")
    finally:
        torch.cuda.is_available = real
    mod.DEV = torch.device("cpu")
    return mod


def _as_float(t):
    return float(t) if isinstance(t, torch.Tensor) else float(t)


@pytest.mark.parametrize("case", ["serve", "default", "long", "g4"])
def test_decode_bytes_equal_chip_smokes(smoke, case):
    kw = {"serve": dict(lens=smoke.SERVE_LENS), "default": {},
          "long": dict(lens=smoke.LONG_LENS, maxp=smoke.LONG_MAXP),
          "g4": dict(smoke.G4, lens=smoke.SERVE_LENS)}[case]
    args, opts = smoke.decode_case(4, **kw)
    want = smoke.decode_bound(args, opts)
    q, k, v, pos, table, q_pos = args
    got = kernel_bytes.decode_cost(q, k, pos, table, q_pos, opts["window"])
    assert tuple(map(_as_float, got)) == tuple(map(float, want))


@pytest.mark.parametrize("case", ["default", "serve", "long", "g4"])
def test_prefill_bytes_equal_chip_smokes(smoke, case):
    kw = {"default": {},
          "serve": dict(starts=smoke.SERVE_STARTS,
                        widths=smoke.SERVE_WIDTHS),
          "long": dict(starts=smoke.LONG_STARTS, maxp=smoke.LONG_MAXP,
                       widths=[smoke.C] * smoke.B),
          "g4": dict(smoke.G4)}[case]
    args, opts = smoke.prefill_case(5, **kw)
    want = smoke.prefill_bound(args, opts)
    q, k, v, pos, table, q_pos = args[:6]
    got = kernel_bytes.prefill_cost(q, k, pos, table, q_pos, opts["window"])
    assert tuple(map(_as_float, got)) == tuple(map(float, want))


def _cost_module(name):
    from ttbench.harness import _module
    return _module(HERE / "costs" / f"{name}.py")


@pytest.mark.parametrize("case", ["serve", "default", "long", "g4"])
def test_decode_cost_module_equals_kernel_bytes(smoke, case):
    kw = {"serve": dict(lens=smoke.SERVE_LENS), "default": {},
          "long": dict(lens=smoke.LONG_LENS, maxp=smoke.LONG_MAXP),
          "g4": dict(smoke.G4, lens=smoke.SERVE_LENS)}[case]
    args, opts = smoke.decode_case(4, **kw)
    q, k, v, pos, table, q_pos = args
    want = kernel_bytes.decode_cost(q, k, pos, table, q_pos, opts["window"])
    # the tensors the wrapper reports (`build.report_launch`)
    got = _cost_module("paged_attention").cost(args, (torch.empty(0),))
    assert all(g.dim() == 0 for g in got)
    assert tuple(map(float, got)) == tuple(map(float, want))


@pytest.mark.parametrize("case", ["default", "serve", "long", "g4"])
def test_prefill_cost_module_equals_kernel_bytes(smoke, case):
    kw = {"default": {},
          "serve": dict(starts=smoke.SERVE_STARTS,
                        widths=smoke.SERVE_WIDTHS),
          "long": dict(starts=smoke.LONG_STARTS, maxp=smoke.LONG_MAXP,
                       widths=[smoke.C] * smoke.B),
          "g4": dict(smoke.G4)}[case]
    args, opts = smoke.prefill_case(5, **kw)
    q, k, v, pos, table, q_pos = args[:6]
    want = kernel_bytes.prefill_cost(q, k, pos, table, q_pos, opts["window"])
    got = _cost_module("paged_prefill").cost(args[:6], (torch.empty(0),))
    assert all(g.dim() == 0 for g in got)
    assert tuple(map(float, got)) == tuple(map(float, want))


def test_step_split_and_merge_equal_chip_smokes(smoke):
    from repro_torch.serving.obs.trace import Event
    rng = np.random.default_rng(0)
    evs, t = [Event(t=0.0, kind="admitted", lane=0)], 0.0
    for i in range(200):
        t += float(rng.exponential(0.01))
        kind = ["admitted", "prefill_chunk", "token", "counter", "finish",
                "deadline_miss"][int(rng.integers(0, 6))]
        evs.append(Event(t=t, kind=kind, lane=int(rng.integers(-1, 3))))
    chunk, decode = smoke._step_split(evs)
    ours = trace_read.step_split([(e.t, e.kind, e.lane) for e in evs])
    assert [dt for _, dt, c in ours if c] == chunk
    assert [dt for _, dt, c in ours if not c] == decode
    spans = [(float(a), float(a + b)) for a, b in
             rng.uniform(0, 10, size=(50, 2))]
    assert trace_read.merged_us(spans) == smoke._merged_us(spans)
