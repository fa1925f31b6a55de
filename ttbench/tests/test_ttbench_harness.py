"""The harness without the card: a cell made entirely of files in a
temporary directory runs through it (a new configuration, traffic mix,
per-layer metric, configuration family and kernel cost need only new
files), a run without a card prints no result, and a run whose timed
path is broken comes out not correct."""

import json
import shutil
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from ttbench import harness

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent

NEW_METRIC = '''"""A reader added by a file alone: decode-only steps in the window."""

from ttbench.lib.layer import window_steps


def read(run):
    steps = [dt for dt, chunk in window_steps(run) if not chunk]
    return float(len(steps)) if steps else None
'''


def _cell_dir(tmp: Path) -> Path:
    """BENCHMARK.json, a configuration, two traffic mixes and one new
    metric, written to ``tmp``."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    here = tmp / "bench"
    for sub in ("configs", "traffic", "metrics", "families", "costs"):
        (here / sub).mkdir(parents=True)
    shutil.copy(HERE / "families" / "dense.py", here / "families")
    for sub in ("metrics", "costs"):
        for f in (HERE / sub).glob("*.py"):
            shutil.copy(f, here / sub)
    (here / "metrics" / "decode_steps_seen.py").write_text(NEW_METRIC)
    cfg = json.loads((HERE / "configs" / "paper-ee-100m.json").read_text())
    cfg.update(name="tiny", num_hidden_layers=4, hidden_size=64,
               num_attention_heads=4, num_key_value_heads=2, head_dim=16,
               intermediate_size=128, vocab_size=512, n_segments=2,
               hidden_act="silu")
    cfg["serving"].update(lanes=4, cache_len=128, prefill_chunk=8)
    cfg["calibration"].update(prompts=64, length=16)
    (here / "configs" / "tiny.json").write_text(json.dumps(cfg))
    mix = json.loads((HERE / "traffic" / "chat-recall-ee100m.json")
                     .read_text())
    # two tiers, and a load that keeps the four lanes busy, so a fault in
    # half of them reaches the sample
    mix.update(tiers=[{"strategy": "recall_index", "share": 0.75},
                      {"strategy": "always_last", "share": 0.25}],
               rate=30.0, prompt={"median": 20, "sigma": 0.5, "min": 4,
                                 "max": 60},
               output={"median": 6, "sigma": 0.5, "min": 2, "max": 20})
    (here / "traffic" / "tiny-tier.json").write_text(json.dumps(mix))
    bench.update(paths=["bench"], configs=[{
        "name": "tiny", "source": "test", "file": "bench/configs/tiny.json",
        "reduced": [], "why": "test"}],
        workloads=[{"name": "tiny-tier", "config": "tiny",
                    "traffic": "tiny-tier", "chips": 1, "why": "test"}])
    for x in bench["end_to_end"] + bench["per_layer"]:
        x.pop("workloads", None)
    bench["per_layer"].append({
        "name": "decode_steps_seen", "unit": "steps", "better": "higher",
        "source": "program_span", "layer": "stepper",
        "moves": "itl_p95_ms"})
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp


ALT_FAMILY = '''"""A second family, added by a file alone: the dense one,
wrapped so that it records each reference it builds and counts its FLOP
calls."""

from ttbench.families import dense
from ttbench.families.dense import make_weights, program_config, shapes

BUILT = []
CALLS = {"prompt_flops": 0, "probe_flops": 0}


class Model(dense.Model):
    def __init__(self, m, params, chunk, control=False):
        super().__init__(m, params, chunk, control=control)
        BUILT.append((chunk, control))


def prompt_flops(*a):
    CALLS["prompt_flops"] += 1
    return dense.prompt_flops(*a)


def probe_flops(*a):
    CALLS["probe_flops"] += 1
    return dense.probe_flops(*a)
'''

MADE_UP_COST = '''"""A kernel added by a file alone: its input's bytes, 2
operations an element."""

import torch


def cost(inputs, outputs):
    n = torch.tensor(float(inputs[0].numel()), dtype=torch.float64)
    return n * inputs[0].element_size(), 2 * n
'''


def _run(root, trace=False, seed=2**31 + 3):
    return harness.run_cell(root, "tiny-tier", seed, 2.0, trace,
                            torch.device("cpu"), time.perf_counter())


def test_a_cell_of_new_files_runs(tmp_path):
    root = _cell_dir(tmp_path)
    plain = _run(root)
    assert plain["correct"] is True and plain["attempted"] > 5
    assert set(plain["metrics"]) == {"tokens_per_s", "ttft_p95_ms",
                                     "itl_p95_ms", "setup_s"}
    assert list(plain)[-1] == "check"
    traced = _run(root, trace=True)
    assert traced["correct"] is True
    assert traced["metrics"]["decode_steps_seen"]["value"] > 0
    # what the CPU cannot read is left out, never written as 0
    for name in ("device_idle_share", "step_mfu", "paged_decode_roofline"):
        assert name not in traced["metrics"]
    assert traced["metrics"]["probes_per_token"]["value"] >= 1.0


def test_no_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = harness.main(["--workload", "ee100m-chat-recall", "--seed", "1",
                       "--seconds", "1"], ROOT, time.perf_counter())
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""
    assert "CUDA" in out.err


def _alter_tokens(monkeypatch):
    from repro_torch.serving.runtime import scheduler
    orig = scheduler.make_token_step

    def make(*a, **k):
        step = orig(*a, **k)

        def faulty(*sa, **sk):
            out = step(*sa, **sk)
            return ((out[0] + 1) % 512,) + tuple(out[1:])
        return faulty

    monkeypatch.setattr(scheduler, "make_token_step", make)


def _state_unchanged(monkeypatch):
    from repro_torch.models import attention
    monkeypatch.setattr(attention, "_write_kv", lambda *a, **k: None)


def _half_batch(monkeypatch):
    from repro_torch.models import model as M
    orig = M.decode_segment

    def faulty(params, cfg, si, x, *a, **k):
        y, cache, ro = orig(params, cfg, si, x, *a, **k)
        half = x.shape[0] // 2
        y = torch.cat([y[:half], x[half:]])
        if ro is not None:
            ro = M.ramp_readout(params, cfg, y[:, 0, :], segment=si)
        return y, cache, ro

    monkeypatch.setattr(M, "decode_segment", faulty)


@pytest.mark.parametrize("fault", [_alter_tokens, _state_unchanged,
                                   _half_batch],
                         ids=["token_altered", "state_unchanged",
                              "half_batch_left_out"])
def test_a_broken_timed_path_is_not_correct(tmp_path, monkeypatch, fault):
    root = _cell_dir(tmp_path)
    fault(monkeypatch)
    out = _run(root)
    assert out["correct"] is False
    assert out["check"]["served_gap"]["value"] > \
        out["check"]["served_gap"]["limit"]


def test_a_second_family_is_served_and_judged_through_its_files(
        tmp_path, monkeypatch):
    from ttbench.families import dense
    from ttbench.reference import check
    from ttbench.tests.test_ttbench_families import made_up_phase
    root = _cell_dir(tmp_path)
    here = root / "bench"
    (here / "families" / "tiny_alt.py").write_text(ALT_FAMILY)
    path = here / "configs" / "tiny.json"
    path.write_text(json.dumps(dict(json.loads(path.read_text()),
                                    family="tiny_alt")))
    cells, seen = [], {}

    class Kept(harness.Cell):
        def __init__(self, *a):
            super().__init__(*a)
            cells.append(self)

    monkeypatch.setattr(harness, "Cell", Kept)
    for name in ("reference_tables", "judge"):
        def keep(*a, _inner=getattr(harness, name), _name=name, **k):
            seen[_name] = (a, k, _inner(*a, **k))
            return seen[_name][2]
        monkeypatch.setattr(harness, name, keep)
    out = _run(root)
    assert out["correct"] is True
    alt = cells[0].family
    assert alt.Model.__module__ == alt.__name__ != dense.__name__
    chunk = cells[0].config["serving"]["prefill_chunk"]
    # the tables' reference (chunk 1) and the judge's, nothing else
    assert alt.BUILT == [(1, False), (chunk, False)]
    # the readings are the dense family's on the same inputs
    (cell, params, calib), _, tables = seen["reference_tables"]
    cal = cell.config["calibration"]
    want = check.tables_of(dense.Model, cell.m, params, calib, cal["lam"],
                           cal["k"])
    for field in ("grid", "edges", "stop"):
        assert np.array_equal(getattr(tables, field), getattr(want, field))
    assert tables.value == want.value
    (_, _, tables, chosen, cols), _, got = seen["judge"]
    want = check.served_gap(dense.Model, cell.m, params, chunk, tables,
                            chosen, cols)
    assert {k: v for k, v in got.items() if k != "requests"} == want
    assert got["served_gap"] == out["check"]["served_gap"]["value"]
    # the whole step's count goes through the family's FLOP functions
    reader = cell.readers["step_mfu"]
    run = made_up_phase(alt, cell.m)
    assert reader.read(run) == reader.read(made_up_phase(dense, cell.m))
    assert alt.CALLS["prompt_flops"] > 0 and alt.CALLS["probe_flops"] > 0


def test_a_kernels_cost_module_is_found_by_file(tmp_path):
    root = _cell_dir(tmp_path)
    (root / "bench" / "costs" / "made_up_kernel.py").write_text(MADE_UP_COST)
    cell = harness.Cell(root, "tiny-tier")
    assert set(cell.costs) == {"paged_attention", "paged_prefill",
                               "made_up_kernel"}
    rec = harness._LaunchCost(cell.costs)
    x = torch.ones(3, 5)
    rec.kernel("made_up_kernel", (x,), (x,))
    rec.kernel("made_up_kernel", (x[:2],), (x,))
    rec.kernel("no_such_kernel", (x,), (x,))          # not costed
    got = rec.totals()
    assert set(got) == {"made_up_kernel"}
    assert got["made_up_kernel"].tolist() == [[60.0, 30.0], [40.0, 20.0]]
    # without a directory, the benchmark's own cost modules
    assert set(harness._LaunchCost().fns) == {"paged_attention",
                                              "paged_prefill"}
