"""The harness without the card: a cell made entirely of files in a
temporary directory runs through it (a new configuration, traffic mix
and per-layer metric need only new files), a run without a card prints
no result, and a run whose timed path is broken comes out not
correct."""

import json
import shutil
import time
from pathlib import Path

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
    for sub in ("configs", "traffic", "metrics", "families"):
        (here / sub).mkdir(parents=True)
    shutil.copy(HERE / "families" / "dense.py", here / "families")
    for f in (HERE / "metrics").glob("*.py"):
        shutil.copy(f, here / "metrics")
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
