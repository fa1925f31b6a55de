"""On the card: one short run of a cell through the command the driver
runs, and the control failing at a cell's own widths.

    python -m pytest -q -m cuda ttbench/tests
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.cuda
def test_a_short_run_prints_a_correct_result(card):
    out = subprocess.run(
        [sys.executable, "ttbench/run.py", "--workload",
         "ee100m-chat-recall", "--seed", str(2**31 + 17), "--seconds", "6",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert set(line["metrics"]) == {"tokens_per_s", "ttft_p95_ms",
                                    "itl_p95_ms", "setup_s"}
    assert line["device"]["platform"] == "gpu"
    assert list(line)[-1] == "check"
    assert out.stderr.strip().splitlines()[-1].startswith("check ")


@pytest.mark.cuda
def test_the_control_reads_above_the_limit_at_full_width(card):
    from ttbench.lib.shapes import dense
    from ttbench.harness import check_cols
    from ttbench.reference.check import served_gap
    from ttbench.reference.dense import Model, make_weights
    from ttbench.reference.tables import calibrate
    cfg = json.loads((ROOT / "ttbench" / "configs" / "paper-ee-100m.json")
                     .read_text())
    m = dense(cfg)
    params = make_weights(m, 3, card)
    tables = calibrate(np.full((8, m.n_nodes), 0.9), 0.5, 4)
    rng = np.random.default_rng(0)
    sample = []
    cols = check_cols(m.vocab, 3)
    ref = Model(m, params, cfg["serving"]["prefill_chunk"])
    for _ in range(3):
        prompt = rng.integers(0, m.vocab, 600).astype(np.int32)
        x, kv = ref.prompt(torch.as_tensor(prompt, device=card), room=40)
        first = int(ref.readout(m.n_nodes - 1, x[-1]).argmax())
        toks, tok, rows, nodes = [], first, [], []
        for i in range(40):
            served, logits, _ = ref.decode(tok, 600 + i, kv,
                                           "recall_index", tables)
            tok = int(logits[served].argmax())
            toks.append(tok)
            rows.append(logits[served].cpu())
            nodes.append(served)
        rows = torch.stack(rows)
        sample.append({"prompt": prompt, "first": first, "tokens": toks,
                       "strategy": "recall_index", "nodes": nodes,
                       "rows": rows[:, cols].numpy(),
                       "top": rows.max(dim=1).values.numpy()})
    limit = cfg["check"]["served_gap"]
    assert served_gap(Model, m, params, 16, tables, sample, cols)[
        "served_gap"] == 0.0
    assert served_gap(Model, m, params, 16, tables, sample, cols,
                      control=True)["served_gap"] > limit
