"""The routing tie band leaves a dense configuration as it was: its
reference takes ``pick`` and never branches, its readings are the same
with and without the band, and its result line gains no check.  Every
family's ``Model.decode`` takes ``pick``."""

import inspect
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from ttbench import harness
from ttbench.families import DECODE_KEYWORDS
from ttbench.reference import check
from ttbench.tests.test_ttbench_harness import _cell_dir, _run

HERE = Path(__file__).resolve().parents[1]


def test_a_dense_run_reads_the_same_with_the_band(tmp_path, monkeypatch):
    root = _cell_dir(tmp_path)
    seen = {}

    def keep(*a, _inner=harness.judge, **k):
        seen["judge"] = a
        return _inner(*a, **k)

    monkeypatch.setattr(harness, "judge", keep)
    out = _run(root)
    assert out["correct"] is True
    assert list(out["check"]) == ["served_gap", "judged_tokens"]
    cell, params, tables, chosen, cols = seen["judge"]
    chunk = cell.config["serving"]["prefill_chunk"]
    for control in (False, True):
        plain = check.served_gap(cell.family.Model, cell.m, params, chunk,
                                 tables, chosen, cols, control=control)
        band = check.served_gap(cell.family.Model, cell.m, params, chunk,
                                tables, chosen, cols, control=control,
                                tie=1e-5)
        assert band == plain
        assert (band["ties"], band["followed"], band["capped"]) == (0, 0, 0)
        if not control:
            assert band["served_gap"] == out["check"]["served_gap"]["value"]


def test_the_dense_reference_takes_pick_and_never_calls_it():
    from ttbench.lib.shapes import dense
    from ttbench.reference.dense import Model, make_weights
    from ttbench.reference.tables import calibrate
    cfg = json.loads((HERE / "configs" / "paper-ee-100m.json").read_text())
    cfg.update(num_hidden_layers=4, n_segments=2, vocab_size=512,
               hidden_size=64, num_attention_heads=4,
               num_key_value_heads=2, head_dim=16, intermediate_size=128)
    m = dense(cfg)
    params = make_weights(m, 3, "cpu")
    tables = calibrate(np.full((8, m.n_nodes), 0.9), 0.5, 4)
    prompt = torch.arange(19) % m.vocab

    def pick(branches):
        raise AssertionError("a dense reference has no branches")

    pick.tau, pick.max_branches = 1.0, 8
    outs = []
    for kw in ({}, {"pick": pick}):
        ref = Model(m, params, 8)
        x, kv = ref.prompt(prompt, room=4)
        outs.append([ref.decode(t, 19 + i, kv, "recall_index", tables, **kw)
                     for i, t in enumerate([5, 7, 11, 13])])
        assert (ref.ties, ref.followed, ref.capped) == (0, 0, 0)
    for (s0, l0, d0), (s1, l1, d1) in zip(*outs):
        assert (s0, d0) == (s1, d1) and set(l0) == set(l1)
        assert all(torch.equal(l0[n], l1[n]) for n in l0)


FAMILIES = sorted(p for p in (HERE / "families").glob("*.py")
                  if not p.stem.startswith("_"))


@pytest.mark.parametrize("path", FAMILIES, ids=lambda p: p.stem)
def test_every_family_decode_takes_pick(path):
    params = inspect.signature(harness._module(path).Model.decode).parameters
    for name in DECODE_KEYWORDS:
        assert name in params and params[name].default is None, name


@pytest.mark.parametrize("missing", ["routing_tie_why", "followed_share"])
def test_a_band_without_its_reason_or_share_is_refused(tmp_path, missing):
    root = _cell_dir(tmp_path)
    path = root / "bench" / "configs" / "tiny.json"
    cfg = json.loads(path.read_text())
    cfg["check"].update(routing_tie=1e-5, routing_tie_why="test",
                        followed_share=0.01)
    del cfg["check"][missing]
    path.write_text(json.dumps(cfg))
    with pytest.raises(ValueError, match=missing):
        harness.tie_band(harness.Cell(root, "tiny-tier"))
