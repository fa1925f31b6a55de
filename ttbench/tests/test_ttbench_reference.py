"""The plain reference against the program on CPU tensors, at small
widths: the same tables and decisions, the same served logits to
rounding, and a lower precision that fails the comparison."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from ttbench.lib.shapes import dense
from ttbench.reference import check, tables as T
from ttbench.reference.dense import Model, make_weights, tf32_round

HERE = Path(__file__).resolve().parents[1]


def _small(**kw):
    cfg = json.loads((HERE / "configs" / "paper-ee-100m.json").read_text())
    cfg.update(num_hidden_layers=4, n_segments=2, vocab_size=4096,
               hidden_size=128, num_attention_heads=4,
               num_key_value_heads=2, head_dim=32, intermediate_size=256)
    cfg.update(kw)
    return cfg


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tables_and_decisions_equal_the_programs(seed):
    from repro_torch import strategy
    rng = np.random.default_rng(seed)
    # correlated node losses, as ramps give
    base = rng.uniform(0.2, 0.9, size=(400, 1))
    losses = np.clip(base + rng.normal(0, 0.15, (400, 5)).cumsum(1) * 0.3,
                     0.01, 1.0)
    casc = strategy.Cascade.from_traces(
        losses, 0.5 * np.full(5, 0.2), k=12, lam=0.5)
    ours = T.calibrate(losses, 0.5, 12)
    assert np.array_equal(ours.grid, casc.support.grid.numpy())
    assert np.array_equal(ours.stop, casc.line_tables.stop.numpy())
    assert ours.value == pytest.approx(float(casc.line_tables.value),
                                       rel=1e-5)
    strat = strategy.make("recall_index", casc)
    test = np.clip(rng.uniform(0.0, 1.0, (300, 5)), 0.01, 1.0)
    res = strategy.evaluate(strat, torch.as_tensor(test, dtype=torch.float32))
    served = []
    for row in test:
        walk = T.RecallWalk(ours)
        for node, ell in enumerate(row):
            if not walk.observe(node, ell):
                break
        served.append(walk.serve())
    assert served == res.served_node.tolist()
    assert len(set(served)) > 1


def _program_serve(cfg, params, strategy_name, prompt, n_out, chunk=16):
    """One request through the program's paged, chunked stepper on the
    CPU; returns the first token, the emitted tokens, per token the
    logits of every node the step read out, the calibration prompts and
    the served nodes."""
    from repro_torch import strategy
    from repro_torch.launch.serve import build_strategy
    from repro_torch.serving import engine as E, runtime as rt
    from ttbench.families.dense import program_config
    pc = program_config(cfg)
    calib = np.random.default_rng(1).integers(0, cfg["vocab_size"], (32, 16))
    casc = strategy.Cascade.calibrate(params, pc, calib, 0.5, k=24,
                                      solve=False)
    strat = build_strategy(strategy_name, casc, threshold=0.4, patience=2,
                           lam=None)
    seen = []
    orig = E.fold_readout

    def fold(strategies, states, node, logits, ell, active, sid, best):
        seen.append((node, logits[0].clone()))
        return orig(strategies, states, node, logits, ell, active, sid, best)

    E.fold_readout = fold
    try:
        st = rt.EngineStepper(params, pc, (strat,), n_lanes=2,
                              cache_len=128, prompt_len=8, kv="paged",
                              page_size=16, paged_kernel=True,
                              prefill_chunk=chunk, prefill_budget=2 * chunk)
        req = rt.Request(rid=0, prompt=prompt, max_tokens=n_out)
        assert st.reserve(req)
        st.admit(0, req)
        occ, sid = np.array([True, False]), np.zeros(2, np.int32)
        first, toks, logits, nodes = None, [], [], []
        while len(toks) < n_out:
            seen.clear()
            emitted, served, _, _, emit = st.step(occ, sid)
            if not emit[0]:
                first = int(emitted[0])
                continue
            toks.append(int(emitted[0]))
            logits.append(dict(seen))
            nodes.append(int(served[0]))
    finally:
        E.fold_readout = orig
    return first, toks, logits, calib, nodes


def _sample(prompt, first, toks, logits, nodes, strategy_name, cols):
    """The comparison's entry for one request, as the harness reads the
    program's served rows back."""
    rows = torch.stack([logits[i][n] for i, n in enumerate(nodes)])
    return {"prompt": prompt, "first": first, "tokens": toks,
            "strategy": strategy_name, "rows": rows[:, cols].numpy(),
            "top": rows.max(dim=1).values.numpy(), "nodes": nodes}


@pytest.mark.parametrize("strategy_name", ["always_last", "recall_index"])
def test_served_logits_equal_the_programs_to_rounding(strategy_name):
    cfg = _small()
    m = dense(cfg)
    params = make_weights(m, 7, "cpu")
    prompt = np.random.default_rng(3).integers(0, m.vocab, 45).astype(
        np.int32)
    first, toks, logits, calib, nodes = _program_serve(
        cfg, params, strategy_name, prompt, 6)
    tables = check.tables_of(Model, m, params, calib, 0.5, 24)
    ref = Model(m, params, 16)
    x, kv = ref.prompt(torch.as_tensor(prompt), room=8)
    assert int(ref.readout(m.n_nodes - 1, x[-1]).argmax()) == first
    worst = 0.0
    for i, inp in enumerate([first] + toks[:-1]):
        served, ours, _ = ref.decode(inp, 45 + i, kv, strategy_name, tables)
        assert set(ours) == set(logits[i])          # the same walk
        for node in ours:
            worst = max(worst, float((ours[node] - logits[i][node])
                                     .abs().max()))
        assert int(ours[served].argmax()) == toks[i]
    # f32 rounding and a bf16 pool entry it may tip over: far below the
    # 1e-3 a wrong chunking or TF32 products give
    assert worst < 3e-4
    cols = np.arange(0, m.vocab, 7)
    sample = [_sample(prompt, first, toks, logits, nodes, strategy_name,
                      cols)]
    got = check.served_gap(Model, m, params, 16, tables, sample, cols)
    assert got["served_gap"] < 3e-4 and got["tokens"] == 7
    assert got["other_node"] == 0


def test_tf32_round():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 2**-10, -3.0000002,
                      1.0 + 3 * 2**-11])
    assert tf32_round(x).tolist() == [1.0, 1.0, 1.0 + 2**-10, -3.0,
                                      1.0 + 2**-9]


def test_a_lower_precision_fails_the_comparison():
    """TF32 products, or keys read at the wrong precision (every
    chunk's keys in bf16), move the served logits about tenfold more
    than the program's rounding does."""
    cfg = _small(num_hidden_layers=4)
    m = dense(cfg)
    params = make_weights(m, 11, "cpu")
    prompt = np.random.default_rng(5).integers(0, m.vocab, 40).astype(
        np.int32)
    first, toks, logits, calib, nodes = _program_serve(
        cfg, params, "always_last", prompt, 5)
    tables = check.tables_of(Model, m, params, calib, 0.5, 24)

    def worst(model):
        x, kv = model.prompt(torch.as_tensor(prompt), room=8)
        out = 0.0
        for i, inp in enumerate([first] + toks[:-1]):
            _, ours, _ = model.decode(inp, 40 + i, kv, "always_last",
                                      tables)
            out = max(out, max(float((ours[n] - logits[i][n]).abs().max())
                               for n in ours))
        return out

    exact = worst(Model(m, params, 16))
    assert worst(Model(m, params, 16, control=True)) > 10 * exact
    assert worst(Model(m, params, 1)) > 10 * exact
    # the same, read through the harness's comparison on the positions
    # the program is judged on
    cols = np.arange(0, m.vocab, 7)
    sample = [_sample(prompt, first, toks, logits, nodes, "always_last",
                      cols)]
    ours = check.served_gap(Model, m, params, 16, tables, sample, cols)
    ctl = check.served_gap(Model, m, params, 16, tables, sample, cols,
                           control=True)
    assert ctl["tokens"] == ours["tokens"] == 1 + 5
    assert ctl["served_gap"] > 10 * ours["served_gap"]
