"""The routing tie band on the CPU: the candidate expert sets of one
routing, and a tiny MoE family (`tiny_moe.py`: d 64, 8 experts, top-2,
two MoE layers and two nodes, softmax gates not renormalised) judged
through the harness with its "program" the same reference with one
decision forced.  A rounding tie is followed; a difference beyond the
band, renormalised gates and a dropped assignment are not; the share
of followed tokens is held to its limit; the branch cap holds."""

import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from ttbench import harness
from ttbench.reference import check
from ttbench.reference.tables import calibrate
from ttbench.reference.ties import MAX_BRANCHES, Candidate, topk_candidates
from ttbench.tests.test_ttbench_harness import _cell_dir

HERE = Path(__file__).resolve().parent
TAU = 1e-5
LIMIT = 1e-4
PROMPT, N_OUT = 20, 12          # 13 judged tokens: the head's and 12 more
SEED = 2**31 + 29


def _sets(cands):
    return [(c.experts, c.margin) for c in cands]


# ---- the candidates of one routing ------------------------------------------

def test_exact_ties_go_to_the_lower_expert_id():
    z = torch.tensor([0.1, 0.5, 0.5, 0.3, 0.5])
    assert _sets(topk_candidates(z, 1, 0.0, 0)) == [((1,), 0.0)]
    assert _sets(topk_candidates(z, 2, 0.0, 8)) == [
        ((1, 2), 0.0), ((4, 2), 0.0), ((1, 4), 0.0)]


def test_swaps_within_the_band_nearest_first():
    z = torch.tensor([0.0, 1.0, 0.5, 0.49, 0.2, 0.495, -1.0])
    own, *alts = topk_candidates(z, 2, 0.02, 8)
    assert own == Candidate((1, 2), 0.0)
    assert [c.experts for c in alts] == [(1, 5), (1, 3)]
    assert [c.margin for c in alts] == pytest.approx([0.005, 0.01])
    # at most max_alt further sets, the nearest kept
    assert [c.experts for c in topk_candidates(z, 2, 0.02, 1)] == [
        (1, 2), (1, 5)]
    # beyond the band: none
    assert len(topk_candidates(z, 2, 0.004, 8)) == 1
    # every expert chosen: nothing outside to swap in
    assert len(topk_candidates(z, 7, 1.0, 8)) == 1


def test_a_swap_reaches_deeper_inside_only_within_the_band():
    z = torch.tensor([1.0, 0.9, 0.899, 0.5])
    got = topk_candidates(z, 2, 0.2, 8)
    # 0 lies 0.101 above 2: it may go; 3 lies beyond the band of both
    assert [c.experts for c in got] == [(0, 1), (0, 2), (2, 1)]


# ---- the tiny MoE family through the harness --------------------------------

def _moe_cell(tmp: Path, **check) -> harness.Cell:
    """A bench holding the tiny MoE family and a configuration of it
    whose ``check`` is ``check`` (the served gap's limit added)."""
    root = _cell_dir(tmp)
    here = root / "bench"
    shutil.copy(HERE / "tiny_moe.py", here / "families" / "tiny_moe.py")
    cfg = json.loads((here / "configs" / "tiny.json").read_text())
    cfg.update(name="tiny-moe", family="tiny_moe", num_hidden_layers=2,
               n_segments=2, hidden_size=64, num_attention_heads=4,
               num_key_value_heads=2, head_dim=16, intermediate_size=128,
               hidden_act="gelu_pytorch_tanh", n_routed_experts=8,
               num_experts_per_tok=2, check=dict(served_gap=LIMIT, **check))
    (here / "configs" / "tiny-moe.json").write_text(json.dumps(cfg))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-moe", "source": "test",
                             "file": "bench/configs/tiny-moe.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "tiny-moe", "config": "tiny-moe",
                               "traffic": "tiny-tier", "chips": 1,
                               "why": "test"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return harness.Cell(root, "tiny-moe")


BAND = {"routing_tie": TAU, "routing_tie_why": "test",
        "followed_share": 0.1}


def _forced(Base, at=None, swap=None, experts=None, drop=False,
            renorm=False):
    """The "program": the reference ``Base`` with, at ``at`` (position,
    segment, layer), experts ``swap`` traded for each other, the whole
    set ``experts`` taken, or the weaker expert dropped; with ``renorm``
    every row's gates renormalised over its set."""

    class Program(Base):
        def route(self, si, li, pos, z, tau, max_alt):
            cands = super().route(si, li, pos, z, tau, max_alt)
            if (pos, si, li) != at:
                return cands
            own = list(cands[0].experts)
            if swap is not None:
                a, b = swap
                own = [b if e == a else a if e == b else e for e in own]
            if experts is not None:
                own = list(experts)
            if drop:
                own = own[:-1]
            return [Candidate(tuple(own), 0.0)]

        def gates(self, z, sets):
            g = super().gates(z, sets)
            return g / g.sum(dim=-1, keepdim=True) if renorm else g

    return Program


def _tables(m):
    return calibrate(np.full((8, m.n_nodes), 0.9), 0.5, 4)


def _prompt(m):
    return np.random.default_rng(5).integers(0, m.vocab, PROMPT).astype(
        np.int32)


def _serve(Program, cell, params, cols):
    """The program's sample entry for one greedy ``always_last``
    request, as the harness reads the served rows back."""
    m = cell.m
    prog = Program(m, params, cell.config["serving"]["prefill_chunk"])
    prompt = _prompt(m)
    tables = _tables(m)
    with torch.no_grad():
        x, kv = prog.prompt(torch.as_tensor(prompt), room=N_OUT)
        first = int(prog.readout(m.n_nodes - 1, x[-1]).argmax())
        tok, toks, rows, nodes = first, [], [], []
        for i in range(N_OUT):
            served, logits, _ = prog.decode(tok, PROMPT + i, kv,
                                            "always_last", tables)
            tok = int(logits[served].argmax())
            toks.append(tok)
            rows.append(logits[served])
            nodes.append(served)
    rows = torch.stack(rows)
    return {"prompt": prompt, "first": first, "tokens": toks,
            "strategy": "always_last", "rows": rows[:, cols].numpy(),
            "top": rows.max(dim=1).values.numpy(), "nodes": nodes}


def _layer0_inputs(cell, params):
    """The router inputs of layer 0: the prompt's rows, and the first
    decoded token's row; and that row's router logits."""
    seen = []

    class Seen(cell.family.Model):
        def router(self, si, li, x):
            out = super().router(si, li, x)
            if si == 0:
                seen.append(out)
            return out

    m = cell.m
    model = Seen(m, params, cell.config["serving"]["prefill_chunk"])
    with torch.no_grad():
        x, kv = model.prompt(torch.as_tensor(_prompt(m)), room=1)
        first = int(model.readout(m.n_nodes - 1, x[-1]).argmax())
        model.decode(first, PROMPT, kv, "always_last", _tables(m))
    return seen[0][0], seen[1][0][0], seen[1][1][0]


def _route_first_token(cell, params, want):
    """Set layer 0's router so that the first decoded token's router
    logits read ``want``: each expert's column moved along the part of
    that token's router input that no prompt row shares, so no prompt
    row's routing (and so no token before it) moves.  Returns the
    logits as the reference then computes them."""
    prompt_rows, row, _ = _layer0_inputs(cell, params)
    q, _ = torch.linalg.qr(prompt_rows.double().T)
    u = row.double() - q @ (q.T @ row.double())
    w = params["segments"][0]["blocks"]["mlp"]["router"][0]
    now = row.double() @ w.double()
    want = torch.tensor(want, dtype=torch.float64)
    w += (u[:, None] * ((want - now) / (u @ row.double()))[None, :]).float()
    got_rows, got_row, z = _layer0_inputs(cell, params)
    assert torch.equal(got_row, row)
    return z


def _tie(margin):
    """Expert 1 on top, 3 and 5 at the top-2 boundary ``margin`` apart,
    the rest well below."""
    return [-0.2, 1.0, -0.4, 0.5, -0.1, 0.5 - margin, 0.0, -0.3]


def _judge(cell, params, sample):
    cols = harness.check_cols(cell.m.vocab, SEED)
    got = harness.judge(cell, params, _tables(cell.m), sample, cols)
    return got, harness.verdict(cell, got)


def _case(tmp_path, margin, **fault):
    """The bench with the band, the weights with the first decoded
    token's router set to ``_tie(margin)``, and the program's sample
    with ``fault`` forced."""
    cell = _moe_cell(tmp_path / "band", **BAND)
    params = cell.family.make_weights(cell.m, SEED, "cpu")
    z = _route_first_token(cell, params, _tie(margin))
    cols = harness.check_cols(cell.m.vocab, SEED)
    program = _forced(cell.family.Model, **fault)
    return cell, params, z, [_serve(program, cell, params, cols)]


def test_a_rounding_tie_is_followed(tmp_path):
    cell, params, z, sample = _case(tmp_path, 1e-7, at=(PROMPT, 0, 0),
                                    swap=(3, 5))
    assert 0.0 <= abs(float(z[3] - z[5])) <= 1e-6
    got, (correct, check) = _judge(cell, params, sample)
    assert correct is True
    assert got["served_gap"] < 1e-6
    assert (got["ties"], got["followed"], got["capped"]) == (1, 1, 0)
    assert got["tokens"] == 1 + N_OUT
    assert list(check) == ["served_gap", "judged_tokens", "followed_share"]
    assert check["followed_share"] == {"value": 1 / (1 + N_OUT),
                                       "limit": 0.1}
    # the same run judged without the band: the swap reads as a fault
    plain = _moe_cell(tmp_path / "plain")
    got, (correct, check) = _judge(plain, params, sample)
    assert correct is False and got["served_gap"] > LIMIT
    assert (got["ties"], got["followed"]) == (0, 0)
    assert "followed_share" not in check


@pytest.mark.parametrize("margin,fault", [
    (1e-2, {"at": (PROMPT, 0, 0), "swap": (3, 5)}),
    (1e-7, {"renorm": True}),
    (1e-7, {"at": (PROMPT, 0, 0), "drop": True}),
], ids=["swap_beyond_the_band", "renormalised_gates",
        "dropped_assignment"])
def test_a_real_difference_is_not_followed(tmp_path, margin, fault):
    cell, params, z, sample = _case(tmp_path, margin, **fault)
    if margin > TAU:
        assert float(z[3] - z[5]) > TAU
    got, (correct, check) = _judge(cell, params, sample)
    assert correct is False
    assert got["served_gap"] > LIMIT
    assert got["followed"] == 0


def test_the_followed_share_is_enforced(tmp_path):
    cell, params, _, sample = _case(tmp_path, 1e-7, at=(PROMPT, 0, 0),
                                    swap=(3, 5))
    strict = _moe_cell(tmp_path / "strict", **dict(BAND,
                                                    followed_share=0.05))
    got, (correct, check) = _judge(strict, params, sample)
    assert got["served_gap"] < 1e-6 and got["followed"] == 1
    assert correct is False
    assert check["followed_share"]["value"] > 0.05


def test_the_branch_cap_keeps_the_nearest_ties(tmp_path):
    # 1 and 3 chosen; the other six within the band below 3, 1e-6 apart:
    # 12 swaps, 13 sets, more than the cap
    want = [0.5 - 1e-6, 0.5 + 2.5e-6, 0.5 - 2e-6, 0.5, 0.5 - 3e-6,
            0.5 - 4e-6, 0.5 - 5e-6, 0.5 - 6e-6]
    cell = _moe_cell(tmp_path / "band", **BAND)
    m, chunk = cell.m, cell.config["serving"]["prefill_chunk"]
    params = cell.family.make_weights(m, SEED, "cpu")
    z = _route_first_token(cell, params, want)
    every = topk_candidates(z, m.top_k, TAU, 100)
    assert len(every) == 13 > MAX_BRANCHES
    seen = []

    def pick(branches):
        seen.extend(branches)
        return 0

    pick.tau, pick.max_branches = TAU, MAX_BRANCHES

    def first_token(model, **kw):
        with torch.no_grad():
            x, kv = model.prompt(torch.as_tensor(_prompt(m)), room=1)
            first = int(model.readout(m.n_nodes - 1, x[-1]).argmax())
            return model.decode(first, PROMPT, kv, "always_last",
                                _tables(m), **kw)

    ref = cell.family.Model(m, params, chunk)
    first_token(ref, pick=pick)
    assert len(seen) == MAX_BRANCHES
    assert (ref.ties, ref.followed, ref.capped) == (1, 0, 1)
    # each branch is the token through the set of the nearest ties, in
    # order: what the reference forced to that set computes
    for branch, cand in zip(seen, every):
        forced = _forced(cell.family.Model, at=(PROMPT, 0, 0),
                         experts=cand.experts)(m, params, chunk)
        served, logits, depth = first_token(forced)
        assert (branch[0], branch[2]) == (served, depth)
        for node in logits:
            assert torch.equal(branch[1][node], logits[node])


def test_the_control_fails_under_the_band(tmp_path):
    cell, params, _, sample = _case(tmp_path, 1e-7, at=(PROMPT, 0, 0),
                                    swap=(3, 5))
    cols = harness.check_cols(cell.m.vocab, SEED)
    got = harness.judge(cell, params, _tables(cell.m), sample, cols,
                        control=True)
    correct, _ = harness.verdict(cell, got)
    assert correct is False and got["served_gap"] > LIMIT
    assert got["tokens"] == 1 + N_OUT


def test_the_control_reads_every_branch_and_keeps_the_kept_depth():
    own = [torch.zeros(1)]
    calls = []

    class Control:
        def decode(self, tok, pos, kv, strategy, tables, depth=None):
            calls.append((kv is own, depth))
            kv[0] += 1
            rows = {0: torch.tensor([0.0, 1.0, 0.0]),
                    1: torch.tensor([0.0, 0.0, 1.0])}
            return 0, {n: rows[n] for n in range(depth)}, depth

    cols = torch.arange(3)
    side = check._Controlled(Control(), own, (5, 9, "recall_index", None),
                             cols)
    pick = check.Pick(TAU, side, cols)
    # the reference's own branch probes two segments and serves node 1,
    # far from the control's row there; the other stops at node 0, where
    # the control's row is its own
    branches = [(1, {0: torch.tensor([0.0, 1.0, 0.0]),
                     1: torch.tensor([5.0, 0.0, 0.0])}, 2),
                (0, {0: torch.tensor([0.0, 1.0, 0.0])}, 1)]
    assert pick(branches) == 1 and pick.gap == 0.0
    # the deepest branch's segments on a copy, then the kept one's on
    # the control's own cache
    assert calls == [(False, 2), (True, 1)]
    assert own[0].item() == 1.0
