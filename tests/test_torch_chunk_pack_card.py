"""The packed prefill chunk on the card: a 32-lane chunked paged serve of
a small dense config, with a burst of admissions whose prompts take 1
to 32 chunks, so that the lanes that prefill fall through every lane
bucket (`serving.runtime.chunk_graph.lane_buckets`: 1, 2, 4, 8, 16,
32).  Through the buckets' graphs it serves what the eager packed pass
serves, bit for bit: tokens, served nodes, served logits, every pool
page but the garbage page, and the launches at the same cost
(``ttbench``'s `_LaunchCost`); every bucket replays.  ``cuda`` marker:
skipped without a card.  It imports no JAX, so it runs there; the CPU
tests are in test_torch_chunk_pack.py."""

import numpy as np
import pytest
import torch

from repro_torch import strategy
from repro_torch.configs import get_config
from repro_torch.kernels import build, paged_prefill
from repro_torch.models import model as M
from repro_torch.models.param import materialize, tree_leaves
from repro_torch.serving import engine
from repro_torch.serving import runtime as rt
from repro_torch.serving.runtime.request import Request

LANES = 32
CHUNK = 8


@pytest.fixture(scope="module")
def model():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("granite-3-2b", smoke=True)
    dev = torch.device("cuda")
    params = materialize(M.model_defs(cfg),
                         torch.Generator().manual_seed(0), dev)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (64, 16))
    casc = strategy.Cascade.calibrate(params, cfg, tokens, 0.5, k=8)
    return cfg, params, casc


def _requests(cfg):
    rng = np.random.default_rng(5)
    return [Request(rid=r, prompt=rng.integers(
                0, cfg.vocab, CHUNK * (r + 1) - r % 3, dtype=np.int32),
                    max_tokens=3 + r % 5, arrival=0.0)
            for r in range(LANES + 4)]


def _serve(model, graphed):
    """One seeded serve: ({rid: tokens}, {rid: served nodes}, the served
    logits of every emitting lane, step by step, the `_LaunchCost`
    totals, the ``paged_prefill`` launches, the pool's leaves, the rows
    of each chunk step's chunk, the stepper)."""
    from ttbench.harness import _LaunchCost
    cfg, params, casc = model
    bank = (strategy.make("recall_index", casc),)
    stepper = rt.EngineStepper(params, cfg, bank, n_lanes=LANES,
                               cache_len=CHUNK * (LANES + 5), prompt_len=12,
                               kv="paged", page_size=8, paged_kernel=True,
                               prefill_chunk=CHUNK,
                               prefill_budget=LANES * CHUNK)
    assert stepper._chunk_graphed
    stepper._chunk_graphed = graphed
    sched = rt.LaneScheduler(LANES)
    nodes, logits, rows = {}, [], []
    inner, fold = stepper.step, engine.fold_readout
    build_chunk = stepper._build_chunk
    last = {}

    def kept(*a, **k):
        out = last["best"] = fold(*a, **k)
        return out

    def built(widths):
        chunk, finished = build_chunk(widths)
        if widths:
            rows.append(chunk.tok.shape[0])
        return chunk, finished

    def logged(occupied, sid):
        out = inner(occupied, sid)
        emit = np.flatnonzero(out[-1])
        if len(emit):           # decoding lanes: the step folded
            logits.append(last["best"][2][torch.as_tensor(
                emit, device="cuda")].clone())
        for lane in emit:
            nodes.setdefault(sched.lane_req[lane].rid, []).append(
                int(out[1][lane]))
        return out

    cost = _LaunchCost()
    stepper.step = logged
    stepper._build_chunk = built
    engine.fold_readout = kept
    build.LAUNCH_RECORDERS.append(cost)
    n0 = paged_prefill.launches
    try:
        with torch.no_grad():
            m = rt.Server(stepper, sched, lambda r: 0).serve(
                _requests(cfg), warmup=False)
    finally:
        build.LAUNCH_RECORDERS.remove(cost)
        engine.fold_readout = fold
        del stepper.step, stepper._build_chunk
    torch.cuda.synchronize()
    tokens = {rid: rec.tokens for rid, rec in m.records.items()}
    pool = [leaf.clone() for leaf in tree_leaves(stepper.caches)]
    return (tokens, nodes, logits, cost.totals(),
            paged_prefill.launches - n0, pool, rows, stepper)


@pytest.mark.cuda
def test_the_bucket_graphs_serve_what_the_eager_packed_pass_serves(model):
    eager = _serve(model, False)
    graphed = _serve(model, True)
    assert graphed[0] == eager[0]
    assert graphed[1] == eager[1]
    assert len(graphed[2]) == len(eager[2])
    assert all(torch.equal(a, b) for a, b in zip(graphed[2], eager[2]))
    assert set(graphed[3]) == set(eager[3]) == {"paged_attention",
                                               "paged_prefill"}
    for name in eager[3]:
        assert graphed[3][name].shape == eager[3][name].shape, name
        np.testing.assert_array_equal(graphed[3][name], eager[3][name])
    # every page but the garbage page 0, which idle rows write in any
    # order
    assert all(torch.equal(a[:, 1:], b[:, 1:])
               for a, b in zip(graphed[5], eager[5]))
    assert graphed[6] == eager[6]
    assert set(graphed[6]) == {1, 2, 4, 8, 16, 32}
    stepper = graphed[7]
    cs = stepper.chunk_stats
    n_layers = sum(seg.n_layers for seg in stepper.cfg.segments)
    assert graphed[4] == eager[4] == cs["chunk_steps"] * n_layers > 0
    assert sorted(stepper._chunk_graph.buckets) == [1, 2, 4, 8, 16, 32]
    # alloc recorded every bucket on the pool; the serve replayed one a
    # chunk step
    assert cs["chunk_graph_captures"] == 1
    assert cs["chunk_graph_replays"] == cs["chunk_steps"] == len(graphed[6])
