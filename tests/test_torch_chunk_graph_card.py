"""The chunk pass's CUDA graph (`serving.runtime.chunk_graph`) on the
card: a small dense config's chunked paged serve, eager and through the
graph, serves the same tokens, served nodes and served logits, bit for
bit; the launch recorders see the same launches at the same cost
(``ttbench``'s `_LaunchCost`) and ``paged_prefill.launches`` moves by
the same amount; a new pool is recorded anew, before the serve.
``cuda`` marker: skipped without a card.  It imports no JAX, so it runs
there; the CPU tests are in test_torch_chunk_graph.py."""

import numpy as np
import pytest
import torch

from repro_torch import strategy
from repro_torch.configs import get_config
from repro_torch.kernels import build, paged_attention, paged_prefill
from repro_torch.models import model as M
from repro_torch.models.param import materialize
from repro_torch.serving import engine
from repro_torch.serving import runtime as rt
from repro_torch.serving.runtime.chunk_graph import pool_key
from repro_torch.serving.runtime.request import Request

LANES = 4


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
    return [Request(rid=r, prompt=rng.integers(0, cfg.vocab, 5 + 7 * r,
                                               dtype=np.int32),
                    max_tokens=3 + r % 5, arrival=0.0)
            for r in range(9)]


def _serve(model, graphed):
    """One seeded serve: ({rid: tokens}, {rid: served nodes}, the served
    logits of every emitting lane, step by step, the `_LaunchCost`
    totals, the ``paged_prefill`` launches, the stepper)."""
    from ttbench.harness import _LaunchCost
    cfg, params, casc = model
    bank = (strategy.make("recall_index", casc),)
    stepper = rt.EngineStepper(params, cfg, bank, n_lanes=LANES,
                               cache_len=128, prompt_len=12, kv="paged",
                               page_size=8, paged_kernel=True,
                               prefill_chunk=8)
    assert stepper._chunk_graphed
    stepper._chunk_graphed = graphed
    stepper.alloc()
    sched = rt.LaneScheduler(LANES)
    nodes, logits = {}, []
    inner, fold = stepper.step, engine.fold_readout
    last = {}

    def kept(*a, **k):
        out = last["best"] = fold(*a, **k)
        return out

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
        del stepper.step
    torch.cuda.synchronize()
    tokens = {rid: rec.tokens for rid, rec in m.records.items()}
    return (tokens, nodes, logits, cost.totals(),
            paged_prefill.launches - n0, stepper)


@pytest.mark.cuda
def test_the_graph_serves_what_the_eager_pass_serves(model):
    eager = _serve(model, False)
    graphed = _serve(model, True)
    assert graphed[0] == eager[0]
    assert graphed[1] == eager[1]
    assert len(graphed[2]) == len(eager[2])
    assert all(torch.equal(a, b) for a, b in zip(graphed[2], eager[2]))
    # the same launches at the same cost, counted alike
    assert set(graphed[3]) == set(eager[3]) == {"paged_attention",
                                               "paged_prefill"}
    for name in eager[3]:
        assert graphed[3][name].shape == eager[3][name].shape, name
        np.testing.assert_array_equal(graphed[3][name], eager[3][name])
    stepper = graphed[5]
    cs = stepper.chunk_stats
    n_layers = sum(seg.n_layers for seg in stepper.cfg.segments)
    assert graphed[4] == eager[4] == cs["chunk_steps"] * n_layers > 0
    assert eager[5]._chunk_graph is None
    # alloc recorded the graph; the serve's clock ran over no recording
    assert cs["chunk_graph_captures"] == 1
    assert cs["chunk_graph_replays"] == cs["chunk_steps"]


@pytest.mark.cuda
def test_a_second_alloc_records_anew(model):
    stepper = _serve(model, True)[5]
    first = stepper._chunk_graph
    n0 = (paged_prefill.launches, paged_attention.launches)
    stepper.alloc()
    assert stepper._chunk_graph is not first
    assert stepper._chunk_graph.key == pool_key(stepper.caches)
    assert stepper.chunk_stats["chunk_graph_captures"] == 1
    # the recording launched nothing that counts
    assert (paged_prefill.launches, paged_attention.launches) == n0
