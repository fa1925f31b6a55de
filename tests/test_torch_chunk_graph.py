"""The chunk pass's CUDA graph (`serving.runtime.chunk_graph`) on the
CPU: the launch bookkeeping of a recording and its replays
(`kernels.build.held_launches` / `replay_launches`), a CPU stepper that
runs the chunk pass eagerly, and the stepper's graph path with a
stand-in for the CUDA recording (the pass run again at each replay, on
the graph's own input tensors), which must serve what the eager pass
serves and record anew for a new pool.  The card's test is
test_torch_chunk_graph_card.py."""

import contextlib

import numpy as np
import pytest
import torch

from repro_torch import strategy
from repro_torch.configs import get_config
from repro_torch.kernels import build, paged_attention, paged_prefill
from repro_torch.models import model as M
from repro_torch.models.param import materialize, tree_leaves
from repro_torch.serving import runtime as rt
from repro_torch.serving.obs import Observability
from repro_torch.serving.obs.probe import StepProbe
from repro_torch.serving.runtime import chunk_graph
from repro_torch.serving.runtime.request import Request

LANES = 3


class _Recorder:
    def __init__(self):
        self.seen = []

    def kernel(self, name, inputs, outputs):
        self.seen.append((name, inputs, outputs))


def _launch(wrapper, name, q, out):
    """What a kernel's wrapper does at a launch: count it, report it."""
    wrapper.launches += 1
    build.report_launch(name, (q,), (out,))


@pytest.fixture
def recorder():
    rec = _Recorder()
    build.LAUNCH_RECORDERS.append(rec)
    yield rec
    build.LAUNCH_RECORDERS.remove(rec)


def test_held_launches_reach_no_recorder_and_each_replay_reports_them(
        recorder):
    q, out = torch.zeros(2, 3), torch.ones(2, 3)
    n0 = (paged_prefill.launches, paged_attention.launches)
    with build.held_launches() as warm:
        _launch(paged_prefill, "paged_prefill", q, out)
        with build.held_launches() as held:
            for _ in range(3):
                _launch(paged_prefill, "paged_prefill", q, out)
            _launch(paged_attention, "paged_attention", q, out)
            assert recorder not in build.LAUNCH_RECORDERS
        assert recorder.seen == []
    assert [name for name, _, _ in warm] == ["paged_prefill"]
    assert [name for name, _, _ in held] == ["paged_prefill"] * 3 + [
        "paged_attention"]
    assert (paged_prefill.launches, paged_attention.launches) == n0
    assert recorder.seen == [] and build.LAUNCH_RECORDERS[-1] is recorder
    n = 5
    for _ in range(n):
        build.replay_launches(held)
    assert [name for name, _, _ in recorder.seen] == [
        name for name, _, _ in held] * n
    assert all(ins[0] is q and outs[0] is out
               for _, ins, outs in recorder.seen)
    assert paged_prefill.launches - n0[0] == 3 * n
    assert paged_attention.launches - n0[1] == n


def test_held_launches_restore_the_counters_when_the_block_raises(recorder):
    n0 = paged_prefill.launches
    with pytest.raises(RuntimeError, match="capture"):
        with build.held_launches():
            _launch(paged_prefill, "paged_prefill", torch.zeros(1),
                    torch.zeros(1))
            raise RuntimeError("capture failed")
    assert paged_prefill.launches == n0 and recorder.seen == []
    assert build.LAUNCH_RECORDERS[-1] is recorder


@pytest.fixture(scope="module")
def model():
    torch.set_num_threads(2)
    cfg = get_config("paper-ee-100m", smoke=True)
    params = materialize(M.model_defs(cfg),
                         torch.Generator().manual_seed(0), "cpu")
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (64, 16))
    casc = strategy.Cascade.calibrate(params, cfg, tokens, 0.5, k=8)
    return cfg, params, casc


def _stepper(model):
    cfg, params, casc = model
    bank = (strategy.make("recall_index", casc),)
    return rt.EngineStepper(params, cfg, bank, n_lanes=LANES, cache_len=64,
                            prompt_len=12, kv="paged", page_size=8,
                            paged_kernel=True, prefill_chunk=8)


def _requests(cfg):
    rng = np.random.default_rng(5)
    return [Request(rid=r, prompt=rng.integers(0, cfg.vocab, 9 + 3 * r,
                                               dtype=np.int32),
                    max_tokens=3 + r % 4, arrival=0.0)
            for r in range(6)]


def _serve(stepper, obs=None):
    """Serve the six requests (warm-up first); returns ({rid: tokens},
    {rid: served nodes}, the pool's leaves after the serve)."""
    sched = rt.LaneScheduler(LANES)
    nodes = {}
    inner = stepper.step

    def logged(occupied, sid):
        out = inner(occupied, sid)
        for lane in np.flatnonzero(out[-1]):
            req = sched.lane_req[lane]
            if req is not None:
                nodes.setdefault(req.rid, []).append(int(out[1][lane]))
        return out

    stepper.step = logged
    try:
        with torch.no_grad():
            m = rt.Server(stepper, sched, lambda r: 0, obs=obs).serve(
                _requests(stepper.cfg))
    finally:
        del stepper.step
    tokens = {rid: rec.tokens for rid, rec in m.records.items()}
    pool = [leaf.clone() for leaf in tree_leaves(stepper.caches)]
    return tokens, nodes, pool


def test_a_cpu_stepper_runs_the_chunk_pass_eagerly(model, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a CPU stepper recorded a chunk graph")

    monkeypatch.setattr(chunk_graph, "_record", refuse)
    stepper = _stepper(model)
    obs = Observability()
    _serve(stepper, obs)
    assert not stepper._chunk_graphed and stepper._chunk_graph is None
    assert set(stepper.chunk_stats) == {"tokens_computed", "tokens_skipped",
                                        "chunk_steps", "prefills"}
    assert stepper.chunk_stats["chunk_steps"] > 0
    counters = [dict(ev.data) for ev in obs.tracer.events
                if ev.kind == "counter"]
    assert counters and not any("chunk_graph_replays" in d
                                for d in counters)


class _StandIn:
    """A CUDA graph's stand-in: a replay runs the recorded pass again,
    on the same input tensors, into the same output tensor."""

    def __init__(self, fn, out):
        self.fn, self.out = fn, out

    def replay(self):
        self.out.copy_(self.fn())


FAKE_LAUNCH = ("paged_prefill", (torch.zeros(1),), (torch.zeros(1),))


class _Stream:
    device = torch.device("cpu")

    def wait_stream(self, other):
        pass


@pytest.fixture
def recordings(monkeypatch):
    """The CUDA recording and streams replaced by CPU stand-ins; yields
    the list of the recorded passes."""
    made = []

    def record(fn, stream):
        with build.held_launches():
            fn()                                    # the warm pass
            with build.held_launches() as held:
                out = fn()
                build.report_launch(*FAKE_LAUNCH)   # one launch, held
                paged_prefill.launches += 1
        made.append(fn)
        return _StandIn(fn, out), out, held

    monkeypatch.setattr(chunk_graph, "_record", record)
    monkeypatch.setattr(torch.cuda, "Stream", lambda device=None: _Stream())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: _Stream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda stream: contextlib.nullcontext())
    return made


def test_the_graph_path_serves_what_the_eager_pass_serves(model, recorder,
                                                          recordings):
    eager = _serve(_stepper(model))
    stepper = _stepper(model)
    stepper._chunk_graphed = True       # as a stepper on the card is
    stepper.alloc()
    n0 = paged_prefill.launches
    obs = Observability()
    graphed = _serve(stepper, obs)
    assert graphed[0] == eager[0] and graphed[1] == eager[1]
    assert all(torch.equal(a, b) for a, b in zip(graphed[2], eager[2]))
    cs = stepper.chunk_stats
    assert cs["chunk_steps"] > 0
    # alloc recorded before the serve's clock; every chunk step replayed
    assert cs["chunk_graph_captures"] == 1
    assert cs["chunk_graph_replays"] == cs["chunk_steps"]
    counters = [dict(ev.data) for ev in obs.tracer.events
                if ev.kind == "counter"]
    assert all("chunk_graph_replays" in d for d in counters)
    assert sum(d["chunk_graph_replays"] for d in counters) \
        == cs["chunk_steps"]
    assert sum(d["chunk_graph_captures"] for d in counters) == 0
    assert obs.probe.totals["chunk_graph_replays"] == cs["chunk_steps"]
    # the held launch was reported and counted once a replay, over the
    # warm-up's replays and the serve's
    assert len(recorder.seen) == paged_prefill.launches - n0 > 0
    assert len(recorder.seen) >= cs["chunk_graph_replays"]


def test_a_new_pool_is_recorded_anew(model, recordings):
    stepper = _stepper(model)
    stepper._chunk_graphed = True
    stepper.alloc()
    first = stepper._chunk_graph
    assert first is not None and len(recordings) == 1
    assert first.key == chunk_graph.pool_key(stepper.caches)
    # the recording ran on the idle chunk: nothing but the garbage page
    # 0 was written
    for seg in stepper.caches:
        assert (seg["attn"]["pos"][:, 1:] == -1).all()
        assert not seg["attn"]["k"][:, 1:].any()
    stepper.alloc()                               # a new pool
    assert stepper._chunk_graph is not first and len(recordings) == 2
    assert stepper.chunk_stats["chunk_graph_captures"] == 1
    # a pool put in place without alloc is recorded at the next chunk
    # step, and the probe's turn counts that recording
    stepper.caches = [{"attn": {k: v.clone() for k, v in seg["attn"].items()}}
                      for seg in stepper.caches]
    req = _requests(stepper.cfg)[1]
    assert stepper.reserve(req)
    stepper.admit(0, req)
    occ = np.zeros(LANES, bool)
    occ[0] = True
    probe = stepper.probe = StepProbe()
    probe.begin_turn()
    with torch.no_grad():
        stepper.step(occ, np.zeros(LANES, np.int32))
        turn = probe.end_turn()
        stepper.step(occ, np.zeros(LANES, np.int32))   # the same pool
    stepper.probe = None
    assert len(recordings) == 3
    assert (turn["chunk_graph_captures"], turn["chunk_graph_replays"]) \
        == (1, 1)
    assert stepper.chunk_stats["chunk_graph_captures"] == 2
    assert stepper.chunk_stats["chunk_graph_replays"] == 2
    assert stepper._chunk_graph.key == chunk_graph.pool_key(stepper.caches)
