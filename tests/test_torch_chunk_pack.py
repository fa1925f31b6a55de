"""The prefill chunk at the width of the lanes that prefill, on the CPU:
`EngineStepper._build_chunk` packs the lanes with a width into the first
rows of the narrowest lane bucket that holds them
(`serving.runtime.chunk_graph.lane_buckets`), with a lane map; the
packed pass computes what the full-width pass (every lane a row, built
here by hand) computes, on a dense and on a MoE smoke config; and with
a stand-in for the CUDA recording, `alloc` records every bucket once a
pool and each chunk step replays its own bucket.  The card's test is
test_torch_chunk_pack_card.py."""

import contextlib

import numpy as np
import pytest
import torch

from repro_torch import strategy
from repro_torch.configs import get_config
from repro_torch.kernels import build
from repro_torch.models import model as M
from repro_torch.models.attention import PrefillChunk
from repro_torch.models.param import materialize, tree_leaves
from repro_torch.serving import runtime as rt
from repro_torch.serving.obs import Observability
from repro_torch.serving.runtime import chunk_graph
from repro_torch.serving.runtime.request import Request

LANES = 8
CHUNK = 8


@pytest.mark.parametrize("n_lanes, buckets", [
    (1, (1,)), (2, (1, 2)), (3, (1, 2, 3)), (8, (1, 2, 4, 8)),
    (12, (1, 2, 4, 8, 12)), (32, (1, 2, 4, 8, 16, 32)),
    (256, (1, 2, 4, 8, 16, 32, 64, 128, 256))])
def test_lane_buckets_are_powers_of_two_then_the_lanes(n_lanes, buckets):
    assert chunk_graph.lane_buckets(n_lanes) == buckets
    for k in range(n_lanes + 1):
        b = chunk_graph.lane_bucket(k, n_lanes)
        assert b in buckets and b >= k
        assert all(c < k for c in buckets if c < b)


def _model(arch):
    torch.set_num_threads(2)
    cfg = get_config(arch, smoke=True)
    params = materialize(M.model_defs(cfg),
                         torch.Generator().manual_seed(0), "cpu")
    return cfg, params


@pytest.fixture(scope="module")
def ee_model():
    return _model("paper-ee-100m")


def _stepper(cfg, params, cache_len=128, paged_kernel=True):
    bank = (strategy.make("always_last",
                          strategy.Cascade.uniform(cfg.n_ramps + 1)),)
    return rt.EngineStepper(params, cfg, bank, n_lanes=LANES,
                            cache_len=cache_len, prompt_len=12, kv="paged",
                            page_size=8, paged_kernel=paged_kernel,
                            prefill_chunk=CHUNK,
                            prefill_budget=LANES * CHUNK)


def _admit(stepper, lanes, lengths, seed=3):
    rng = np.random.default_rng(seed)
    for rid, (lane, n) in enumerate(zip(lanes, lengths)):
        req = Request(rid=rid, prompt=rng.integers(
            0, stepper.cfg.vocab, n, dtype=np.int32), max_tokens=4)
        assert stepper.reserve(req)
        stepper.admit(lane, req)


@pytest.mark.parametrize("lanes", [(), (5,), (1, 4, 6), tuple(range(LANES))],
                         ids=["none", "one", "three", "all"])
def test_build_chunk_packs_the_prefilling_lanes(ee_model, lanes):
    """The bucket is the narrowest that holds the lanes with a width;
    they fill its first rows in the planner's order, each row mapped to
    its lane; the rows past them are idle and map to the sink lane;
    ``emit`` is in lane space; the lane map rides in the upload of
    ``start`` and ``last_idx``."""
    stepper = _stepper(*ee_model)
    lengths = [5 + 6 * i for i in range(len(lanes))]      # 5 finishes
    _admit(stepper, lanes, lengths)
    widths = stepper.planner.plan({
        lane: (st["lp"] - st["cursor"], st["lp"])
        for lane, st in stepper._prefilling.items()})
    assert sorted(widths) == sorted(lanes)
    chunk, finished = stepper._build_chunk(widths)
    b = {0: 1, 1: 1, 3: 4, LANES: LANES}[len(lanes)]
    assert chunk.tok.shape == chunk.pos.shape == (b, CHUNK)
    assert chunk.dest_page.shape == chunk.dest_slot.shape == (b, CHUNK)
    for t in (chunk.start, chunk.last_idx, chunk.active, chunk.lane):
        assert t.shape == (b,)
    assert chunk.emit.shape == (LANES,)
    rows = list(widths)
    lane = chunk.lane.tolist()
    assert lane == rows + [LANES] * (b - len(rows))
    # one upload carries start, last_idx and the lane map
    assert chunk.start.data_ptr() + b * 4 == chunk.last_idx.data_ptr()
    assert chunk.last_idx.data_ptr() + b * 4 == chunk.lane.data_ptr()
    assert chunk.active.tolist() == [True] * len(rows) + [False] * (
        b - len(rows))
    for r, ln in enumerate(rows):
        w = widths[ln]
        st = stepper._prefilling[ln]
        assert chunk.tok[r, :w].tolist() == st["prompt"][:w].tolist()
        assert chunk.pos[r].tolist() == list(range(w)) + [-1] * (CHUNK - w)
        assert chunk.dest_page[r, :w].tolist() == \
            st["plan"].dest_page[:w].tolist()
        assert chunk.start[r] == 0 and chunk.last_idx[r] == w - 1
    for r in range(len(rows), b):
        assert (chunk.pos[r] == -1).all() and not chunk.dest_page[r].any()
        assert not chunk.tok[r].any()
        assert chunk.start[r] == 0 and chunk.last_idx[r] == 0
    assert finished == [ln for ln in rows if stepper._prefilling[ln]["lp"]
                        == widths[ln]]
    assert chunk.emit.nonzero()[:, 0].tolist() == sorted(finished)
    if not lanes:
        assert stepper._build_chunk({})[0] is chunk        # built once
        assert stepper.chunk_stats["chunk_steps"] == 0
    else:
        assert stepper.chunk_stats["chunk_steps"] == 1


def _full_width(chunk, n_lanes):
    """Today's full-width chunk of the packed ``chunk``: every lane at
    its own row, idle lanes at position -1 with garbage destinations."""
    lane = chunk.lane.long()
    real = lane < n_lanes

    def spread(x, fill):
        out = torch.full((n_lanes,) + tuple(x.shape[1:]), fill,
                         dtype=x.dtype)
        out[lane[real]] = x[real]
        return out

    return PrefillChunk(
        tok=spread(chunk.tok, 0), pos=spread(chunk.pos, -1),
        dest_page=spread(chunk.dest_page, 0),
        dest_slot=spread(chunk.dest_slot, 0),
        start=spread(chunk.start, 0), last_idx=spread(chunk.last_idx, 0),
        emit=chunk.emit, active=spread(chunk.active, False),
        lane=torch.arange(n_lanes, dtype=torch.int32))


def _pool(caches):
    return [leaf.clone() for leaf in tree_leaves(caches)]


def _clone(caches):
    return [{"attn": {k: v.clone() for k, v in seg["attn"].items()}}
            for seg in caches]


@pytest.mark.parametrize("arch", ["granite-3-2b", "phi3.5-moe-42b-a6.6b"])
@pytest.mark.parametrize("kernel", [True, False], ids=["kernel", "gather"])
def test_the_packed_pass_computes_what_the_full_width_pass_does(arch,
                                                               kernel):
    """Three of eight lanes prefill, two of them past their first chunk
    (history in the pool), one finishing: the packed pass's first tokens
    at those lanes and every page of the pool but the garbage page equal
    the full-width pass's, bit for bit.  MoE routes each row's chunk as
    one group, so packing changes no expert's capacity or drops."""
    cfg, params = _model(arch)
    stepper = _stepper(cfg, params, paged_kernel=kernel)
    lanes = (6, 1, 3)
    _admit(stepper, lanes, (19, 30, 11))
    occ = np.zeros(LANES, bool)
    occ[list(lanes)] = True
    with torch.no_grad():
        stepper.step(occ, np.zeros(LANES, np.int32))   # first chunks
        widths = stepper.planner.plan({
            lane: (st["lp"] - st["cursor"], st["lp"])
            for lane, st in stepper._prefilling.items()})
        chunk, finished = stepper._build_chunk(widths)
        assert chunk.tok.shape[0] == 4 and finished == [3]
        table = torch.as_tensor(stepper.pool.table, dtype=torch.int32)
        packed, full = _clone(stepper.caches), _clone(stepper.caches)
        t_packed = stepper._step.chunk_pass(packed, table, chunk)
        t_full = stepper._step.chunk_pass(full, table,
                                          _full_width(chunk, LANES))
    assert t_packed.shape == t_full.shape == (LANES,)
    assert t_packed[list(lanes)].tolist() == t_full[list(lanes)].tolist()
    for a, b, old in zip(_pool(packed), _pool(full),
                         _pool(stepper.caches)):
        assert torch.equal(a[:, 1:], b[:, 1:])        # page 0: the sink
        assert not torch.equal(a[:, 1:], old[:, 1:])   # the chunk wrote


class _StandIn:
    """A CUDA graph's stand-in: a replay runs the recorded pass again,
    on the same input tensors, into the same output tensor."""

    def __init__(self, fn, out):
        self.fn, self.out = fn, out

    def replay(self):
        self.out.copy_(self.fn())


class _Stream:
    device = torch.device("cpu")

    def wait_stream(self, other):
        pass


@pytest.fixture
def stand_in(monkeypatch):
    """The CUDA recording and streams replaced by CPU stand-ins."""
    def record(fn, stream):
        with build.held_launches() as held:
            out = fn()
        return _StandIn(fn, out), out, held

    monkeypatch.setattr(chunk_graph, "_record", record)
    monkeypatch.setattr(torch.cuda, "Stream", lambda device=None: _Stream())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: _Stream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda stream: contextlib.nullcontext())


def _burst(cfg, n):
    """``n`` requests at time 0 whose prompts take 1, 2, ..., n chunks:
    as they finish, the lanes that prefill fall through every bucket."""
    rng = np.random.default_rng(7)
    return [Request(rid=r, prompt=rng.integers(0, cfg.vocab, CHUNK * (r + 1)
                                               - r % 3, dtype=np.int32),
                    max_tokens=2 + r % 3, arrival=0.0)
            for r in range(n)]


def _serve(stepper, requests, obs=None):
    sched = rt.LaneScheduler(stepper.n_lanes)
    with torch.no_grad():
        m = rt.Server(stepper, sched, lambda r: 0, obs=obs).serve(
            requests, warmup=False)
    return ({rid: rec.tokens for rid, rec in m.records.items()},
            _pool(stepper.caches))


def test_alloc_records_every_bucket_and_a_step_replays_its_own(ee_model,
                                                               stand_in):
    """`alloc` records the pass once a bucket, the widest first; a serve
    replays, at each chunk step, the bucket of its prefilling lanes,
    every bucket at least once, and serves what the eager pass serves;
    the probe's ``chunk_rows`` and ``chunk_rows_launched`` are the
    step's widths' sum and its bucket's rows (0 and 0 without a
    chunk)."""
    cfg, params = ee_model
    requests = _burst(cfg, LANES)
    eager = _serve(_stepper(cfg, params, cache_len=96), requests)
    stepper = _stepper(cfg, params, cache_len=96)
    stepper._chunk_graphed = True       # as a stepper on the card is
    calls = []
    inner = stepper._step.chunk_pass

    def logged(caches, table, chunk):
        calls.append(chunk.tok.shape[0])
        return inner(caches, table, chunk)

    stepper._step.chunk_pass = logged
    rows = []
    build_chunk = stepper._build_chunk

    def built(widths):
        chunk, finished = build_chunk(widths)
        if widths:
            rows.append(chunk.tok.shape[0])
        return chunk, finished

    stepper._build_chunk = built
    obs = Observability()
    graphed = _serve(stepper, requests, obs)    # alloc records first
    assert sorted(stepper._chunk_graph.buckets) == [1, 2, 4, 8]
    # one warm pass at the widest bucket, then the recording and one
    # replay a bucket, widest first, then one replay a chunk step, of its
    # own bucket
    assert calls[:9] == [8] + [b for b in (8, 4, 2, 1) for _ in range(2)]
    assert calls[9:] == rows and set(rows) == {1, 2, 4, 8}
    assert graphed[0] == eager[0]
    assert all(torch.equal(a[:, 1:], b[:, 1:])
               for a, b in zip(graphed[1], eager[1]))
    cs = stepper.chunk_stats
    assert cs["chunk_graph_captures"] == 1      # one pool, at alloc
    assert cs["chunk_graph_replays"] == cs["chunk_steps"] == len(rows)
    counters = [dict(ev.data) for ev in obs.tracer.events
                if ev.kind == "counter"]
    chunked = [d for d in counters if d["chunk_rows"]]
    assert [d["chunk_rows_launched"] for d in chunked] == [
        r * CHUNK for r in rows]
    assert sum(d["chunk_rows"] for d in counters) \
        == cs["tokens_computed"] == sum(len(r.prompt) for r in requests)
    assert all(d["chunk_rows_launched"] == 0 for d in counters
               if not d["chunk_rows"])
    assert all(0 < d["chunk_rows"] <= d["chunk_rows_launched"]
               for d in chunked)
