"""The port's continuous-batching runtime (repro_torch.serving.runtime:
`Server` and the model-free `SimStepper`) against the JAX package's.

  * Mirrors of the reference's sim tests (tests/serving/test_runtime.py):
    a served workload completes and accounts, and each request's
    decisions equal the offline ``strategy.evaluate`` on its trace
    rows; admission order cannot change a stream; lane recycling beats
    static batching; EDF admits tight deadlines first.
  * Parity: the same numpy trace bank, bridged tables and requests
    through both packages' ``Server`` + ``SimStepper`` — FIFO and EDF,
    static batching on and off, stop-the-world and chunked prefill,
    cost ``lane`` and ``batch``, and requests with ``cancel_at`` /
    ``deadline`` under ``enforce_deadlines`` — give EQUAL records
    (served nodes, token count, admission, first token, finish,
    status) and an equal ``summary()``.
  * The smoke model served under EDF, with an ``eos`` token and with
    static batching: tokens and served nodes equal the reference's.
  * On the card (``cuda`` marker, skipped here): ``SimStepper`` and
    ``CascadeSimStepper`` give equal records on ``cuda`` and ``cpu``.
    That test needs no JAX: the JAX side is imported by the fixtures
    of the parity tests, so the module also loads where JAX is absent.
"""

import types

import numpy as np
import pytest
import torch

from repro_torch import strategy as tstrategy
from repro_torch.bridge import (chain_from_numpy, line_tables_from_numpy,
                                params_from_numpy, support_from_numpy,
                                to_tensor)
from repro_torch.core import traces
from repro_torch.serving import runtime as trt
from repro_torch.serving.cascade import (CascadeSimStepper, ModelBank,
                                         ModelSpec)
from repro_torch.serving.runtime.request import Request as TRequest
from repro_torch.serving.runtime.server import arrays_to
from repro_torch.serving.runtime.workload import WorkloadSpec as TSpec

N_NODES = 5
CPU = "cpu"


@pytest.fixture(scope="module")
def jx():
    """The JAX side: jax and the JAX package's modules."""
    import jax

    from repro import strategy
    from repro.configs import get_config
    from repro.models import model
    from repro.models.param import materialize
    from repro.serving import runtime
    from repro.serving.runtime.request import Request
    from repro.serving.runtime.workload import WorkloadSpec
    return types.SimpleNamespace(
        jax=jax, strategy=strategy, get_config=get_config, M=model,
        materialize=materialize, rt=runtime, Request=Request,
        WorkloadSpec=WorkloadSpec)


def _port_cascade(jax, casc):
    """The JAX cascade's support, chain, costs and line tables, bridged
    into the port."""
    return tstrategy.Cascade(
        support=support_from_numpy(jax.tree.map(np.asarray, casc.support)),
        chain=chain_from_numpy(jax.tree.map(np.asarray, casc.chain)),
        costs=to_tensor(np.asarray(casc.costs)), lam=casc.lam,
        line_tables=line_tables_from_numpy(
            jax.tree.map(np.asarray, casc.solve_line())))


def _traces():
    rng = np.random.default_rng(0)
    losses, _, flops = traces.ee_like_traces(rng, 3_000, N_NODES)
    return losses, flops


@pytest.fixture(scope="module")
def sim_cascade(jx):
    """The reference's sim cascade and its bridged copy in the port."""
    losses, flops = _traces()
    casc = jx.strategy.Cascade.from_traces(losses[:1_500], 0.4 * flops,
                                           k=12, lam=0.6)
    return casc, _port_cascade(jx.jax, casc), losses[1_500:]


def _req(cls, rid, arrival=0.0, deadline=None, max_tokens=4, prompt_len=4,
         cancel_at=None):
    return cls(rid=rid, prompt=np.zeros(prompt_len, np.int32),
               max_tokens=max_tokens, arrival=arrival, deadline=deadline,
               cancel_at=cancel_at)


def _sim_serve(rt, casc, bank, requests, *, lanes=3, static=False,
               order="fifo", slo=5.0, cost="lane", chunk=None,
               prefill_tok_time=0.0, enforce=False, **dev):
    strategies, sid_of = rt.build_bank(requests, rt.cascade_factory(casc),
                                       ("recall_index", None))
    stepper = rt.SimStepper(strategies, bank, n_lanes=lanes,
                            seg_time=0.05, overhead=0.01, cost=cost,
                            prefill_chunk=chunk, prefill_budget=chunk,
                            prefill_tok_time=prefill_tok_time, **dev)
    server = rt.Server(stepper, rt.LaneScheduler(lanes), sid_of,
                       order=order, slo=slo, static_batching=static,
                       enforce_deadlines=enforce)
    return server.serve(requests)


def _port_serve(*args, **kw):
    with torch.no_grad():
        return _sim_serve(trt, *args, device=CPU, **kw)


# --------------------------------------------------------------------------
# mirrors of the reference's sim tests
# --------------------------------------------------------------------------

def test_sim_scheduler_completes_and_accounts(sim_cascade):
    _, tcasc, bank = sim_cascade
    spec = TSpec(rate=4.0, duration=10.0, prompt_len=4, max_tokens=(2, 9),
                 seed=11)
    requests = trt.make_workload("poisson", spec)
    metrics = _port_serve(tcasc, bank, requests)
    s = metrics.summary(slo=5.0)
    assert s["completed"] == s["requests"] == len(requests)
    assert s["tokens"] == sum(r.max_tokens for r in requests)
    for key in ("throughput_tok_s", "goodput_tok_s", "slo_attainment",
                "segments_saved_batch", "segments_saved_lane"):
        assert s[key] is not None
    assert s["ttft"]["p50"] is not None
    # every request's sim decisions equal the offline evaluator on the
    # very same trace rows (lane placement cannot alter decisions)
    strat = tstrategy.make("recall_index", tcasc)
    for rec in metrics.records.values():
        rows = np.stack([bank[(rec.rid * 9973 + t) % len(bank)]
                         for t in range(rec.n_tokens)])
        ref = tstrategy.evaluate(strat, rows)
        np.testing.assert_array_equal(np.asarray(rec.tokens),
                                      ref.served_node.numpy(),
                                      err_msg=f"rid {rec.rid}")


def test_sim_admission_order_invariance(sim_cascade):
    """Same requests under shuffled arrival order -> identical streams."""
    _, tcasc, bank = sim_cascade
    base = [_req(TRequest, rid, max_tokens=3 + rid % 5) for rid in range(8)]
    m1 = _port_serve(tcasc, bank, base, lanes=2)
    staggered = [TRequest(rid=r.rid, prompt=r.prompt,
                          max_tokens=r.max_tokens,
                          arrival=float((7 - r.rid) * 0.3)) for r in base]
    m2 = _port_serve(tcasc, bank, staggered, lanes=2)
    for rid in range(8):
        assert m1.records[rid].tokens == m2.records[rid].tokens, rid


def test_sim_recycling_beats_static_batching(sim_cascade):
    _, tcasc, bank = sim_cascade
    # heterogeneous budgets, all arriving at once: static batching
    # stalls the width on every straggler
    requests = [_req(TRequest, rid, max_tokens=2 + 10 * (rid % 2))
                for rid in range(12)]
    cont = _port_serve(tcasc, bank, requests, lanes=3).summary()
    stat = _port_serve(tcasc, bank, requests, lanes=3,
                       static=True).summary()
    assert cont["tokens"] == stat["tokens"]
    assert cont["throughput_tok_s"] > stat["throughput_tok_s"]


def test_sim_edf_prefers_tight_deadlines(sim_cascade):
    _, tcasc, bank = sim_cascade
    reqs = [_req(TRequest, rid, max_tokens=4, deadline=100.0 - rid)
            for rid in range(6)]
    m = _port_serve(tcasc, bank, reqs, lanes=1, order="edf")
    admits = sorted(m.records.values(), key=lambda r: r.admitted)
    assert [r.rid for r in admits] == [5, 4, 3, 2, 1, 0]


def test_sim_row_tap_and_bank_source(sim_cascade):
    """``row_tap`` sees every emitted token's trace row and served node;
    ``bank_source`` replaces the decision arrays the next step uses."""
    _, tcasc, bank = sim_cascade
    reqs = [_req(TRequest, rid, max_tokens=3 + rid % 4) for rid in range(6)]
    strategies, sid_of = trt.build_bank(reqs, trt.cascade_factory(tcasc),
                                        ("recall_index", None))
    stepper = trt.SimStepper(strategies, bank, n_lanes=2, device=CPU)
    tapped = []
    stepper.row_tap = lambda rows, served: tapped.extend(
        zip(rows.tolist(), served.tolist()))

    class Source:          # the strategy's own arrays: same decisions
        def bank_arrays(self):
            return stepper._bank_arrays

    stepper.bank_source = Source()
    m = trt.Server(stepper, trt.LaneScheduler(2), sid_of).serve(reqs)
    served = sorted(n for rec in m.records.values() for n in rec.tokens)
    assert sorted(n for _, n in tapped) == served
    assert len(tapped) == sum(r.max_tokens for r in reqs)
    # a never-stop table in the same slot: every token probes all nodes
    tables = tcasc.line_tables
    last = dict(stepper._bank_arrays[0])
    last["tables"] = type(tables)(
        cont=tables.cont, stop=torch.zeros_like(tables.stop),
        phi=tables.phi, sigma=tables.sigma, value=tables.value)

    class Last:
        def bank_arrays(self):
            return (last,)

    stepper.bank_source = Last()
    m = trt.Server(stepper, trt.LaneScheduler(2), sid_of).serve(reqs)
    assert m.seg_policy == N_NODES * sum(r.max_tokens for r in reqs)


# --------------------------------------------------------------------------
# parity with the reference's Server + SimStepper
# --------------------------------------------------------------------------

def _records(metrics) -> dict:
    return {rid: rec.as_dict() for rid, rec in metrics.records.items()}


def _assert_same_serve(jm, tm, slo):
    assert _records(tm) == _records(jm)
    assert tm.summary(slo=slo) == jm.summary(slo=slo)
    assert (tm.steps, tm.seg_batch, tm.seg_policy, tm.lane_steps,
            tm.t_end) == (jm.steps, jm.seg_batch, jm.seg_policy,
                          jm.lane_steps, jm.t_end)


def _workload(cls_spec, rt, seed=11):
    # deadlines on every third request: EDF orders by them, the rest
    # fall back to arrival + slo
    reqs = rt.make_workload("poisson", cls_spec(
        rate=6.0, duration=6.0, prompt_len=6, max_tokens=(2, 9),
        seed=seed))
    for r in reqs:
        if r.rid % 3 == 0:
            r.deadline = r.arrival + 0.5 + 0.1 * (r.rid % 5)
    return reqs


@pytest.mark.parametrize("order", ["fifo", "edf"])
@pytest.mark.parametrize("static", [False, True], ids=["recycle", "static"])
@pytest.mark.parametrize("chunk", [None, 4], ids=["stw", "chunked"])
@pytest.mark.parametrize("cost", ["lane", "batch"])
def test_sim_serves_what_the_reference_serves(jx, sim_cascade, order,
                                              static, chunk, cost):
    jcasc, tcasc, bank = sim_cascade
    kw = dict(lanes=3, static=static, order=order, slo=1.0, cost=cost,
              chunk=chunk, prefill_tok_time=0.002)
    jm = _sim_serve(jx.rt, jcasc, bank, _workload(jx.WorkloadSpec, jx.rt),
                    **kw)
    tm = _port_serve(tcasc, bank, _workload(TSpec, trt), **kw)
    assert jm.summary()["completed"] == len(jm.records) > 10
    _assert_same_serve(jm, tm, 1.0)


@pytest.mark.parametrize("enforce", [False, True],
                         ids=["cancel_only", "deadlines"])
def test_sim_reaping_follows_the_reference(jx, sim_cascade, enforce):
    """Requests cancelled in the queue and mid-stream, and deadlines
    that expire in the queue and on a lane: the same statuses, at the
    same virtual instants, as the reference."""
    jcasc, tcasc, bank = sim_cascade

    def reqs(cls):
        out = []
        for rid in range(10):
            cancel = 0.3 + 0.2 * rid if rid % 4 == 1 else None
            deadline = 0.4 + 0.15 * rid if rid % 3 == 2 else None
            out.append(_req(cls, rid, arrival=0.05 * rid,
                            max_tokens=6 + rid % 4, deadline=deadline,
                            cancel_at=cancel))
        return out

    kw = dict(lanes=2, slo=1.0, chunk=4, prefill_tok_time=0.002,
              enforce=enforce)
    jm = _sim_serve(jx.rt, jcasc, bank, reqs(jx.Request), **kw)
    tm = _port_serve(tcasc, bank, reqs(TRequest), **kw)
    statuses = {r["status"] for r in _records(jm).values()}
    assert "cancelled" in statuses and "completed" in statuses
    assert ("timed_out" in statuses) == enforce
    _assert_same_serve(jm, tm, 1.0)


# --------------------------------------------------------------------------
# the smoke model under EDF, eos and static batching
# --------------------------------------------------------------------------

PROMPT_LEN = 12


@pytest.fixture(scope="module")
def engine_setup(jx):
    torch.set_num_threads(2)
    jax = jx.jax
    cfg = jx.get_config("paper-ee-100m", smoke=True)
    params = jx.materialize(jx.M.model_defs(cfg), jax.random.PRNGKey(0))
    casc = jx.strategy.Cascade.calibrate(params, cfg, jax.random.PRNGKey(1),
                                         lam=0.5, k=8, t=64, seq=16)
    tparams = params_from_numpy(jax.tree.map(np.asarray, params))
    return cfg, params, casc, tparams, _port_cascade(jax, casc)


def _engine_requests(cls, cfg, n=6, seed=3):
    rng = np.random.default_rng(seed)
    return [cls(rid=rid,
                prompt=rng.integers(0, cfg.vocab, PROMPT_LEN,
                                    dtype=np.int32),
                max_tokens=3 + rid % 3, arrival=0.0, deadline=10.0 - rid)
            for rid in range(n)]


def _engine_serve(rt, params, cfg, casc, requests, mode, eos=None,
                  warmup=True):
    bank, sid_of = rt.build_bank(requests, rt.cascade_factory(casc),
                                 ("recall_index", None))
    stepper = rt.EngineStepper(params, cfg, bank, n_lanes=2, cache_len=32,
                               prompt_len=PROMPT_LEN, kv="paged",
                               page_size=8, prefill_chunk=5)
    sched = rt.LaneScheduler(2)
    nodes = {r.rid: [] for r in requests}
    step = stepper.step

    def logged(occupied, sid):
        out = step(occupied, sid)
        for lane in np.flatnonzero(out[-1]):
            req = sched.lane_req[lane]
            if req is not None:       # None: the stepper's own warmup
                nodes[req.rid].append(int(out[1][lane]))
        return out

    stepper.step = logged
    server = rt.Server(stepper, sched, sid_of, order=mode["order"],
                       slo=5.0, static_batching=mode["static"], eos=eos)
    metrics = server.serve(requests, warmup=warmup)
    return metrics, nodes


class _PersistentFixed(tstrategy.FixedNodeStrategy):
    """FixedNodeStrategy that keeps its state across a request's tokens;
    only admission's `init_lane` resets it."""

    persistent = True


def test_engine_persistent_strategy_state_carries_across_tokens(
        engine_setup):
    """Mirror of the reference's test: after serving two requests
    through one recycled lane, the carried n_probed is the LAST
    request's whole stream (5 tokens x all nodes), not one token's and
    not both requests'."""
    cfg, _, _, tparams, _ = engine_setup
    n_nodes = cfg.n_ramps + 1
    a, b = _engine_requests(TRequest, cfg, n=2, seed=21)
    a.max_tokens, b.max_tokens = 3, 5
    bank = (_PersistentFixed(n_nodes, n_nodes - 1,
                             costs=np.ones(n_nodes, np.float32)),)
    stepper = trt.EngineStepper(tparams, cfg, bank, n_lanes=1, cache_len=32,
                                prompt_len=PROMPT_LEN)
    with torch.no_grad():
        trt.Server(stepper, trt.LaneScheduler(1), lambda r: 0).serve([a, b])
    assert int(stepper.states[0].n_probed[0]) == b.max_tokens * n_nodes


@pytest.mark.parametrize("mode", ["edf", "eos", "static"])
def test_engine_modes_serve_what_the_reference_serves(jx, engine_setup,
                                                      mode):
    cfg, params, casc, tparams, tcasc = engine_setup
    kw = {"order": "edf" if mode == "edf" else "fifo",
          "static": mode == "static"}
    eos = None
    if mode == "eos":
        # a token the reference emits mid-stream, so a stream ends early
        jm0, _ = _engine_serve(jx.rt, params, cfg, casc,
                               _engine_requests(jx.Request, cfg), kw)
        eos = next(rec.tokens[1] for rec in jm0.records.values()
                   if rec.n_tokens > 2)
    jm, jnodes = _engine_serve(jx.rt, params, cfg, casc,
                               _engine_requests(jx.Request, cfg), kw, eos)
    with torch.no_grad():
        tm, tnodes = _engine_serve(trt, tparams, cfg, tcasc,
                                   _engine_requests(TRequest, cfg), kw, eos)
    for rid, rec in jm.records.items():
        assert tm.records[rid].tokens == rec.tokens, f"request {rid}"
        assert tnodes[rid] == jnodes[rid], f"request {rid}"
        assert tm.records[rid].finished is not None
    if mode == "eos":
        budget = {r.rid: r.max_tokens
                  for r in _engine_requests(TRequest, cfg)}
        early = [r for r in tm.records.values()
                 if r.n_tokens < budget[r.rid]]
        assert early and all(r.tokens[-1] == eos for r in early)
    if mode == "edf":
        # every request waits at t = 0, so admission follows deadlines
        order = [r.rid for r in sorted(tm.records.values(),
                                       key=lambda r: r.admitted)]
        assert order == [5, 4, 3, 2, 1, 0]


def test_serve_without_warmup_serves_the_same_streams(jx, engine_setup):
    """``Server.serve(warmup=False)`` only allocates the stepper's lane
    state: the streams equal the warmed serve's and the reference's
    ``serve(warmup=False)``'s."""
    cfg, params, casc, tparams, tcasc = engine_setup
    kw = {"order": "fifo", "static": False}
    jm, jnodes = _engine_serve(jx.rt, params, cfg, casc,
                               _engine_requests(jx.Request, cfg), kw,
                               warmup=False)
    runs = {}
    with torch.no_grad():
        for warm in (True, False):
            runs[warm] = _engine_serve(trt, tparams, cfg, tcasc,
                                       _engine_requests(TRequest, cfg), kw,
                                       warmup=warm)
    for rid, rec in jm.records.items():
        for warm, (tm, tnodes) in runs.items():
            assert tm.records[rid].tokens == rec.tokens, (rid, warm)
            assert tnodes[rid] == jnodes[rid], (rid, warm)
    assert runs[True][0].steps == runs[False][0].steps == jm.steps


# --------------------------------------------------------------------------
# on the card: the sim steppers give the same records on cuda and cpu
# --------------------------------------------------------------------------

@pytest.mark.cuda
def test_sim_steppers_equal_on_cuda_and_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    losses, flops = _traces()
    tcasc = tstrategy.Cascade.from_traces(losses[:1_500], 0.4 * flops,
                                          k=12, lam=0.6)
    bank = losses[1_500:]
    runs = []
    for dev in ("cuda", "cpu"):
        casc = arrays_to(tcasc, dev)
        requests = trt.make_workload("poisson", TSpec(
            rate=6.0, duration=6.0, prompt_len=6, max_tokens=(2, 9),
            seed=11))
        with torch.no_grad():
            m = _sim_serve(trt, casc, bank, requests, chunk=4,
                           prefill_tok_time=0.002, device=dev)
        runs.append(_records(m))
    assert runs[0] == runs[1]
    # the two-rung cascade sim
    rng = np.random.default_rng(3)
    losses, boundaries = traces.cascade_traces(
        rng, 3_000, [(2.0, 3.0), (5.0, 8.0, 12.0)], head_overthink=0.3)
    ccasc = tstrategy.Cascade.from_traces(
        losses[:1_500], 0.1 * np.full(5, 0.4), k=10, lam=0.9,
        boundaries=boundaries)
    ccasc.solve_skip("cascade")      # one set of tables for both devices
    mbank = ModelBank([
        ModelSpec("small", 2, n_lanes=3, seg_time=0.01,
                  prefill_tok_time=0.001),
        ModelSpec("large", 3, n_lanes=2, seg_time=0.04,
                  prefill_tok_time=0.004)])
    runs = []
    for dev in ("cuda", "cpu"):
        strat = (tstrategy.make("skip_recall", arrays_to(ccasc, dev),
                                mode="cascade"),)
        requests = [TRequest(rid=r, prompt=np.zeros(8, np.int32),
                             max_tokens=3 + r % 5, arrival=r * 0.05)
                    for r in range(12)]
        stepper = CascadeSimStepper(mbank, strat, losses[1_500:],
                                    overhead=0.002, device=dev)
        with torch.no_grad():
            m = trt.Server(stepper, trt.LaneScheduler(3),
                           lambda r: 0, slo=2.0).serve(requests)
        runs.append((_records(m), stepper.cascade_stats()))
    assert runs[0] == runs[1]
    assert runs[0][1]["escalations"] > 0
