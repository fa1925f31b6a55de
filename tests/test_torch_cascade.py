"""The port's multi-model cascade (repro_torch.serving.cascade) against
the JAX package's (repro.serving.cascade).

  * Mirrors of tests/serving/test_cascade.py (all but the benchmark
    acceptance gate): cross-model edge costs and the multi-model
    calibration, the router's recall / commit lifecycles, the
    escalation scheduler's FIFO lanes, the cascade sim (completion,
    decision parity with ``strategy.evaluate``, determinism, TTFT at
    emission, commit, re-pin credit) and the engine cascade on two real
    smoke models (run-to-run identity, no escalation == single model,
    de-escalation with a prefix re-pin, the wedge guard, commit).
  * The two engine mirrors the reference fails in this environment
    (de-escalation + re-pin, wedge) run on weights drawn with numpy and
    handed to both packages through `repro_torch.bridge`; each first
    asserts its own precondition (at least two escalations; a catch-up
    the pool cannot fit), and runs the reference on the same inputs.
    On the reference fixture's ``jax.random`` weights the small head's
    loss stays in one 1/997-wide bin (floor(997 loss) = 990, even) on
    every token of the request, so the alternating strategy never
    escalates and neither path is reached.
  * Parity: the cascade sim's records and ``cascade_stats()`` EQUAL the
    reference's on the same traces and bridged skip tables; the engine
    cascade on the same numpy weights, under ``recall`` and
    ``commit``, equal in per-request tokens, served nodes and
    ``cascade_stats()``.
  * The token step's ``walk_io`` / ``resume_walk`` outputs (a rung-1
    step resuming walks folded on rung 0) within f32 tolerance of the
    reference's on the same caches, states and handoff.
  * The launcher's ``--cascade`` path runs end to end on the CPU.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import strategy as jstrategy
from repro.configs.common import dense_decoder as jdense
from repro.core import traces as jtraces
from repro.models import model as JM
from repro.models.param import ParamDef
from repro.serving import cascade as jcascade
from repro.serving import runtime as jrt
from repro.serving.engine import make_token_step as jmake_step
from repro.serving.kvpool import PoolExhausted as JPoolExhausted
from repro.serving.runtime.request import Request as JRequest
from repro_torch import strategy as tstrategy
from repro_torch.bridge import (chain_from_numpy, line_tables_from_numpy,
                                params_from_numpy, skip_tables_from_numpy,
                                support_from_numpy, to_tensor)
from repro_torch.configs.common import dense_decoder as tdense
from repro_torch.core import traces
from repro_torch.core.skip_dp import (edge_costs_cascade,
                                      edge_costs_cumulative)
from repro_torch.launch import serve as tserve
from repro_torch.serving import runtime as trt
from repro_torch.serving.cascade import (CascadeEngineStepper,
                                         CascadeRouter, CascadeSimStepper,
                                         EscalationScheduler, ModelBank,
                                         ModelSpec)
from repro_torch.serving.engine import make_token_step as tmake_step
from repro_torch.serving.kvpool import PoolExhausted
from repro_torch.serving.runtime.request import Request
from repro_torch.serving.runtime.scheduler import EngineStepper

CPU = "cpu"
F32 = dict(atol=1e-5, rtol=1e-5)


# --------------------------------------------------------------------------
# strategy layer: cross-model edge costs + multi-model calibration
# --------------------------------------------------------------------------

def test_edge_costs_cascade_semantics():
    costs = np.array([1.0, 2.0, 3.0, 4.0, 5.0])
    # one model == plain cumulative
    np.testing.assert_allclose(edge_costs_cascade(costs, (5,)),
                               edge_costs_cumulative(costs))
    c = edge_costs_cascade(costs, (2, 3), entry_costs=(0.0, 10.0))
    assert c[1, 2] == 2.0                 # within model 0: cumulative
    assert c[3, 4] == 4.0 and c[3, 5] == 9.0   # within model 1
    # crossing into model 1 pays its ladder through the target node
    # plus the entry charge — never the source's tail
    for row in (0, 1, 2):
        assert c[row, 3] == 3.0 + 10.0
        assert c[row, 5] == 12.0 + 10.0
    with pytest.raises(ValueError, match="boundaries"):
        edge_costs_cascade(costs, (2, 2))


def test_multi_model_cascade_calibration_and_solve():
    rng = np.random.default_rng(0)
    losses, boundaries = traces.cascade_traces(
        rng, 1_500, [(2.0, 3.0), (6.0, 9.0, 12.0)], head_overthink=0.3)
    assert boundaries == (2, 3)
    casc = tstrategy.Cascade.from_model_traces(
        [losses[:, :2], losses[:, 2:]],
        [np.full(2, 0.2), np.full(3, 0.6)], k=8, lam=0.8, solve=False)
    assert casc.boundaries == (2, 3) and casc.n_models == 2
    assert [casc.node_model(i) for i in range(5)] == [0, 0, 1, 1, 1]
    strat = tstrategy.make("skip_recall", casc, mode="cascade")
    res = tstrategy.evaluate(strat, losses[:200])
    assert res.served_node.shape == (200,)
    with pytest.raises(ValueError, match="boundaries"):
        tstrategy.Cascade.uniform(5).solve_skip("cascade")


# --------------------------------------------------------------------------
# router + escalation scheduler (pure host logic)
# --------------------------------------------------------------------------

def _bank(n_lanes_small=2, n_lanes_large=2):
    return ModelBank([
        ModelSpec("s", 2, n_lanes=n_lanes_small, seg_time=0.01),
        ModelSpec("l", 3, n_lanes=n_lanes_large, seg_time=0.04,
                  prefill_tok_time=0.01),
    ])


def test_bank_offsets_and_validation():
    bank = _bank()
    assert bank.n_total == 5
    assert bank.offset(1) == 2 and bank.node_range(1) == (2, 5)
    assert [bank.model_of(i) for i in range(5)] == [0, 0, 1, 1, 1]
    with pytest.raises(ValueError, match="duplicate"):
        ModelBank([ModelSpec("x", 2), ModelSpec("x", 3)])


def test_router_recall_lifecycle_and_repin_credit():
    bank = _bank()
    router = CascadeRouter(bank, 2, policy="recall", patience=2)
    router.admit(0, prompt_len=8)
    assert router.resident(0) == [0] and router.floor(0) == 0
    # escalation: catch-up must cover prompt + emitted positions
    assert router.escalation_targets(0, [0, 1]) == [1]
    assert router.catchup_need(0, 1, 8) == 8
    router.begin_escalation(0, [1], {"k": "handoff"})
    assert router.pending_handoff(0) == {"k": "handoff"}
    assert router.finish_escalation(0, 8) == []      # recall: no drops
    assert router.resident(0) == [0, 1]
    # two tokens ignoring the large rung -> patience de-escalates it
    assert router.note_emit(0, [0, 1], served_node=1, prompt_len=8) == []
    assert router.note_emit(0, [0], served_node=0, prompt_len=8) == []
    assert router.note_emit(0, [0], served_node=0, prompt_len=8) == [1]
    assert router.resident(0) == [0]
    # the released rung retains its REGISTERED chain: a re-escalation
    # catches up only the delta past it (re-pin, not recompute)
    assert router.catchup_need(0, 1, 8) == (8 + 3) - 8
    assert router.release(0) == [0]


def test_router_commit_policy_pins_floor_and_drops_source():
    bank = _bank()
    router = CascadeRouter(bank, 1, policy="commit", patience=4)
    router.admit(0, prompt_len=4)
    router.begin_escalation(0, [1], None)
    assert router.finish_escalation(0, 4) == [0]     # source dropped
    assert router.resident(0) == [1]
    assert router.floor(0) == bank.offset(1)
    for _ in range(6):                               # never de-escalates
        assert router.note_emit(0, [1], served_node=3, prompt_len=4) == []


def test_escalation_scheduler_fifo_and_release():
    bank = _bank(n_lanes_large=1)
    esc = EscalationScheduler(bank, chunk=8)
    lane = esc.request(0, 1)
    assert lane == 0 and esc.lane_of(0, 1) == 0 and esc.slot_of(1, 0) == 0
    assert esc.request(1, 1) is None          # pool exhausted: queued
    assert esc.request(2, 1) is None
    assert esc.grants() == []                 # nothing freed yet
    esc.release(0, 1)
    assert esc.grants() == [(1, 1, 0)]        # FIFO order
    esc.release(1, 1)
    esc.cancel(2)                             # slot 2 finished waiting
    assert esc.grants() == []
    assert esc.peak_in_use[1] == 1
    with pytest.raises(ValueError, match="no escalation pool"):
        esc.request(0, 0)


# --------------------------------------------------------------------------
# simulation stepper
# --------------------------------------------------------------------------

N0, N1 = 2, 3


@pytest.fixture(scope="module")
def sim_setup():
    rng = np.random.default_rng(3)
    losses, boundaries = traces.cascade_traces(
        rng, 3_000, [(2.0, 3.0), (5.0, 8.0, 12.0)], head_overthink=0.3)
    costs = np.concatenate([np.full(N0, 0.5 / N0), np.full(N1, 2.0 / N1)])
    casc = tstrategy.Cascade.from_traces(losses[:1_500], 0.1 * costs,
                                         k=10, lam=0.9,
                                         boundaries=boundaries)
    specs = [dict(name="small", n_nodes=N0, n_lanes=3, seg_time=0.01,
                  prefill_tok_time=0.001),
             dict(name="large", n_nodes=N1, n_lanes=2, seg_time=0.04,
                  prefill_tok_time=0.004)]
    bank = ModelBank([ModelSpec(**s) for s in specs])
    return casc, bank, losses[1_500:], costs, specs


def _sim_requests(n, seed=5, arrival_gap=0.05, cls=Request):
    rng = np.random.default_rng(seed)
    return [cls(rid=r, prompt=rng.integers(0, 512, 8, np.int32),
                max_tokens=3 + r % 5, arrival=r * arrival_gap,
                strategy="skip_recall")
            for r in range(n)]


def _sim_serve(casc, bank, bank_traces, requests, *, policy="recall",
               patience=3):
    def mk(name, lam):
        return tstrategy.make("skip_recall", casc, mode="cascade")

    strat_bank, sid_of = trt.build_bank(requests, mk, ("skip_recall", None))
    stepper = CascadeSimStepper(bank, strat_bank, bank_traces,
                                overhead=0.002, policy=policy,
                                patience=patience, chunk=16, device=CPU)
    server = trt.Server(stepper, trt.LaneScheduler(bank[0].n_lanes),
                        sid_of, slo=2.0)
    with torch.no_grad():
        return server.serve(requests), stepper


def _served_rows(bank_traces, rec):
    return np.stack([bank_traces[(rec.rid * 9973 + t) % len(bank_traces)]
                     for t in range(rec.n_tokens)])


def test_sim_cascade_completes_and_accounts(sim_setup):
    casc, bank, bank_traces, _, _ = sim_setup
    requests = _sim_requests(12)
    metrics, stepper = _sim_serve(casc, bank, bank_traces, requests)
    s = metrics.summary(slo=2.0)
    assert s["completed"] == len(requests)
    assert s["tokens"] == sum(r.max_tokens for r in requests)
    cs = stepper.cascade_stats()
    # every emitted token is attributed to exactly one serving model
    assert sum(cs["tokens_served"]) == s["tokens"]
    assert cs["escalations"] > 0          # the ladder was exercised
    assert cs["mean_served_loss"] is not None


def test_sim_cascade_decision_parity_with_evaluate(sim_setup):
    """Escalated (dual-model) lanes decide exactly what the offline fold
    decides on the same combined rows: escalation timing, lane waits
    and catch-up change WHEN a token is served, never WHAT."""
    casc, bank, bank_traces, _, _ = sim_setup
    metrics, stepper = _sim_serve(casc, bank, bank_traces,
                                  _sim_requests(10))
    assert stepper.stats.escalations > 0, "gate needs escalated lanes"
    strat = tstrategy.make("skip_recall", casc, mode="cascade")
    for rec in metrics.records.values():
        ref = tstrategy.evaluate(strat, _served_rows(bank_traces, rec))
        np.testing.assert_array_equal(np.asarray(rec.tokens),
                                      ref.served_node.numpy(),
                                      err_msg=f"rid {rec.rid}")
    assert stepper.stats.tokens_served[1] > 0


def test_sim_cascade_deterministic_and_order_invariant(sim_setup):
    casc, bank, bank_traces, _, _ = sim_setup
    base = _sim_requests(8)
    m1, _ = _sim_serve(casc, bank, bank_traces, base)
    m2, _ = _sim_serve(casc, bank, bank_traces, base)
    for r in base:
        assert m1.records[r.rid].tokens == m2.records[r.rid].tokens
    # reversed arrivals: decisions (rid, t)-keyed -> identical streams
    rev = [Request(rid=r.rid, prompt=r.prompt, max_tokens=r.max_tokens,
                   arrival=(len(base) - 1 - r.rid) * 0.05,
                   strategy=r.strategy) for r in base]
    m3, _ = _sim_serve(casc, bank, bank_traces, rev)
    for r in base:
        assert m1.records[r.rid].tokens == m3.records[r.rid].tokens


def test_sim_ttft_counted_at_actual_emission(sim_setup):
    """A first token that must escalate emits ONLY after the catch-up
    lands (the lane is occupied-but-silent), so its TTFT includes the
    escalation latency."""
    casc, bank, bank_traces, _, _ = sim_setup
    metrics, stepper = _sim_serve(casc, bank, bank_traces,
                                  _sim_requests(10))
    assert stepper.stats.escalations > 0
    for rec in metrics.records.values():
        assert rec.first_token is not None
        assert rec.first_token >= rec.admitted
        assert rec.finished >= rec.first_token


def test_sim_commit_policy_commits_and_rejects_jumping_strategies(
        sim_setup):
    casc, bank, bank_traces, _, _ = sim_setup
    requests = _sim_requests(8)

    def mk(name, lam):
        return tstrategy.make("norecall_threshold", casc, threshold=0.2,
                              lam=1.0)

    strat_bank, sid_of = trt.build_bank(requests, mk, ("nr", None))
    stepper = CascadeSimStepper(bank, strat_bank, bank_traces,
                                overhead=0.002, policy="commit",
                                patience=3, chunk=16, device=CPU)
    with torch.no_grad():
        m = trt.Server(stepper, trt.LaneScheduler(3), sid_of,
                       slo=2.0).serve(requests)
    assert m.summary()["completed"] == len(requests)
    assert stepper.stats.commits > 0
    assert stepper.stats.deescalations == 0   # commits never retreat
    skip = tstrategy.make("skip_recall", casc, mode="cascade")
    with pytest.raises(ValueError, match="NEXT table"):
        CascadeSimStepper(bank, (skip,), bank_traces, policy="commit",
                          device=CPU)


def test_sim_repin_credit_on_reescalation(sim_setup):
    """De-escalated rungs retain their registered catch-up chain: a
    re-escalation skips the retained positions (repin_tokens counts
    them).  A mid-range threshold on the small head makes escalation
    flip per token."""
    _, bank, bank_traces, _, _ = sim_setup
    strat = (tstrategy.ThresholdStrategy(
        5, np.asarray([0.0, 0.45, 0.0, 0.0, 2.0], np.float32),
        recall=True, lam=1.0),)
    requests = [Request(rid=r, prompt=np.zeros(8, np.int32),
                        max_tokens=12, arrival=r * 0.05) for r in range(6)]
    stepper = CascadeSimStepper(bank, strat, bank_traces, overhead=0.002,
                                policy="recall", patience=2, chunk=16,
                                device=CPU)
    with torch.no_grad():
        m = trt.Server(stepper, trt.LaneScheduler(3), lambda r: 0,
                       slo=5.0).serve(requests)
    assert m.summary()["completed"] == len(requests)
    cs = stepper.cascade_stats()
    assert cs["deescalations"] > 0
    assert cs["repin_tokens"] > 0


@pytest.mark.parametrize("case", ["skip_recall", "threshold", "commit"])
def test_sim_cascade_serves_what_the_reference_serves(sim_setup, case):
    """The same traces, requests and (bridged) tables through both
    packages' cascade sims: records, summaries and cascade_stats()
    equal.  ``skip_recall`` and a threshold that flips escalation per
    token (de-escalations, re-pins) run the recall policy;
    ``commit`` (which refuses a jumping strategy) runs recall_index."""
    _, _, bank_traces, costs, specs = sim_setup
    rng = np.random.default_rng(3)
    losses, boundaries = jtraces.cascade_traces(
        rng, 3_000, [(2.0, 3.0), (5.0, 8.0, 12.0)], head_overthink=0.3)
    np.testing.assert_array_equal(losses[1_500:], bank_traces)
    jcasc = jstrategy.Cascade.from_traces(losses[:1_500], 0.1 * costs,
                                          k=10, lam=0.9,
                                          boundaries=boundaries)
    tcasc = tstrategy.Cascade(
        support=support_from_numpy(jax.tree.map(np.asarray, jcasc.support)),
        chain=chain_from_numpy(jax.tree.map(np.asarray, jcasc.chain)),
        costs=to_tensor(np.asarray(jcasc.costs)), lam=jcasc.lam,
        boundaries=jcasc.boundaries)
    policy = "commit" if case == "commit" else "recall"
    if case == "skip_recall":
        tcasc.skip_tables = skip_tables_from_numpy(
            jax.tree.map(np.asarray, jcasc.solve_skip("cascade")))
        tcasc.edge_costs = np.asarray(jcasc.edge_costs)
        tcasc.skip_mode = "cascade"
    elif case == "commit":
        tcasc.line_tables = line_tables_from_numpy(
            jax.tree.map(np.asarray, jcasc.solve_line()))

    def strat(mod, casc):
        if case == "skip_recall":
            return mod.make("skip_recall", casc, mode="cascade")
        if case == "commit":
            return mod.make("recall_index", casc)
        return mod.ThresholdStrategy(
            5, np.asarray([0.0, 0.45, 0.0, 0.0, 2.0], np.float32),
            recall=True, lam=1.0)

    runs = []
    for pkg in ("jax", "torch"):
        if pkg == "jax":
            bank = jcascade.ModelBank([jcascade.ModelSpec(**s)
                                       for s in specs])
            stepper = jcascade.CascadeSimStepper(
                bank, (strat(jstrategy, jcasc),), bank_traces,
                overhead=0.002, policy=policy, patience=2, chunk=4)
            rt, cls = jrt, JRequest
        else:
            bank = ModelBank([ModelSpec(**s) for s in specs])
            stepper = CascadeSimStepper(
                bank, (strat(tstrategy, tcasc),), bank_traces,
                overhead=0.002, policy=policy, patience=2, chunk=4,
                device=CPU)
            rt, cls = trt, Request
        requests = _sim_requests(14, cls=cls, arrival_gap=0.02)
        with torch.no_grad():
            m = rt.Server(stepper, rt.LaneScheduler(3), lambda r: 0,
                          slo=1.0).serve(requests)
        runs.append(({rid: r.as_dict() for rid, r in m.records.items()},
                     m.summary(slo=1.0), stepper.cascade_stats()))
    (jrec, jsum, jcs), (trec, tsum, tcs) = runs
    assert jcs["escalations"] > 0
    if case == "threshold":
        assert jcs["deescalations"] > 0 and jcs["repin_tokens"] > 0
    if case == "commit":
        assert jcs["commits"] > 0
    assert trec == jrec
    assert tsum == jsum
    assert tcs == jcs


# --------------------------------------------------------------------------
# real-engine cascade (smoke models, numpy weights in both packages)
# --------------------------------------------------------------------------

PROMPT_LEN = 10
VOCAB = 256
CFG_S = dict(n_layers=2, d_model=64, n_heads=2, n_kv_heads=2, head_dim=32,
             d_ff=128, vocab=VOCAB, n_segments=2, act="gelu")
CFG_L = dict(n_layers=3, d_model=96, n_heads=2, n_kv_heads=2, head_dim=48,
             d_ff=192, vocab=VOCAB, n_segments=3, act="gelu")
# numpy seeds of the two rungs' weights: on these the alternating
# strategy below escalates 5 times in the 14-token stream of prompt
# seed 2 (the reference fixture's prompt seed)
WEIGHT_SEEDS = (0, 1)


def _numpy_params(cfg, seed):
    """Weights drawn with numpy in the reference's init recipe (fan-in
    scaled normals, ones, zeros), leaf by leaf in tree order."""
    rng = np.random.default_rng(seed)

    def leaf(d):
        if d.init == "zeros":
            return np.zeros(d.shape, np.float32)
        if d.init == "ones":
            return np.ones(d.shape, np.float32)
        std = d.scale
        if d.init == "fan_in":
            std /= math.sqrt(max(d.shape[d.fan_axis] if d.shape else 1, 1))
        return (std * rng.standard_normal(d.shape)).astype(np.float32)

    return jax.tree.map(leaf, JM.model_defs(cfg),
                        is_leaf=lambda x: isinstance(x, ParamDef))


@pytest.fixture(scope="module")
def engine_banks():
    """The same two-rung ladder in both packages: (reference bank, port
    bank)."""
    torch.set_num_threads(2)
    out = []
    for pkg in ("jax", "torch"):
        rungs = []
        for name, kw, seed, lanes in (("casc-s", CFG_S, WEIGHT_SEEDS[0], 2),
                                      ("casc-l", CFG_L, WEIGHT_SEEDS[1], 1)):
            np_params = _numpy_params(jdense(name, **kw), seed)
            if pkg == "jax":
                rungs.append(jcascade.ModelSpec(
                    name, kw["n_segments"], n_lanes=lanes,
                    cfg=jdense(name, **kw),
                    params=jax.tree.map(jnp.asarray, np_params)))
            else:
                rungs.append(ModelSpec(
                    name, kw["n_segments"], n_lanes=lanes,
                    cfg=tdense(name, **kw),
                    params=params_from_numpy(np_params)))
        out.append((jcascade.ModelBank if pkg == "jax" else ModelBank)(
            rungs))
    return tuple(out)


def _engine_requests(n, seed=5, cls=Request, arrival_gap=0.01):
    rng = np.random.default_rng(seed)
    return [cls(rid=r, prompt=rng.integers(0, VOCAB, PROMPT_LEN, np.int32),
                max_tokens=2 + r % 3, arrival=r * arrival_gap)
            for r in range(n)]


def _one_request(cls=Request):
    rng = np.random.default_rng(2)
    return [cls(rid=0, prompt=rng.integers(0, VOCAB, PROMPT_LEN, np.int32),
                max_tokens=14)]


def _engine_serve(bank, strat_bank, sid_of, requests, *, policy="recall",
                  patience=2, stepper=None, pages=None, pkg="torch"):
    """Serve through one package's cascade engine; also log, per request,
    the node that served each token."""
    rt = trt if pkg == "torch" else jrt
    if stepper is None:
        cls = (CascadeEngineStepper if pkg == "torch"
               else jcascade.CascadeEngineStepper)
        stepper = cls(bank, strat_bank, cache_len=32,
                      prompt_len=PROMPT_LEN, page_size=8, chunk=4,
                      policy=policy, patience=patience, pages=pages)
    sched = rt.LaneScheduler(bank[0].n_lanes)
    nodes = {r.rid: [] for r in requests}
    step = stepper.step

    def logged(occupied, sid):
        out = step(occupied, sid)
        for lane in np.flatnonzero(out[-1]):
            req = sched.lane_req[lane]
            if req is not None:
                nodes[req.rid].append(int(out[1][lane]))
        return out

    stepper.step = logged
    with torch.no_grad():
        metrics = rt.Server(stepper, sched, sid_of, slo=10.0).serve(requests)
    stepper.step = step
    stepper.served_nodes = nodes
    return metrics, stepper


def _threshold_bank(mod, thresholds, recall=True):
    """One threshold strategy over the 5-node ladder with per-node
    thresholds — the knob that forces/forbids escalation."""
    return (mod.ThresholdStrategy(5, np.asarray(thresholds, np.float32),
                                  recall=recall, lam=1.0),)


def test_engine_cascade_bit_identical_across_runs(engine_banks):
    """Both models live in one process; token streams are identical
    run to run."""
    bank = engine_banks[1]
    requests = _engine_requests(5)
    # unsatisfiable small thresholds -> every token escalates; large
    # node 1 always satisfies -> walk ends there; argmin serves
    strat_bank = _threshold_bank(tstrategy, [0.0, 0.0, 0.0, 2.0, 2.0])
    m1, st1 = _engine_serve(bank, strat_bank, lambda r: 0, requests)
    assert m1.summary()["completed"] == len(requests)
    assert st1.stats.escalations > 0
    assert st1.stats.tokens_served[1] > 0
    m2, _ = _engine_serve(bank, strat_bank, lambda r: 0, requests)
    for r in requests:
        assert m1.records[r.rid].tokens == m2.records[r.rid].tokens, \
            f"request {r.rid} stream changed across runs"


def test_engine_cascade_no_escalation_matches_single_model(engine_banks):
    """A ladder whose strategy never leaves the small model emits
    exactly what the single-model runtime emits — the walk_io handoff
    is a no-op when unused."""
    bank = engine_banks[1]
    requests = _engine_requests(4, seed=9)
    strat_bank = _threshold_bank(tstrategy, [2.0] * 5)
    m_casc, st = _engine_serve(bank, strat_bank, lambda r: 0, requests)
    assert st.stats.escalations == 0
    assert st.stats.tokens_served == [sum(r.max_tokens for r in requests),
                                      0]
    single = (tstrategy.ThresholdStrategy(2, np.full(2, 2.0, np.float32),
                                          recall=True, lam=1.0),)
    sm = bank[0]
    stepper = EngineStepper(sm.params, sm.cfg, single, n_lanes=2,
                            cache_len=32, prompt_len=PROMPT_LEN,
                            kv="paged", page_size=8, prefill_chunk=4)
    with torch.no_grad():
        m_single = trt.Server(stepper, trt.LaneScheduler(2), lambda r: 0,
                              slo=10.0).serve(requests)
    for r in requests:
        assert m_casc.records[r.rid].tokens == \
            m_single.records[r.rid].tokens, f"request {r.rid}"


class _MantissaAlternator(tstrategy.ThresholdStrategy):
    """Escalate past the small head iff floor(997 * loss) is odd — a
    deterministic, data-dependent alternator, which forces escalate ->
    idle -> de-escalate -> RE-escalate cycles."""

    def observe(self, state, node, losses, active, aux=None):
        state, cont = super().observe(state, node, losses, active, aux)
        if node == 1:
            esc = torch.floor(losses * 997.0).to(torch.int32) % 2 == 1
            cont = active & esc
        return state, cont


class _JaxMantissaAlternator(jstrategy.ThresholdStrategy):
    """The reference test's alternator, verbatim."""

    def observe(self, state, node, losses, active, aux=None):
        state, cont = super().observe(state, node, losses, active, aux)
        esc = (jnp.floor(losses * 997.0).astype(jnp.int32) % 2) == 1
        cont = jnp.where(jnp.asarray(node) == 1, active & esc, cont)
        return state, cont


ALT_THRESHOLDS = [0.0, 0.0, 0.0, 2.0, 2.0]


def _alternator_serve(engine_banks, pages, pkg):
    bank = engine_banks[0 if pkg == "jax" else 1]
    cls = _JaxMantissaAlternator if pkg == "jax" else _MantissaAlternator
    strat_bank = (cls(5, np.asarray(ALT_THRESHOLDS, np.float32),
                      recall=True, lam=1.0),)
    return _engine_serve(bank, strat_bank, lambda r: 0,
                         _one_request(JRequest if pkg == "jax" else Request),
                         patience=1, pages=pages, pkg=pkg)


def test_engine_cascade_deescalation_and_prefix_repin(engine_banks):
    """Recall policy: rungs idle past the patience window release their
    lane; a later RE-escalation's catch-up hits the rung's prefix cache
    (re-pin) instead of recomputing the whole stream.  The reference on
    the same weights gives the same stats."""
    m, st = _alternator_serve(engine_banks, [9, 13], "torch")
    cs = st.cascade_stats()
    # precondition: the path under test really runs on these weights
    assert cs["escalations"] >= 2, cs
    assert m.summary()["completed"] == 1
    assert cs["deescalations"] >= 1, cs
    assert cs["repin_tokens"] > 0, cs
    assert cs["pools"]["casc-l"]["prefix_hits"] > 0, cs
    jm, jst = _alternator_serve(engine_banks, [9, 13], "jax")
    assert cs == jst.cascade_stats()
    assert m.records[0].tokens == jm.records[0].tokens
    assert st.served_nodes == jst.served_nodes


def test_engine_cascade_wedge_raises_instead_of_spinning(engine_banks):
    """A deeper rung whose pool can never admit the catch-up fails
    loudly (PoolExhausted) — it does not spin the serve loop forever —
    in both packages."""
    # precondition: with room to spare the stream re-escalates, and its
    # catch-up outgrows the 5-page pool of the wedge case
    _, st = _alternator_serve(engine_banks, [9, 13], "torch")
    cs = st.cascade_stats()
    assert cs["escalations"] >= 2
    assert cs["pools"]["casc-l"]["pages_peak"] > 5 - 1
    with pytest.raises(PoolExhausted, match="wedged|cannot fit"):
        _alternator_serve(engine_banks, [9, 5], "torch")
    with pytest.raises(JPoolExhausted, match="wedged|cannot fit"):
        _alternator_serve(engine_banks, [9, 5], "jax")


def test_engine_cascade_commit_policy_releases_source(engine_banks):
    bank = engine_banks[1]
    requests = _engine_requests(3, seed=13)
    strat_bank = _threshold_bank(tstrategy, [0.0, 0.0, 0.0, 2.0, 2.0],
                                 recall=False)
    m, st = _engine_serve(bank, strat_bank, lambda r: 0, requests,
                          policy="commit")
    assert m.summary()["completed"] == len(requests)
    assert st.stats.commits > 0
    assert st.stats.tokens_served[0] == 0  # committed slots: large only
    # the small pool's pages were released at commit
    assert st.steppers[0].pool.n_held.sum() == 0


@pytest.mark.parametrize("policy", ["recall", "commit"])
def test_engine_cascade_serves_what_the_reference_serves(engine_banks,
                                                         policy):
    """The same weights, requests (all at t = 0, so admission depends
    only on lane turnover) and strategy through both packages' engine
    cascades: per request, tokens and served nodes equal, and so is
    cascade_stats() (pools and chunk counters included)."""
    thr = [0.0, 0.0, 0.0, 2.0, 2.0]
    runs = []
    for pkg, mod, cls in (("jax", jstrategy, JRequest),
                          ("torch", tstrategy, Request)):
        bank = engine_banks[0 if pkg == "jax" else 1]
        requests = _engine_requests(5, cls=cls, arrival_gap=0.0)
        runs.append(_engine_serve(
            bank, _threshold_bank(mod, thr, recall=(policy == "recall")),
            lambda r: 0, requests, policy=policy, pkg=pkg))
    (jm, jst), (tm, tst) = runs
    jcs = jst.cascade_stats()
    assert jcs["escalations"] > 0 and jcs["tokens_served"][1] > 0
    if policy == "commit":
        assert jcs["commits"] > 0
    for rid, rec in jm.records.items():
        assert tm.records[rid].tokens == rec.tokens, f"request {rid}"
        assert tm.records[rid].n_tokens == 2 + rid % 3
    assert tst.served_nodes == jst.served_nodes
    assert tst.cascade_stats() == jcs


# --------------------------------------------------------------------------
# the token step's escalation handoff
# --------------------------------------------------------------------------

def _cache_to_torch(tree):
    """A reference cache tree -> the port's: bf16 leaves via f32."""
    if isinstance(tree, dict):
        return {k: _cache_to_torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_cache_to_torch(v) for v in tree]
    a = np.asarray(tree)
    if a.dtype == jnp.bfloat16:
        return torch.tensor(np.asarray(a, np.float32)).to(torch.bfloat16)
    return torch.tensor(a)


def test_token_step_walk_handoff_matches_the_reference(engine_banks):
    """Rung 0's ``walk_io`` step, then rung 1's ``resume_walk`` step on
    the handed-off states and logits (node offset 2): tokens, served
    nodes, segment counters, walk activity and integer state fields
    equal the reference's; logits and float state fields within f32
    tolerance."""
    b = 4
    rng = np.random.default_rng(11)
    prompt = rng.integers(0, VOCAB, (b, PROMPT_LEN)).astype(np.int32)
    # mid-range thresholds on the small rung: some walks stop there,
    # others hand off to the large rung and stop at different nodes
    thr = np.asarray([0.0, 0.9937, 0.99, 0.9937, 2.0], np.float32)
    occupied = np.asarray([True, True, True, False])
    sid = np.zeros(b, np.int32)
    outs = []
    for pkg in ("jax", "torch"):
        bank = engine_banks[0 if pkg == "jax" else 1]
        mod = jstrategy if pkg == "jax" else tstrategy
        strat = (mod.ThresholdStrategy(5, thr, recall=True, lam=1.0),)
        out = []
        walk = None
        states = tuple(s.init(b) for s in strat)
        for m in range(2):
            sp = bank[m]
            jlogits, jcaches, _, jpos = JM.prefill(
                engine_banks[0][m].params, engine_banks[0][m].cfg,
                {"tokens": jnp.asarray(prompt)}, 16)
            tok0 = np.array(jnp.argmax(jlogits, -1), np.int32)
            if pkg == "jax":
                step = jmake_step(sp.params, sp.cfg, strat, jit=False,
                                  carry_state=True, node_offset=2 * m,
                                  walk_io=True, resume_walk=m > 0)
                if walk is None:
                    walk = (jnp.ones(b, bool),
                            jnp.zeros((b, VOCAB), jnp.float32))
                res = step(jnp.asarray(tok0), jcaches, jpos,
                           jnp.asarray(occupied), jnp.asarray(sid), None,
                           states, None, walk)
            else:
                step = tmake_step(sp.params, sp.cfg, strat,
                                  carry_state=True, node_offset=2 * m,
                                  walk_io=True, resume_walk=m > 0)
                if walk is None:
                    walk = (torch.ones(b, dtype=torch.bool),
                            torch.zeros((b, VOCAB)))
                with torch.no_grad():
                    res = step(torch.as_tensor(tok0),
                               _cache_to_torch(jcaches),
                               torch.tensor(np.asarray(jpos)),
                               torch.as_tensor(occupied),
                               torch.as_tensor(sid), None, states, None,
                               walk)
            tok, _, served, sb, sp_, states, walk = res
            out.append((np.asarray(tok), np.asarray(served), int(sb),
                        int(sp_), np.asarray(walk[0]), np.asarray(walk[1]),
                        [np.asarray(getattr(states[0], f.name))
                         for f in dataclasses.fields(states[0])]))
        outs.append(out)
    (j0, j1), (t0, t1) = outs
    # the handoff really splits the lanes: some stop on rung 0, some
    # continue into rung 1
    assert j0[4][occupied].any() and not j0[4][occupied].all()
    for j, t in ((j0, t0), (j1, t1)):
        for i in range(5):
            np.testing.assert_array_equal(t[i], j[i])
        np.testing.assert_allclose(t[5], j[5], **F32)
        for jf, tf in zip(j[6], t[6]):
            if jf.dtype.kind == "f":
                np.testing.assert_allclose(tf, jf, **F32)
            else:
                np.testing.assert_array_equal(tf, jf)


# --------------------------------------------------------------------------
# the launcher
# --------------------------------------------------------------------------

def test_launcher_serves_cascade_on_cpu(capsys, tmp_path):
    torch.set_num_threads(2)
    run = tserve.main([
        "--smoke", "--device", "cpu", "--cascade",
        "paper-ee-100m:paper-ee-100m", "--paged-kernel", "--prefill-chunk",
        "8", "--page-size", "8", "--policy", "skip_recall", "--lanes", "2",
        "--cascade-lanes", "1", "--rate", "6", "--duration", "0.6",
        "--tokens", "4", "--prompt-len", "10", "--cache-len", "32",
        "--workload", "bursty", "--order", "edf", "--slo-ms", "300",
        "--json", str(tmp_path / "m.json")])
    assert run is not None and run.requests
    for req in run.requests:
        assert run.metrics.records[req.rid].n_tokens == req.max_tokens
    cs = run.cascade_stats
    assert cs["models"] == ["0:paper-ee-100m", "1:paper-ee-100m"]
    assert sum(cs["tokens_served"]) == sum(r.max_tokens
                                           for r in run.requests)
    assert run.cascade.boundaries == (2, 2)
    out = capsys.readouterr().out
    assert "bursty requests" in out and "SLO ttft<=300ms" in out
    assert "cascade: 0:paper-ee-100m served " in out
    assert "kv pool [1:paper-ee-100m]: " in out


def test_launcher_cascade_flags_follow_the_reference():
    args = tserve.parse_args(["--cascade", "a:b", "--lanes", "6"])
    assert args.server and args.cascade_lanes == 3
    assert (args.escalate_policy, args.escalate_patience, args.workload,
            args.order, args.eos, args.slo_ms) == (
        "recall", 4, "poisson", "fifo", None, 1000.0)
    with pytest.raises(SystemExit):
        tserve.parse_args(["--escalate-policy", "sometimes"])


def test_calibrate_multi_follows_the_reference(engine_banks):
    """The same prompts through both packages' multi-model calibration:
    equal boundaries and costs, losses' support within f32 tolerance,
    and the same chain."""
    from repro.launch import serve as jserve
    jbank, tbank = engine_banks
    # the reference draws its prompts from a key; the port is handed
    # the same arrays
    key = jax.random.PRNGKey(7)
    tokens = np.array(jax.random.randint(key, (128, 32), 0, VOCAB))
    jc = jserve._calibrate_multi([s.cfg for s in jbank.specs],
                                 [s.params for s in jbank.specs], key, 0.5)
    tc = tserve._calibrate_multi([s.cfg for s in tbank.specs],
                                 [s.params for s in tbank.specs], tokens,
                                 0.5)
    assert tc.boundaries == jc.boundaries == (2, 3)
    np.testing.assert_allclose(tc.costs.numpy(), np.asarray(jc.costs),
                               rtol=1e-6)
    np.testing.assert_allclose(tc.support.grid.numpy(),
                               np.asarray(jc.support.grid), **F32)
    np.testing.assert_allclose(tc.chain.trans.numpy(),
                               np.asarray(jc.chain.trans), atol=1e-6)


def test_launcher_cascade_refuses_to_run_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA is not available"):
        tserve.main(["--smoke", "--cascade",
                     "paper-ee-100m:paper-ee-100m"])
