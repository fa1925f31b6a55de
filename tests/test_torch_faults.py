"""The port's fault plane (repro_torch.serving.faults and its hooks in
`Server`, `SimStepper`, `CascadeSimStepper`, the launcher) against the
JAX package's, mirroring every test of tests/serving/test_faults.py but
the chaos soak leg (its `benchmarks.soak` run imports the JAX package):

  * `FaultPlan`: seeded generation is deterministic and its
    ``faults/v1`` doc EQUAL to the reference's on the same requests;
    stamping is non-destructive; the doc round-trips and the reference's
    validator accepts it; the serve queries;
  * chaos: a cancellation storm + deadline squeeze + rung stall + page
    squeeze through one pool-gated sim serve replays bit-identically,
    its records EQUAL to the reference's, and leaves the pool clean;
    on a tighter pool with reclamation armed it clips history as the
    reference does;
  * cancellation mid-stream (COW-shared prefix) and in the queue;
    deadline reaping only when opted in — records equal;
  * the `DegradeGovernor` on the cascade sim: deadline and stall
    denials serve the small rung, slack denies nothing; records and
    ``cascade_stats()`` (governor counters included) EQUAL to the
    reference's; its unit decisions;
  * sliding-window reclamation and the page squeeze, and terminal
    accounting in the metrics, each scenario run on both packages with
    EQUAL end states;
  * the launcher serves ``--faults`` / ``--cancel-rate`` /
    ``--deadline-ms`` / ``--kv-reclaim`` on the CPU, and a cascade under
    a plan that stalls rung 1, whose governor denies every escalation;
  * the observability plane under faults: the chaos serve's span
    digest, ledger report and events doc (plan embedded), the cancel
    tests' ledger probes, the governor's ``denied`` recall spans and
    its one ``rung_stall`` span, the loss map's cancelled and stall
    causes, the three fault-plane ledger contracts and a reaped
    request's Perfetto span — each EQUAL to the reference's.

Decisions are exact (tables bridged from the reference), so every
compared record is EQUAL.
"""

import json

import jax
import numpy as np
import pytest
import torch

from repro import strategy as jstrategy
from repro.core import traces as jtraces
from repro.serving import cascade as jcascade
from repro.serving import runtime as jrt
from repro.serving.faults import DegradeGovernor as JGovernor
from repro.serving.faults import FaultPlan as JPlan
from repro.serving import obs as jobs
from repro.serving.kvpool import KVPool as JPool
from repro.serving.obs import export as jexport
from repro.serving.obs import lossmap as jlossmap
from repro.serving.runtime.metrics import RuntimeMetrics as JMetrics
from repro.serving.runtime.request import Request as JRequest
from repro.serving.runtime.workload import WorkloadSpec as JSpec
from repro_torch import strategy as tstrategy
from repro_torch.bridge import (chain_from_numpy, line_tables_from_numpy,
                                skip_tables_from_numpy, support_from_numpy,
                                to_tensor)
from repro_torch.launch import serve as tserve
from repro_torch.serving import runtime as trt
from repro_torch.serving.cascade import (CascadeSimStepper, ModelBank,
                                         ModelSpec)
from repro_torch.serving.faults import DegradeGovernor, FaultPlan
from repro_torch.serving import obs as tobs
from repro_torch.serving.kvpool import KVPool
from repro_torch.serving.obs import export as texport
from repro_torch.serving.obs import lossmap as tlossmap
from repro_torch.serving.runtime.metrics import RuntimeMetrics
from repro_torch.serving.runtime.request import Request
from repro_torch.serving.runtime.workload import WorkloadSpec

N_NODES = 5
CPU = "cpu"


def _bridge(jcasc, *, line=False, skip=None):
    """The port's `Cascade` holding the reference's fitted spec and its
    solved tables (line, or skip in mode ``skip``)."""
    tree = lambda x: jax.tree.map(np.asarray, x)   # noqa: E731
    tcasc = tstrategy.Cascade(
        support=support_from_numpy(tree(jcasc.support)),
        chain=chain_from_numpy(tree(jcasc.chain)),
        costs=to_tensor(np.asarray(jcasc.costs)), lam=jcasc.lam,
        boundaries=jcasc.boundaries)
    if line:
        tcasc.line_tables = line_tables_from_numpy(tree(jcasc.solve_line()))
    if skip is not None:
        tcasc.skip_tables = skip_tables_from_numpy(
            tree(jcasc.solve_skip(skip)))
        tcasc.edge_costs = np.asarray(jcasc.edge_costs)
        tcasc.skip_mode = skip
    return tcasc


@pytest.fixture(scope="module")
def sim_cascade():
    torch.set_num_threads(2)
    rng = np.random.default_rng(0)
    losses, _, flops = jtraces.ee_like_traces(rng, 3_000, N_NODES)
    jcasc = jstrategy.Cascade.from_traces(losses[:1_500], 0.4 * flops,
                                          k=12, lam=0.6)
    return jcasc, _bridge(jcasc, line=True), losses[1_500:]


PKG = {"jax": dict(rt=jrt, plan=JPlan, pool=JPool, req=JRequest,
                   spec=JSpec, strategy=jstrategy, gov=JGovernor,
                   metrics=JMetrics, obs=jobs, export=jexport,
                   lossmap=jlossmap, kw={}),
       "torch": dict(rt=trt, plan=FaultPlan, pool=KVPool, req=Request,
                     spec=WorkloadSpec, strategy=tstrategy,
                     gov=DegradeGovernor, metrics=RuntimeMetrics, obs=tobs,
                     export=texport, lossmap=tlossmap, kw={"device": CPU})}


def _records(metrics):
    return {rid: r.as_dict() for rid, r in sorted(metrics.records.items())}


def _pool_clean(pool):
    """Only prefix-cache refs may survive a serve."""
    assert pool.n_held.sum() == 0
    assert int(pool.budget.sum()) == 0
    pool.prefix.clear()
    assert pool.pages_in_use == 0
    assert pool.check_invariants() == []


# --------------------------------------------------------------------------
# the plan itself
# --------------------------------------------------------------------------

def _requests(cls=Request, n=12, seed=3):
    rng = np.random.default_rng(seed)
    return [cls(rid=r, prompt=rng.integers(0, 512, 4, np.int32),
                max_tokens=3 + r % 5, arrival=r * 0.2)
            for r in range(n)]


def test_fault_plan_seeded_and_deterministic():
    reqs = _requests()
    kw = dict(seed=7, cancel_rate=0.5, cancel_after=(0.5, 2.0),
              deadline=(1.0, 4.0), stalls=[(1, 2.0, 3.0)],
              squeezes=[(1.0, 2.5, 2)])
    p1 = FaultPlan.generate(reqs, **kw)
    p2 = FaultPlan.generate(reqs, **kw)
    assert p1.as_doc() == p2.as_doc()
    assert p1.as_doc() == JPlan.generate(_requests(JRequest), **kw).as_doc()
    assert 0 < len(p1.cancel_at) < len(reqs)     # a storm, not a wipe
    assert len(p1.deadline) == len(reqs)
    for rid, t in p1.cancel_at.items():
        assert reqs[rid].arrival + 0.5 <= t <= reqs[rid].arrival + 2.0
    p3 = FaultPlan.generate(reqs, **{**kw, "seed": 8})
    assert p3.cancel_at != p1.cancel_at or p3.deadline != p1.deadline


def test_fault_plan_stamp_and_doc_roundtrip(tmp_path):
    reqs = _requests()
    kw = dict(seed=7, cancel_rate=0.4, deadline=3.0,
              stalls=[(0, 1.0, 2.0)], squeezes=[(0.5, 1.5, 1)])
    plan = FaultPlan.generate(reqs, **kw)
    assert plan.as_doc() == JPlan.generate(_requests(JRequest),
                                           **kw).as_doc()
    stamped = plan.stamp(reqs)
    for orig, new in zip(reqs, stamped):
        assert orig.cancel_at is None            # originals untouched
        assert new.cancel_at == plan.cancel_at.get(orig.rid)
        assert new.deadline == plan.deadline.get(orig.rid)
        if orig.rid not in plan.cancel_at and orig.rid not in plan.deadline:
            assert new is orig                   # untouched == same object
    doc = json.loads(json.dumps(plan.as_doc()))
    assert FaultPlan.from_doc(doc).as_doc() == plan.as_doc()
    plan.save(str(tmp_path / "plan.json"))
    assert FaultPlan.load(str(tmp_path / "plan.json")).as_doc() \
        == plan.as_doc()
    # the reference loads the port's file, and its validator accepts it
    assert JPlan.load(str(tmp_path / "plan.json")).as_doc() == plan.as_doc()
    from benchmarks.check_trace import validate_faults
    assert validate_faults(doc) == []
    assert validate_faults({**doc, "schema": "nope"}) != []
    with pytest.raises(ValueError, match="faults/v1"):
        FaultPlan.from_doc({**doc, "schema": "nope"})


def test_fault_plan_serve_queries():
    plan = FaultPlan(stalls=[(1, 2.0, 4.0), (0, 3.0, 5.0)],
                     squeezes=[(1.0, 2.0, 2), (1.5, 3.0, 1)])
    assert plan.stall_active(1, 2.0) and not plan.stall_active(1, 4.0)
    assert plan.stall_window(1, 3.0) == (2.0, 4.0)
    assert plan.stall_overlap(1, 0.0, 10.0) == pytest.approx(2.0)
    assert plan.stall_overlap(1, 3.0, 3.5) == pytest.approx(0.5)
    assert plan.squeeze_pages(1.7) == 3          # both windows active
    assert plan.squeeze_pages(2.5) == 1
    assert plan.squeeze_pages(5.0) == 0
    assert plan.next_change(0.0) == 1.0
    assert plan.next_change(2.5) == 3.0
    assert plan.next_change(99.0) is None


# --------------------------------------------------------------------------
# chaos determinism: the full storm replays bit-identically
# --------------------------------------------------------------------------

def _chaos_serve(pkg, casc, bank, *, prompt_len=4, n_pages=24,
                 reclaim=None, obs=None):
    """Cancellation storm + deadline squeeze + rung stall + page squeeze
    through one pool-gated sim serve; ``reclaim`` arms the pool's
    sliding-window reclamation at that watermark, ``obs`` observes."""
    p = PKG[pkg]
    spec = p["spec"](rate=3.0, duration=8.0, prompt_len=prompt_len,
                     max_tokens=(5, 25), seed=7)
    requests = p["rt"].make_workload("poisson", spec)
    plan = p["plan"].generate(requests, seed=13, cancel_rate=0.25,
                              cancel_after=(0.1, 1.0), deadline=(3.0, 9.0),
                              stalls=[(0, 1.0, 2.0)],
                              squeezes=[(2.5, 4.0, 2)])
    requests = plan.stamp(requests)
    pool = p["pool"](n_lanes=3, page_size=4, lane_pages=12,
                     n_pages=n_pages, reclaim_watermark=reclaim)
    strategies, sid_of = p["rt"].build_bank(
        requests, p["rt"].cascade_factory(casc), ("recall_index", None))
    stepper = p["rt"].SimStepper(strategies, bank, n_lanes=3, seg_time=0.05,
                                 overhead=0.01, pool=pool, faults=plan,
                                 **p["kw"])
    server = p["rt"].Server(stepper, p["rt"].LaneScheduler(3), sid_of,
                            slo=5.0, obs=obs, enforce_deadlines=True)
    return server.serve(requests), plan, pool


def test_chaos_serve_deterministic_and_clean(sim_cascade):
    jcasc, tcasc, bank = sim_cascade
    m1, plan, pool = _chaos_serve("torch", tcasc, bank)
    m2, _, _ = _chaos_serve("torch", tcasc, bank)
    jm, jplan, jpool = _chaos_serve("jax", jcasc, bank)
    s = m1.summary()
    assert s["cancelled"] > 0
    assert s["completed"] > 0
    assert s["cancelled"] + s["timed_out"] + s["completed"] == \
        s["requests"]
    assert _records(m1) == _records(m2)
    # the reference's storm, request for request
    assert plan.as_doc() == jplan.as_doc()
    assert _records(m1) == _records(jm)
    assert s == jm.summary()
    assert pool.stats() == jpool.stats()
    _pool_clean(pool)


def test_chaos_serve_reclaims_like_the_reference(sim_cascade):
    """The same storm on a tighter pool with reclamation armed (the
    launcher's ``--kv-reclaim``): 3-token prompts leave each lane's head
    page private once its shared tail is split, so admissions short on
    headroom clip history.  Records, summary and pool stats EQUAL to the
    reference's, the pool clean at the end."""
    jcasc, tcasc, bank = sim_cascade
    kw = dict(prompt_len=3, n_pages=20, reclaim=0.5)
    m, _, pool = _chaos_serve("torch", tcasc, bank, **kw)
    jm, _, jpool = _chaos_serve("jax", jcasc, bank, **kw)
    assert pool.reclaimed_pages > 0 and pool.reserve_failures > 0
    assert m.summary()["cancelled"] > 0 and m.summary()["completed"] > 0
    assert _records(m) == _records(jm)
    assert m.summary() == jm.summary()
    assert pool.stats() == jpool.stats()
    assert pool.clipped.tolist() == jpool.clipped.tolist()
    _pool_clean(pool)


def _chaos_obs(sim_cascade, ledger=False):
    """The chaos serve under an `Observability` (with an invariant
    ledger if ``ledger``) in each package: {pkg: (metrics, plan, pool,
    obs)}."""
    jcasc, tcasc, bank = sim_cascade
    out = {}
    for pkg, casc in (("jax", jcasc), ("torch", tcasc)):
        o = PKG[pkg]["obs"]
        obs = o.Observability(ledger=o.InvariantLedger() if ledger
                              else None)
        out[pkg] = _chaos_serve(pkg, casc, bank, obs=obs) + (obs,)
    return out


def test_chaos_serve_span_digest_reproducible(sim_cascade):
    runs = [_chaos_obs(sim_cascade) for _ in range(2)]
    o1, o2 = runs[0]["torch"][3], runs[1]["torch"][3]
    assert o1.tracer.span_digest() == o2.tracer.span_digest()
    assert o1.tracer.span_digest() == runs[0]["jax"][3].tracer.span_digest()
    kinds = {ev.kind for ev in o1.tracer.events}
    assert "cancel" in kinds
    assert "rung_stall" in kinds


def test_chaos_serve_ledger_clean_and_pool_empty(sim_cascade):
    out = _chaos_obs(sim_cascade, ledger=True)
    reps = {pkg: run[3].ledger.report() for pkg, run in out.items()}
    assert reps["torch"] == reps["jax"]
    rep = reps["torch"]
    assert rep["total_violations"] == 0, rep["violations"]
    assert rep["contracts"]["cancel_halts_stream"]["checks"] > 0
    _pool_clean(out["torch"][2])


def test_chaos_events_doc_carries_plan(sim_cascade):
    from benchmarks.check_trace import validate_events
    out = _chaos_obs(sim_cascade)
    docs = {}
    for pkg, (_, plan, _, obs) in out.items():
        docs[pkg] = json.loads(json.dumps(
            PKG[pkg]["export"].events_doc(obs.tracer, faults=plan),
            default=float))
    assert docs["torch"] == docs["jax"]
    doc, plan = docs["torch"], out["torch"][1]
    assert doc["faults"]["schema"] == "faults/v1"
    assert FaultPlan.from_doc(doc["faults"]).as_doc() == plan.as_doc()
    assert validate_events(doc) == []
    bad = json.loads(json.dumps(doc))
    bad["faults"]["squeezes"] = [[3.0, 1.0, 2]]    # t1 < t0
    assert validate_events(bad) != []


# --------------------------------------------------------------------------
# cancellation releases pages (COW-shared prefixes)
# --------------------------------------------------------------------------

def _cow_serve(pkg, casc, bank):
    p = PKG[pkg]
    prompt = np.arange(6, dtype=np.int32)        # 6 % 4: partial tail
    requests = [
        p["req"](rid=0, prompt=prompt, max_tokens=20, arrival=0.0),
        p["req"](rid=1, prompt=prompt.copy(), max_tokens=20, arrival=0.0,
                 cancel_at=0.4),
    ]
    pool = p["pool"](n_lanes=2, page_size=4, lane_pages=8, n_pages=16)
    strategies, sid_of = p["rt"].build_bank(
        requests, p["rt"].cascade_factory(casc), ("recall_index", None))
    stepper = p["rt"].SimStepper(strategies, bank, n_lanes=2, seg_time=0.05,
                                 overhead=0.01, pool=pool, **p["kw"])
    obs = p["obs"].Observability(ledger=p["obs"].InvariantLedger())
    server = p["rt"].Server(stepper, p["rt"].LaneScheduler(2), sid_of,
                            slo=5.0, obs=obs)
    return server.serve(requests), pool, obs.ledger


def test_cancel_mid_stream_releases_pages_under_cow(sim_cascade):
    """Two lanes share a prompt whose partial tail page forces COW
    splits; cancelling one mid-decode leaves its lane page-clean without
    disturbing the survivor or the shared prefix chain."""
    jcasc, tcasc, bank = sim_cascade
    metrics, pool, ledger = _cow_serve("torch", tcasc, bank)
    jm, _, jledger = _cow_serve("jax", jcasc, bank)
    assert _records(metrics) == _records(jm)
    # the ledger probed the pool AT the cancel event and found it clean
    rep = ledger.report()
    assert rep == jledger.report()
    assert rep["contracts"]["cancel_releases_pages"]["checks"] >= 1
    assert rep["contracts"]["cancel_halts_stream"]["checks"] >= 1
    assert rep["total_violations"] == 0, rep["violations"]
    rec = metrics.records[1]
    assert rec.status == "cancelled"
    assert rec.finished is None
    assert 0 < rec.n_tokens < 20
    assert metrics.records[0].status == "completed"
    assert metrics.records[0].n_tokens == 20
    assert pool.cow_splits >= 1
    assert pool.n_held.sum() == 0                # both lanes released
    assert len(pool.prefix) >= 1
    _pool_clean(pool)


def test_cancel_in_queue_never_admits(sim_cascade):
    """A request whose cancel fires while it still waits in the queue is
    reaped there: no admission, no tokens, no ledger violation."""
    jcasc, tcasc, bank = sim_cascade
    out, obs = {}, {}
    for pkg, casc in (("jax", jcasc), ("torch", tcasc)):
        p = PKG[pkg]
        requests = [
            p["req"](rid=0, prompt=np.zeros(4, np.int32), max_tokens=30,
                     arrival=0.0),
            p["req"](rid=1, prompt=np.ones(4, np.int32), max_tokens=5,
                     arrival=0.0, cancel_at=0.05),
        ]
        strategies, sid_of = p["rt"].build_bank(
            requests, p["rt"].cascade_factory(casc), ("recall_index", None))
        stepper = p["rt"].SimStepper(strategies, bank, n_lanes=1,
                                     seg_time=0.05, overhead=0.01,
                                     **p["kw"])
        obs[pkg] = p["obs"].Observability(ledger=p["obs"].InvariantLedger())
        out[pkg] = p["rt"].Server(stepper, p["rt"].LaneScheduler(1), sid_of,
                                  slo=5.0, obs=obs[pkg]).serve(requests)
    metrics = out["torch"]
    assert _records(metrics) == _records(out["jax"])
    assert obs["torch"].ledger.total_violations == 0
    assert obs["torch"].ledger.report() == obs["jax"].ledger.report()
    rec = metrics.records[1]
    assert rec.status == "cancelled"
    assert rec.admitted is None and rec.n_tokens == 0
    assert metrics.records[0].status == "completed"


def test_deadline_reap_requires_opt_in(sim_cascade):
    """`deadline` is an EDF ordering hint by default; only
    ``enforce_deadlines=True`` turns expiry into a reap."""
    jcasc, tcasc, bank = sim_cascade
    runs = {}
    for pkg, casc in (("jax", jcasc), ("torch", tcasc)):
        p = PKG[pkg]

        def reqs():
            return [p["req"](rid=0, prompt=np.zeros(4, np.int32),
                             max_tokens=20, arrival=0.0, deadline=0.3)]

        strategies, sid_of = p["rt"].build_bank(
            reqs(), p["rt"].cascade_factory(casc), ("recall_index", None))
        for enforce in (False, True):
            stepper = p["rt"].SimStepper(strategies, bank, n_lanes=1,
                                         seg_time=0.05, overhead=0.01,
                                         **p["kw"])
            server = p["rt"].Server(stepper, p["rt"].LaneScheduler(1),
                                    sid_of, slo=5.0,
                                    enforce_deadlines=enforce)
            runs[pkg, enforce] = server.serve(reqs())
    lax, strict = runs["torch", False], runs["torch", True]
    for enforce in (False, True):
        assert _records(runs["torch", enforce]) == \
            _records(runs["jax", enforce])
    assert lax.records[0].status == "completed"
    assert strict.records[0].status == "timed_out"
    assert 0 < strict.records[0].n_tokens < 20
    s = strict.summary()
    assert s["timed_out"] == 1 and s["completed"] == 0
    assert s["deadline_slack"]["p50"] < 0.0      # the deadline was missed


# --------------------------------------------------------------------------
# degrade governor: demotion instead of failure
# --------------------------------------------------------------------------

N0, N1 = 2, 3
SPECS = [dict(name="small", n_nodes=N0, n_lanes=3, seg_time=0.01,
              prefill_tok_time=0.001),
         dict(name="large", n_nodes=N1, n_lanes=2, seg_time=0.04,
              prefill_tok_time=0.004)]


@pytest.fixture(scope="module")
def casc_setup():
    rng = np.random.default_rng(3)
    losses, boundaries = jtraces.cascade_traces(
        rng, 3_000, [(2.0, 3.0), (5.0, 8.0, 12.0)], head_overthink=0.3)
    costs = np.concatenate([np.full(N0, 0.5 / N0), np.full(N1, 2.0 / N1)])
    jcasc = jstrategy.Cascade.from_traces(losses[:1_500], 0.1 * costs,
                                          k=10, lam=0.9,
                                          boundaries=boundaries)
    return jcasc, _bridge(jcasc, skip="cascade"), losses[1_500:]


def _casc_requests(cls, n, seed=5, deadline=None):
    rng = np.random.default_rng(seed)
    return [cls(rid=r, prompt=rng.integers(0, 512, 8, np.int32),
                max_tokens=3 + r % 5, arrival=r * 0.05,
                strategy="skip_recall",
                deadline=(r * 0.05 + deadline
                          if deadline is not None else None))
            for r in range(n)]


def _casc_serve(pkg, casc_setup, n, *, seed=5, deadline=None,
                governor=False, stalls=()):
    """A governed cascade sim serve under a tracer: (metrics, stepper,
    governor, observability)."""
    jcasc, tcasc, bank_traces = casc_setup
    if pkg == "jax":
        casc, mod = jcasc, jcascade
        rt, cls, gov_cls, plan_cls, kw = jrt, JRequest, JGovernor, JPlan, {}
    else:
        casc, mod = tcasc, None
        rt, cls, gov_cls, plan_cls = trt, Request, DegradeGovernor, FaultPlan
        kw = {"device": CPU}
    strat_mod = PKG[pkg]["strategy"]
    bank_cls, spec_cls, stepper_cls = (
        (mod.ModelBank, mod.ModelSpec, mod.CascadeSimStepper)
        if mod is not None else (ModelBank, ModelSpec, CascadeSimStepper))
    mbank = bank_cls([spec_cls(**s) for s in SPECS])
    requests = _casc_requests(cls, n, seed=seed, deadline=deadline)

    def mk(name, lam):
        return strat_mod.make("skip_recall", casc, mode="cascade")

    strat_bank, sid_of = rt.build_bank(requests, mk, ("skip_recall", None))
    gov = gov_cls() if governor else None
    faults = plan_cls(stalls=stalls) if stalls else None
    stepper = stepper_cls(mbank, strat_bank, bank_traces, overhead=0.002,
                          policy="recall", patience=3, chunk=16,
                          faults=faults, governor=gov, **kw)
    obs = PKG[pkg]["obs"].Observability()
    server = rt.Server(stepper, rt.LaneScheduler(mbank[0].n_lanes), sid_of,
                       slo=2.0, obs=obs)
    return server.serve(requests), stepper, gov, obs


def _casc_pair(casc_setup, n, **kw):
    """The same governed cascade serve in both packages: records,
    summary, cascade_stats() and span digest equal; returns the
    port's."""
    jm, jst, _, jobs_ = _casc_serve("jax", casc_setup, n, **kw)
    tm, tst, gov, obs = _casc_serve("torch", casc_setup, n, **kw)
    assert _records(tm) == _records(jm)
    assert tm.summary() == jm.summary()
    assert tst.cascade_stats() == jst.cascade_stats()
    assert obs.tracer.span_digest() == jobs_.tracer.span_digest()
    return tm, tst, gov, obs


def test_governor_deadline_denial_serves_small_rung(casc_setup):
    """An escalation the deadline budget cannot afford is denied and the
    slot serves the best shallow answer it already probed."""
    _, st0, _, _ = _casc_pair(casc_setup, 10)
    assert st0.stats.escalations > 0
    m, st, gov, obs = _casc_pair(casc_setup, 10, deadline=0.001,
                                 governor=True)
    assert st.stats.escalations == 0
    assert gov.denied > 0 and gov.denied_deadline == gov.denied
    assert gov.allowed == 0
    assert m.summary()["completed"] == 10
    for rec in m.records.values():
        assert all(node < N0 for node in rec.tokens), rec.rid
    # the demotion is visible: recall spans carry denied=True
    denied = [ev for ev in obs.tracer.events
              if ev.kind == "recall" and dict(ev.data).get("denied")]
    assert denied
    cs = st.cascade_stats()
    assert cs["governor_denied"] == gov.denied
    assert cs["tokens_served"][1] == 0


def test_governor_stall_denial(casc_setup):
    """Escalating into a rung frozen by a scripted stall parks the
    request for the whole window — the governor refuses instead."""
    m, st, gov, obs = _casc_pair(casc_setup, 8, seed=9, governor=True,
                                 stalls=[(1, 0.0, 999.0)])
    assert m.summary()["completed"] == 8
    assert gov.denied_stall > 0
    assert st.stats.escalations == 0
    for rec in m.records.values():
        assert all(node < N0 for node in rec.tokens), rec.rid
    # the stall window edge was announced exactly once
    stalls = [ev for ev in obs.tracer.events if ev.kind == "rung_stall"]
    assert len(stalls) == 1 and stalls[0].model == 1


def test_governor_with_slack_allows_escalation(casc_setup):
    """Loose deadlines deny nothing: the governed serve is the baseline
    serve (denial is a pure function of budget, not a tax)."""
    m0, _, _, _ = _casc_pair(casc_setup, 10)
    m1, _, gov, _ = _casc_pair(casc_setup, 10, deadline=100.0,
                               governor=True)
    assert gov.denied == 0 and gov.allowed > 0
    for rid in m0.records:
        assert m0.records[rid].tokens == m1.records[rid].tokens, rid


def test_governor_unit_decisions():
    """The same four asks of both governors: equal decisions, equal
    stats, and the reference test's counts."""
    asks = (dict(deadline=None, catchup_cost=9.9),
            dict(deadline=1.0, catchup_cost=0.6),      # 2x0.6 > 1.0
            dict(deadline=1.0, catchup_cost=0.4),
            dict(deadline=None, catchup_cost=0.0, stalled=True))
    out = {}
    for pkg, p in PKG.items():
        gov = p["gov"](safety=2.0)
        out[pkg] = ([gov.allow_escalation(now=0.0, **kw) for kw in asks],
                    gov.stats())
    assert out["torch"] == out["jax"]
    assert out["torch"][0] == [True, False, True, False]
    assert out["torch"][1] == {"governor_allowed": 2, "governor_denied": 2,
                               "governor_denied_deadline": 1,
                               "governor_denied_stall": 1}


# --------------------------------------------------------------------------
# sliding-window reclamation and the page squeeze
# --------------------------------------------------------------------------

def _pool_state(pool):
    """Everything a reclaim or a squeeze can move, as plain values."""
    return dict(stats=pool.stats(), clipped=pool.clipped.tolist(),
                n_held=pool.n_held.tolist(), budget=pool.budget.tolist(),
                seq_len=pool.seq_len.tolist(), table=pool.table.tolist(),
                invariants=pool.check_invariants())


def _both(scenario):
    """Run ``scenario(pool_cls)`` on the reference's pool and the port's;
    their end states must be EQUAL.  Returns the port's pool."""
    jpool, tpool = scenario(JPool), scenario(KVPool)
    assert _pool_state(tpool) == _pool_state(jpool)
    return tpool


def test_reclaim_clips_sole_owner_history_only():
    def scenario(cls):
        pool = cls(n_lanes=2, page_size=2, lane_pages=8, n_pages=10,
                   reclaim_watermark=0.3)
        prompt = np.arange(6, dtype=np.int32)
        assert pool.reserve(prompt, 6)           # 6 pages worst-case
        pool.admit(0, prompt, 6, register_prefix=False)
        for _ in range(6):                       # decode to 6 held pages
            pool.prepare_step(np.array([True, False]))
            pool.note_written(np.array([True, False]))
        assert pool.n_held[0] == 6 and pool.budget[0] == 0
        assert pool.reserve(np.arange(100, 104, dtype=np.int32), 4)
        assert pool.clipped[0] == 1
        assert pool.reclaimed_pages == 1
        assert pool.n_held[0] == 5               # head page clipped off
        assert pool.check_invariants() == []
        pool.admit(1, np.arange(100, 104, dtype=np.int32), 4,
                   register_prefix=False)
        assert pool.check_invariants() == []
        return pool

    _both(scenario)


def test_reclaim_never_touches_pinned_or_prefix_pages():
    def scenario(cls):
        pool = cls(n_lanes=2, page_size=2, lane_pages=8, n_pages=8,
                   reclaim_watermark=0.3)
        prompt = np.arange(6, dtype=np.int32)
        assert pool.reserve(prompt, 2)
        pool.admit(0, prompt, 2)                 # registers prefix chain
        for _ in range(2):
            pool.prepare_step(np.array([True, False]))
            pool.note_written(np.array([True, False]))
        held_before = int(pool.n_held[0])
        chain = [int(p) for p in pool.table[0, :3]]
        refs = [pool.allocator.refcount(p) for p in chain]
        assert all(r >= 2 for r in refs)         # prefix-shared history
        assert not pool.reserve(prompt, 10)
        assert pool.reserve_failures == 1
        assert pool.clipped[0] == 0
        assert pool.reclaimed_pages == 0
        assert pool.n_held[0] == held_before
        assert [pool.allocator.refcount(p) for p in chain] == refs
        assert pool.check_invariants() == []
        return pool

    _both(scenario)


def test_reclaim_disabled_without_watermark():
    def scenario(cls):
        pool = cls(n_lanes=1, page_size=2, lane_pages=8, n_pages=6)
        prompt = np.arange(6, dtype=np.int32)
        assert pool.reserve(prompt, 4)
        pool.admit(0, prompt, 4, register_prefix=False)
        for _ in range(4):
            pool.prepare_step(np.array([True]))
            pool.note_written(np.array([True]))
        assert not pool.reserve(np.arange(10, 14, dtype=np.int32), 2)
        assert pool.clipped[0] == 0 and pool.reclaimed_pages == 0
        with pytest.raises(ValueError, match="reclaim_watermark"):
            cls(n_lanes=1, page_size=2, lane_pages=4,
                reclaim_watermark=1.5)
        return pool

    _both(scenario)


def test_squeeze_withholds_headroom_not_budget():
    def scenario(cls):
        pool = cls(n_lanes=2, page_size=2, lane_pages=4, n_pages=9)
        prompt = np.arange(4, dtype=np.int32)
        assert pool.reserve(prompt, 4)
        pool.admit(0, prompt, 4, register_prefix=False)
        pool.set_squeeze(4)                      # free 6 -> headroom 2
        assert not pool.reserve(np.arange(10, 16, dtype=np.int32), 2)
        assert pool.stats()["squeezed_pages"] == 4
        for _ in range(4):
            pool.prepare_step(np.array([True, False]))
            pool.note_written(np.array([True, False]))
        assert pool.check_invariants() == []
        pool.set_squeeze(0)
        assert pool.reserve(np.arange(10, 16, dtype=np.int32), 2)
        return pool

    _both(scenario)


# --------------------------------------------------------------------------
# terminal metrics
# --------------------------------------------------------------------------

def _terminal_metrics(metrics_cls, req_cls):
    m = metrics_cls(full_depth=5, n_lanes=2)
    m.t_start, m.t_end = 0.0, 10.0
    done = req_cls(rid=0, prompt=np.zeros(2, np.int32), max_tokens=2,
                   arrival=0.0, deadline=5.0)
    m.on_admit(done, 0.1)
    m.on_token(0, served_node=1, now=0.2, token=1)
    m.on_finish(0, 0.3)
    gone = req_cls(rid=1, prompt=np.zeros(2, np.int32), max_tokens=9,
                   arrival=0.0, cancel_at=1.0)
    m.on_admit(gone, 0.1)
    m.on_token(1, served_node=1, now=0.2, token=1)
    m.on_reap(gone, 1.0, "cancelled")
    late = req_cls(rid=2, prompt=np.zeros(2, np.int32), max_tokens=9,
                   arrival=0.0, deadline=2.0)
    m.on_reap(late, 2.0, "timed_out")
    return m, late


def test_metrics_terminal_accounting():
    m, late = _terminal_metrics(RuntimeMetrics, Request)
    s = m.summary(slo=1.0)
    assert s["completed"] == 1
    assert s["cancelled"] == 1 and s["timed_out"] == 1
    assert s["deadline_slack"]["p99"] == pytest.approx(4.7, abs=0.1)
    assert s["ttft"]["p99"] == pytest.approx(0.2)
    assert s["goodput_tok_s"] == pytest.approx(1 / 10.0)
    assert m.records[1].finished is None
    assert m.records[2].admitted is None
    ref, _ = _terminal_metrics(JMetrics, JRequest)
    assert s == ref.summary(slo=1.0)
    assert _records(m) == _records(ref)
    with pytest.raises(ValueError, match="unknown terminal status"):
        m.on_reap(late, 3.0, "exploded")


# --------------------------------------------------------------------------
# lossmap under faults
# --------------------------------------------------------------------------

def _emit_all(pkg, rows):
    tr = PKG[pkg]["obs"].SpanTracer()
    for kind, t, kw in rows:
        tr.emit(kind, t=t, **kw)
    return tr.events


def test_stall_decomposition_cancelled_and_stall_causes():
    rows = [
        ("queued", 0.0, {"rid": 1}),
        ("admitted", 1.0, {"rid": 1, "lane": 0}),
        ("cancel", 2.5, {"rid": 1, "lane": 0}),      # reaped pre-token
        ("queued", 0.0, {"rid": 2}),
        ("rung_stall", 1.0, {"model": 0, "t0": 1.0, "until": 3.0}),
        ("admitted", 4.0, {"rid": 2, "lane": 0}),
        ("token", 5.0, {"rid": 2, "lane": 0, "ttft": 5.0}),
        ("finish", 5.5, {"rid": 2, "lane": 0}),
    ]
    ds = {pkg: PKG[pkg]["lossmap"].stall_decomposition(_emit_all(pkg, rows))
          for pkg in PKG}
    assert ds["torch"] == ds["jax"]
    d = ds["torch"]
    assert d["stall_windows"] == [(1.0, 3.0)]
    r1 = d["requests"][1]
    assert r1["reaped"] and r1["ttft"] is None
    assert r1["buckets"]["cancelled"] == pytest.approx(0.0)
    assert r1["buckets"]["stall"] == pytest.approx(1.5)
    assert r1["buckets"]["queue_wait"] == pytest.approx(1.0)
    r2 = d["requests"][2]
    assert not r2["reaped"]
    assert r2["buckets"]["queue_wait"] == pytest.approx(2.0)
    assert r2["buckets"]["stall"] == pytest.approx(2.0)
    assert r2["buckets"]["prefill"] == pytest.approx(1.0)
    assert sum(r2["buckets"].values()) == pytest.approx(r2["ttft"])


def test_transient_windows_take_precedence_over_stalls():
    """Each second is charged exactly once: where a gear transient and a
    scripted stall overlap, the transient wins."""
    rows = [
        ("gear_switch", 0.0, {"src": 0, "dst": 1}),
        ("rung_stall", 0.5, {"model": 0, "t0": 0.5, "until": 2.0}),
        ("queued", 0.0, {"rid": 1}),
        ("admitted", 2.0, {"rid": 1, "lane": 0}),
        ("token", 2.5, {"rid": 1, "lane": 0, "ttft": 2.5}),
        ("finish", 3.0, {"rid": 1, "lane": 0}),
    ]
    ds = {pkg: PKG[pkg]["lossmap"].stall_decomposition(
        _emit_all(pkg, rows), gear_transient_s=1.0) for pkg in PKG}
    assert ds["torch"] == ds["jax"]
    b = ds["torch"]["requests"][1]["buckets"]
    assert b["gear_transient"] == pytest.approx(1.0)
    assert b["stall"] == pytest.approx(1.0)
    assert b["queue_wait"] == pytest.approx(0.0)
    assert sum(b.values()) == pytest.approx(
        ds["torch"]["requests"][1]["ttft"])


def test_goodput_lossmap_chaos_partition(sim_cascade):
    out = _chaos_obs(sim_cascade)
    lms = {}
    for pkg, (metrics, _, _, obs) in out.items():
        lm_mod = PKG[pkg]["lossmap"]
        s = metrics.summary()
        ceiling = lm_mod.sim_token_ceiling(3, 0.05, 0.01)
        lms[pkg] = (lm_mod.goodput_lossmap(
            obs.tracer.events, slo=0.5, duration=s["duration"],
            ceiling_tok_s=ceiling), ceiling, s,
            lm_mod.stall_decomposition(obs.tracer.events))
    assert lms["torch"] == lms["jax"]
    lm, ceiling, s, d = lms["torch"]
    assert lm["requests_reaped"] == s["cancelled"] + s["timed_out"]
    assert lm["requests_reaped"] > 0
    assert lm["loss_total_tok_s"] == pytest.approx(
        ceiling - lm["goodput_tok_s"])
    assert lm["goodput_tok_s"] <= lm["throughput_tok_s"] + 1e-9
    for c in tlossmap.STALL_CAUSES:
        assert c in lm["loss_tok_s"]
        assert lm["loss_tok_s"][c] >= 0.0
    assert lm["loss_tok_s"]["cancelled"] > 0.0
    for rid, row in d["requests"].items():
        if row["ttft"] is not None and not row["reaped"]:
            assert sum(row["buckets"].values()) == \
                pytest.approx(row["ttft"], abs=1e-9), rid


# --------------------------------------------------------------------------
# fault-plane ledger contracts (synthetic streams)
# --------------------------------------------------------------------------

def _feed(pkg, rows, ledger=None, **ledger_kw):
    o = PKG[pkg]["obs"]
    ledger = ledger or o.InvariantLedger(**ledger_kw)
    tr = o.SpanTracer()
    ledger.bind(tr)
    for kind, t, kw in rows:
        tr.emit(kind, t=t, **kw)
    return ledger


def _feed_both(rows, finalize=None, **ledger_kw):
    """The stream through each package's ledger (finalized at
    ``finalize`` when given); reports equal.  Returns the port's."""
    led = {pkg: _feed(pkg, rows, **ledger_kw) for pkg in PKG}
    if finalize is not None:
        for x in led.values():
            x.finalize(finalize)
    assert led["torch"].report() == led["jax"].report()
    return led["torch"]


def test_cancel_halts_stream_contract():
    led = _feed_both([
        ("queued", 0.0, {"rid": 1}),
        ("admitted", 0.5, {"rid": 1, "lane": 0}),
        ("token", 1.0, {"rid": 1, "lane": 0, "ttft": 1.0}),
        ("cancel", 1.5, {"rid": 1, "lane": 0}),
        ("token", 2.0, {"rid": 1, "lane": 0}),    # phantom emission
    ])
    assert led.n_violations["cancel_halts_stream"] == 1
    assert "after being reaped" in led.violations[0]["detail"]
    led2 = _feed_both([
        ("queued", 0.0, {"rid": 1}),
        ("admitted", 0.5, {"rid": 1, "lane": 0}),
        ("token", 1.0, {"rid": 1, "lane": 0, "ttft": 1.0}),
        ("deadline_miss", 1.5, {"rid": 1, "lane": 0}),
    ], finalize=2.0)
    assert led2.total_violations == 0
    led3 = _feed_both([
        ("queued", 0.0, {"rid": 1}),
        ("admitted", 0.5, {"rid": 1, "lane": 0}),
        ("cancel", 1.0, {"rid": 1, "lane": 0}),
        ("queued", 1.0, {"rid": 2}),
        ("admitted", 1.5, {"rid": 2, "lane": 0}),
        ("token", 2.0, {"rid": 2, "lane": 0, "ttft": 2.0}),
        ("finish", 2.5, {"rid": 2, "lane": 0}),
    ], finalize=3.0)
    assert led3.total_violations == 0


def test_cancel_releases_pages_contract():
    rows = [
        ("queued", 0.0, {"rid": 1}),
        ("admitted", 0.5, {"rid": 1, "lane": 0}),
        ("cancel", 1.0, {"rid": 1, "lane": 0}),
    ]
    reps = {}
    for pkg, p in PKG.items():
        pool = p["pool"](n_lanes=2, page_size=4, lane_pages=4, n_pages=9)
        assert pool.reserve(np.arange(4, dtype=np.int32), 4)
        pool.admit(0, np.arange(4, dtype=np.int32), 4)
        led = _feed(pkg, rows, pool=pool)       # lane 0 still holds!
        assert led.n_violations["cancel_releases_pages"] == 1
        assert "still holds" in led.violations[-1]["detail"]
        pool.release(0)     # released first (the server's reap order)
        led2 = _feed(pkg, rows, pool=pool)
        assert led2.n_violations["cancel_releases_pages"] == 0
        assert led2.checks["cancel_releases_pages"] == 1
        reps[pkg] = (led.report(), led2.report())
    assert reps["torch"] == reps["jax"]


def test_rung_stall_liveness_contract():
    led = _feed_both([
        ("escalate", 0.0, {"rid": 1, "model": 1}),
        ("rung_stall", 0.0, {"model": 1, "t0": 0.0, "until": 3.0}),
        ("esc_resolve", 7.0, {"rid": 1, "model": 1}),   # 7 <= 5 + 3
    ], finalize=8.0, horizon=5.0)
    assert led.n_violations["rung_stall_liveness"] == 0
    assert led.checks["rung_stall_liveness"] >= 1
    led2 = _feed_both([
        ("escalate", 0.0, {"rid": 1, "model": 1}),
        ("rung_stall", 0.0, {"model": 1, "t0": 0.0, "until": 3.0}),
        ("esc_resolve", 9.0, {"rid": 1, "model": 1}),   # 9 > 5 + 3
    ], horizon=5.0)
    assert led2.n_violations["rung_stall_liveness"] == 1
    led3 = _feed_both([
        ("escalate", 0.0, {"rid": 1, "model": 1}),
        ("rung_stall", 0.0, {"model": 0, "t0": 0.0, "until": 3.0}),
        ("esc_resolve", 7.0, {"rid": 1, "model": 1}),   # 7 > 5 + 0
    ], horizon=5.0)
    assert led3.n_violations["escalation_resolves"] == 1
    assert led3.n_violations["rung_stall_liveness"] == 0


def test_ledger_report_lists_fault_contracts():
    from benchmarks.check_trace import validate_ledger
    from repro.serving.obs.audit import CONTRACTS as JCONTRACTS
    from repro_torch.serving.obs.audit import CONTRACTS
    assert CONTRACTS == JCONTRACTS
    for c in ("cancel_halts_stream", "cancel_releases_pages",
              "rung_stall_liveness"):
        assert c in CONTRACTS
    rep = tobs.InvariantLedger().report()
    assert rep == jobs.InvariantLedger().report()
    for c in CONTRACTS:
        assert c in rep["contracts"]
    assert validate_ledger(json.loads(json.dumps(rep))) == []
    old = json.loads(json.dumps(rep))
    del old["contracts"]["cancel_halts_stream"]
    assert validate_ledger(old) != []


def test_perfetto_reaped_request_closes_span():
    docs = {}
    for pkg, p in PKG.items():
        tr = p["obs"].SpanTracer()
        tr.emit("queued", t=0.0, rid=5)
        tr.emit("admitted", t=1.0, rid=5, lane=0, sid=0)
        tr.emit("token", t=2.0, rid=5, lane=0, node=1, sid=0, ttft=2.0)
        tr.emit("cancel", t=3.0, rid=5, lane=0)
        docs[pkg] = p["export"].to_perfetto(tr.events)
    assert docs["torch"] == docs["jax"]
    doc = docs["torch"]
    [span] = [ev for ev in doc["traceEvents"] if ev["ph"] == "X"]
    assert span["name"] == "req 5 (cancel)"
    assert span["dur"] == pytest.approx(2e6)     # admit -> cancel, µs
    assert any(ev["ph"] == "i" and ev["name"] == "cancel"
               for ev in doc["traceEvents"])


# --------------------------------------------------------------------------
# the launcher's fault flags on the CPU
# --------------------------------------------------------------------------

def test_launcher_serves_faults_on_cpu(tmp_path, capsys):
    """``--faults`` (a scripted squeeze and deadlines) with seeded
    ``--cancel-rate`` and ``--deadline-ms`` on top, ``--kv-reclaim``
    armed: requests are reaped, the rest complete, the pool drains."""
    torch.set_num_threads(2)
    plan = FaultPlan(seed=0, deadline={0: 0.05}, squeezes=[(0.0, 0.3, 2)])
    plan.save(str(tmp_path / "plan.json"))
    run = tserve.main([
        "--smoke", "--device", "cpu", "--server", "--kv", "paged",
        "--paged-kernel", "--prefill-chunk", "8", "--page-size", "8",
        "--lanes", "2", "--rate", "8", "--duration", "1", "--tokens", "6",
        "--prompt-len", "12", "--faults", str(tmp_path / "plan.json"),
        "--cancel-rate", "0.5", "--deadline-ms", "400",
        "--kv-reclaim", "0.5"])
    out = capsys.readouterr().out
    s = run.metrics.summary()
    assert run.faults.deadline[0] == 0.05       # the script wins per rid
    assert len(run.faults.deadline) == len(run.requests)
    assert run.stepper.pool.reclaim_watermark == 0.5
    assert s["cancelled"] + s["timed_out"] > 0
    assert s["cancelled"] + s["timed_out"] + s["completed"] == \
        s["requests"]
    assert "deadline slack:" in out and "deadline-missed" in out
    for req in run.requests:
        rec = run.metrics.records[req.rid]
        assert rec.status != "completed" or rec.n_tokens == req.max_tokens
    _pool_clean(run.stepper.pool)


def test_launcher_cascade_governor_denies_into_a_stalled_rung(tmp_path):
    """``--cascade`` under a plan that stalls rung 1 for the whole serve:
    the governor denies every escalation (counted as stall denials in
    ``cascade_stats``), every request completes on rung 0, both pools
    drain; ``--no-governor`` serves the same plan without a governor."""
    torch.set_num_threads(2)
    FaultPlan(stalls=[(1, 0.0, 999.0)]).save(str(tmp_path / "plan.json"))
    argv = ["--smoke", "--device", "cpu", "--cascade",
            "paper-ee-100m:paper-ee-100m", "--paged-kernel",
            "--prefill-chunk", "8", "--page-size", "8", "--policy",
            "skip_recall", "--lanes", "2", "--cascade-lanes", "1",
            "--rate", "4", "--duration", "1", "--tokens", "4",
            "--prompt-len", "10", "--cache-len", "32", "--faults",
            str(tmp_path / "plan.json")]
    run = tserve.main(argv)
    cs = run.cascade_stats
    assert cs["governor_denied_stall"] > 0
    assert cs["governor_denied"] == cs["governor_denied_stall"]
    assert cs["escalations"] == 0 and cs["tokens_served"][1] == 0
    for req in run.requests:
        assert run.metrics.records[req.rid].n_tokens == req.max_tokens
    for st in run.stepper.steppers:
        _pool_clean(st.pool)
    assert tserve.main(argv + ["--no-governor", "--duration", "0.3"]) \
        .stepper.governor is None


def test_launcher_fault_flags_follow_the_reference():
    """The fault and control flags, defaults and refusals of the
    reference launcher."""
    args = tserve.parse_args([])
    assert (args.deadline_ms, args.cancel_rate, args.faults,
            args.kv_reclaim, args.no_governor) == (None, 0.0, None, None,
                                                   False)
    assert (args.adaptive, args.recal_interval) == (False, None)
    assert args.gears == "quality:0.95,balanced:0.92,turbo:0.75"
    assert tserve.parse_args(["--adaptive"]).server
    with pytest.raises(SystemExit, match="separate"):
        tserve.parse_args(["--adaptive", "--cascade", "a:b"])
    specs = tserve.parse_gears("quality:0.95, 0.8")
    assert [(g.name, g.lam) for g in specs] == [("quality", 0.95),
                                                ("g0.8", 0.8)]
    with pytest.raises(SystemExit, match="names no gears"):
        tserve.parse_gears(" , ")
