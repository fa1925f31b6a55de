"""The port's observability plane (repro_torch.serving.obs) against the
JAX package's (repro.serving.obs): a mirror of every test of
tests/serving/test_obs.py, test_audit.py and test_regret.py but the soak
smoke (its `benchmarks.soak` leg imports the JAX package), each run on
BOTH packages on the same fixtures:

  * the same numpy traces (`ee_like_traces` on ``default_rng(0)``), the
    reference's calibrated `Cascade` and its line and skip tables
    bridged into the port, the same seeded workloads;
  * every result is asserted EQUAL between the packages — span,
    decision and regret digests (and the reference's pinned
    ``GOLDEN_SPAN_DIGEST`` / ``GOLDEN_REGRET_DIGEST``), events
    documents as dicts, ledger reports, loss maps, Pareto documents,
    flight-bundle triggers, Prometheus text and report lines;
  * every artifact the port writes passes the reference's
    `benchmarks.check_trace` validators (a test may import them; the
    port does not).

The port's steppers decide on the CPU here (``device="cpu"``).
"""

import json
import types

import jax
import numpy as np
import pytest
import torch

from repro import strategy as jstrategy
from repro.core import traces
from repro.serving import obs as jobs
from repro.serving import runtime as jrt
from repro.serving.kvpool import KVPool as JPool
from repro.serving.obs import export as jexport
from repro.serving.obs import lossmap as jlossmap
from repro.serving.obs import regret as jregret
from repro.serving.obs import replay as jreplay
from repro.serving.obs import report as jreport
from repro.serving.runtime.metrics import RuntimeMetrics as JMetrics
from repro.serving.runtime.request import Request as JRequest
from repro.serving.runtime.workload import WorkloadSpec as JSpec
from repro_torch import strategy as tstrategy
from repro_torch.bridge import (chain_from_numpy, line_tables_from_numpy,
                                skip_tables_from_numpy, support_from_numpy,
                                to_tensor)
from repro_torch.serving import obs as tobs
from repro_torch.serving import runtime as trt
from repro_torch.serving.kvpool import KVPool
from repro_torch.serving.obs import export as texport
from repro_torch.serving.obs import lossmap as tlossmap
from repro_torch.serving.obs import regret as tregret
from repro_torch.serving.obs import replay as treplay
from repro_torch.serving.obs import report as treport
from repro_torch.serving.runtime.metrics import RuntimeMetrics
from repro_torch.serving.runtime.request import Request
from repro_torch.serving.runtime.workload import WorkloadSpec

N_NODES = 5
# the reference's pinned digests (tests/serving/test_obs.py and
# test_regret.py): the port's seeded sim serves must reproduce them
GOLDEN_SPAN_DIGEST = \
    "0359a77e7d911ca1da679fef18393ddf3d14a950eb0ed60c4cb2a542f47650aa"
GOLDEN_REGRET_DIGEST = \
    "c7d84c6624bc519d8efcf9dd0a1a266d3510f7c14abe224fffae9dbe68c78e32"

J = types.SimpleNamespace(
    name="jax", rt=jrt, strategy=jstrategy, obs=jobs, export=jexport,
    lossmap=jlossmap, regret=jregret, replay=jreplay, report=jreport,
    Pool=JPool, Request=JRequest, Spec=JSpec, Metrics=JMetrics, kw={})
T = types.SimpleNamespace(
    name="torch", rt=trt, strategy=tstrategy, obs=tobs, export=texport,
    lossmap=tlossmap, regret=tregret, replay=treplay, report=treport,
    Pool=KVPool, Request=Request, Spec=WorkloadSpec, Metrics=RuntimeMetrics,
    kw={"device": "cpu"})
PKGS = (J, T)


def _bridge(jcasc):
    """The port's `Cascade` holding the reference's fitted spec with its
    line tables and its cumulative skip tables (the regret oracle's)."""
    tree = lambda x: jax.tree.map(np.asarray, x)   # noqa: E731
    tcasc = tstrategy.Cascade(
        support=support_from_numpy(tree(jcasc.support)),
        chain=chain_from_numpy(tree(jcasc.chain)),
        costs=to_tensor(np.asarray(jcasc.costs)), lam=jcasc.lam,
        line_tables=line_tables_from_numpy(tree(jcasc.solve_line())))
    tcasc.skip_tables = skip_tables_from_numpy(
        tree(jcasc.solve_skip("cumulative")))
    tcasc.edge_costs = np.asarray(jcasc.edge_costs)
    tcasc.skip_mode = "cumulative"
    return tcasc


@pytest.fixture(scope="module")
def sim_cascade():
    """{package: (cascade, trace bank)} on the reference's fixture."""
    torch.set_num_threads(2)
    rng = np.random.default_rng(0)
    losses, _, flops = traces.ee_like_traces(rng, 3_000, N_NODES)
    jcasc = jstrategy.Cascade.from_traces(losses[:1_500], 0.4 * flops,
                                          k=12, lam=0.6)
    bank = losses[1_500:]
    return {"jax": (jcasc, bank), "torch": (_bridge(jcasc), bank)}


def _workload(P, seed=11, rate=4.0, duration=10.0):
    spec = P.Spec(rate=rate, duration=duration, prompt_len=4,
                  max_tokens=(2, 9), seed=seed)
    return P.rt.make_workload("poisson", spec)


def _serve(P, casc, bank, requests, *, obs="tracer", lanes=3, pool=None,
           stepper_cls=None, policy="recall_index", slo=5.0):
    """A sim serve of package ``P`` (test_obs's `_traced_serve`,
    test_audit's and test_regret's `_serve` in one)."""
    if policy == "norecall_threshold":
        def mk(name, lam):
            return P.strategy.make("norecall_threshold", casc,
                                   threshold=0.45, lam=1.0)
    else:
        mk = P.rt.cascade_factory(casc)
    strategies, sid_of = P.rt.build_bank(requests, mk, (policy, None))
    kw = dict(P.kw)
    if pool is not None:
        kw["pool"] = pool
    stepper = (stepper_cls or P.rt.SimStepper)(
        strategies, bank, n_lanes=lanes, seg_time=0.05, overhead=0.01,
        **kw)
    if obs == "tracer":
        obs = P.obs.Observability()
    server = P.rt.Server(stepper, P.rt.LaneScheduler(lanes), sid_of,
                         slo=slo, obs=obs)
    with torch.no_grad():
        return server.serve(requests), obs


def _both(sim_cascade, fn):
    """``fn(P, casc, bank)`` on each package: {name: result}."""
    return {P.name: fn(P, *sim_cascade[P.name]) for P in PKGS}


def _json(doc):
    return json.loads(json.dumps(doc, default=float))


def _records(metrics):
    return {rid: (r.tokens, r.n_tokens, r.ttft, r.finished)
            for rid, r in sorted(metrics.records.items())}


# --------------------------------------------------------------------------
# test_obs.py: tracing is a pure observer; the trace is deterministic
# --------------------------------------------------------------------------

def test_tracing_on_off_identical_streams(sim_cascade):
    def run(P, casc, bank):
        requests = _workload(P)
        m_off, _ = _serve(P, casc, bank, requests, obs=None)
        m_on, obs = _serve(P, casc, bank, requests)
        assert _records(m_on) == _records(m_off)
        assert obs.tracer.n_emitted > 0
        return _records(m_on), obs.tracer.n_emitted
    out = _both(sim_cascade, run)
    assert out["torch"] == out["jax"]


def test_span_digest_golden_and_reproducible(sim_cascade):
    def run(P, casc, bank):
        _, o1 = _serve(P, casc, bank, _workload(P))
        _, o2 = _serve(P, casc, bank, _workload(P))
        assert o1.tracer.span_digest() == o2.tracer.span_digest()
        assert o1.tracer.dropped == 0
        return o1.tracer.span_digest(), o1.tracer.decision_digest()
    out = _both(sim_cascade, run)
    assert out["torch"] == out["jax"]
    assert out["torch"][0] == GOLDEN_SPAN_DIGEST


def test_decision_digest_arrival_order_invariant(sim_cascade):
    def run(P, casc, bank):
        base = [P.Request(rid=rid, prompt=np.zeros(4, np.int32),
                          max_tokens=3 + rid % 5, arrival=0.0)
                for rid in range(8)]
        staggered = [P.Request(rid=r.rid, prompt=r.prompt,
                               max_tokens=r.max_tokens,
                               arrival=float((7 - r.rid) * 0.3))
                     for r in base]
        _, o1 = _serve(P, casc, bank, base, lanes=2)
        _, o2 = _serve(P, casc, bank, staggered, lanes=2)
        assert o1.tracer.decision_digest() == o2.tracer.decision_digest()
        return (o1.tracer.decision_digest(), o1.tracer.span_digest(),
                o2.tracer.span_digest())
    out = _both(sim_cascade, run)
    assert out["torch"] == out["jax"]


def test_request_span_lifecycle(sim_cascade):
    def run(P, casc, bank):
        requests = _workload(P)
        metrics, obs = _serve(P, casc, bank, requests)
        rid = requests[0].rid
        span = obs.tracer.request_span(rid)
        kinds = [ev.kind for ev in span]
        assert kinds[0] == "queued" and kinds[1] == "admitted"
        assert kinds[-1] == "finish"
        tokens = [ev for ev in span if ev.kind == "token"]
        assert len(tokens) == metrics.records[rid].n_tokens
        first = dict(tokens[0].data)
        assert first.get("ttft") == pytest.approx(metrics.records[rid].ttft)
        assert all("loss" in dict(ev.data) for ev in tokens)
        ts = [ev.t for ev in span]
        assert ts == sorted(ts)
        return [ev.as_dict() for ev in span]
    out = _both(sim_cascade, run)
    assert out["torch"] == out["jax"]


def test_tracer_ring_and_span_bounds():
    out = {}
    for P in PKGS:
        tr = P.obs.SpanTracer(capacity=8, span_events=3, keep_finished=1)
        for i in range(20):
            tr.emit("token", t=float(i), rid=7, lane=0, node=1, sid=0)
        assert len(tr.events) == 8 and tr.dropped == 12
        assert len(tr.request_span(7)) == 3
        assert tr.span_dropped(7) == 17
        tr.emit("finish", t=21.0, rid=7)
        tr.emit("queued", t=22.0, rid=8)
        tr.emit("finish", t=23.0, rid=8)
        assert tr.request_span(8) and not tr.request_span(7)
        s = tr.stats()
        assert s["emitted"] == 23 and s["finished_spans"] == 1
        out[P.name] = (s, tr.span_digest(), tr.decision_digest())
    assert out["torch"] == out["jax"]


# --------------------------------------------------------------------------
# test_obs.py: flight recorder
# --------------------------------------------------------------------------

def _gated(P, block_rids, blocks):
    """P's SimStepper with a scripted admission gate: refuses the first
    ``blocks`` reservations of each rid in ``block_rids``."""

    class Gated(P.rt.SimStepper):
        def alloc(self):
            super().alloc()
            self._denied = {rid: blocks for rid in block_rids}

        def reserve(self, req):
            left = self._denied.get(req.rid, 0)
            if left > 0:
                self._denied[req.rid] = left - 1
                return False
            return True

    return Gated


def test_flight_page_exhaustion_dumps_bundle(sim_cascade, tmp_path):
    def run(P, casc, bank):
        requests = [
            P.Request(rid=0, prompt=np.zeros(4, np.int32), max_tokens=9,
                      arrival=0.0),
            P.Request(rid=1, prompt=np.zeros(4, np.int32), max_tokens=3,
                      arrival=0.0)]
        out_dir = tmp_path / P.name
        flight = P.obs.FlightRecorder(out_dir=str(out_dir), page_burst=3)
        obs = P.obs.Observability(flight=flight)
        metrics, _ = _serve(P, casc, bank, requests, lanes=2, obs=obs,
                            stepper_cls=_gated(P, (1,), 4))
        assert all(metrics.records[r.rid].finished is not None
                   for r in requests)
        assert [b["trigger"] for b in flight.bundles] == ["page_exhaustion"]
        bundle = flight.bundles[0]
        assert bundle["rid"] == 1 and bundle["detail"]["streak"] == 3
        kinds = [ev["kind"] for ev in bundle["request_span"]]
        assert kinds[0] == "queued" and kinds.count("page_blocked") >= 3
        assert bundle["metrics"]["requests"] == 1
        [path] = flight.dump_paths
        with open(path) as f:
            on_disk = json.load(f)
        assert on_disk["schema"] == "flight_bundle/v1"
        assert on_disk["trigger"] == "page_exhaustion"
        assert flight.stats()["triggers"] == {"page_exhaustion": 1}
        from benchmarks.check_trace import validate_bundle
        assert validate_bundle(on_disk) == []
        return {k: v for k, v in on_disk.items() if k != "metrics"}
    out = _both(sim_cascade, run)
    assert out["torch"] == out["jax"]


def _bound_pair(P, **kw):
    tr = P.obs.SpanTracer()
    fl = P.obs.FlightRecorder(**kw)
    fl.bind(tr)
    return tr, fl


def test_flight_slo_burst_trigger_and_cap():
    out = {}
    for P in PKGS:
        tr, fl = _bound_pair(P, slo=0.1, slo_burst=3, max_bundles_per_kind=1)
        for i in range(3):
            tr.emit("token", t=float(i), rid=i, ttft=0.5, node=0, sid=0)
        assert [b["trigger"] for b in fl.bundles] == ["slo_burst"]
        assert fl.bundles[0]["detail"]["streak"] == 3
        tr.emit("token", t=3.0, rid=9, ttft=0.01, node=0, sid=0)
        assert fl._slo_streak == 0
        for i in range(6):
            tr.emit("token", t=4.0 + i, rid=i, ttft=0.5, node=0, sid=0)
        assert len(fl.bundles) == 1
        out[P.name] = (fl.bundles, fl.stats())
    assert out["torch"] == out["jax"]


def test_flight_gear_thrash_trigger():
    out = {}
    for P in PKGS:
        tr, fl = _bound_pair(P, thrash_count=3, thrash_window=10.0)
        tr.emit("gear_switch", t=0.0, src=0, dst=1)
        tr.emit("gear_switch", t=20.0, src=1, dst=0)
        tr.emit("gear_switch", t=21.0, src=0, dst=1)
        assert not fl.bundles
        tr.emit("gear_switch", t=22.0, src=1, dst=0)
        assert [b["trigger"] for b in fl.bundles] == ["gear_thrash"]
        assert fl.bundles[0]["detail"]["switches"] == 3
        out[P.name] = fl.bundles
    assert out["torch"] == out["jax"]


def test_flight_stuck_waiter_trigger_and_grant_clears():
    out = {}
    for P in PKGS:
        tr, fl = _bound_pair(P, stuck_after=5.0)
        tr.emit("esc_wait", t=0.0, rid=3, model=1)
        tr.emit("esc_grant", t=1.0, rid=3, model=1, lane=0)
        tr.emit("counter", t=10.0, queue=0)
        assert not fl.bundles
        tr.emit("esc_wait", t=10.0, rid=4, model=1)
        tr.emit("counter", t=16.0, queue=0)
        assert [b["trigger"] for b in fl.bundles] == ["stuck_waiter"]
        assert fl.bundles[0]["rid"] == 4
        assert fl.bundles[0]["detail"]["waited_s"] == pytest.approx(6.0)
        out[P.name] = fl.bundles
    assert out["torch"] == out["jax"]


# --------------------------------------------------------------------------
# test_obs.py: metrics registry + bounded runtime records
# --------------------------------------------------------------------------

def test_registry_absorb_labels_and_prometheus(tmp_path):
    from benchmarks.check_trace import validate_metrics
    out = {}
    for P in PKGS:
        reg = P.obs.MetricsRegistry()
        reg.absorb("runtime", {"tokens": 41, "ttft": {"p50": 0.018},
                               "note": "skipped", "flag": True,
                               "hist": [1, 2, 3]})
        reg.absorb("kv_pool", {"pages_peak": 9}, model="small")
        reg.counter("serve_errors").inc()
        reg.histogram("step_seconds").observe(0.004)
        reg.describe("serve_errors", "errors served")
        snap = reg.snapshot()
        assert snap["runtime_tokens"] == 41.0
        assert snap["runtime_ttft_p50"] == pytest.approx(0.018)
        assert snap["runtime_flag"] == 1.0
        assert snap["runtime_hist_1"] == 2.0
        assert snap['kv_pool_pages_peak{model="small"}'] == 9.0
        assert "runtime_note" not in snap
        assert reg.value("kv_pool_pages_peak", model="small") == 9.0
        assert reg.value("missing", default=-1.0) == -1.0
        assert reg.labelsets("kv_pool_pages_peak") == [{"model": "small"}]
        text = reg.prometheus_text()
        assert "# TYPE serve_errors counter" in text
        assert 'kv_pool_pages_peak{model="small"} 9' in text
        assert 'step_seconds_bucket{le="+Inf"} 1' in text
        path = tmp_path / f"m_{P.name}.json"
        doc = reg.to_json(str(path), extra={"leg": "unit"})
        assert validate_metrics(doc) == []
        with open(path) as f:
            assert validate_metrics(json.load(f)) == []
        out[P.name] = (snap, text, _json(doc))
    assert out["torch"] == out["jax"]


def test_metrics_to_json_bounds_records(tmp_path):
    out = {}
    for P in PKGS:
        m = P.Metrics(full_depth=4, n_lanes=2)
        m.t_start, m.t_end = 0.0, 10.0
        for rid in range(10):
            req = P.Request(rid=rid, prompt=np.zeros(2, np.int32),
                            max_tokens=1, arrival=float(rid))
            m.on_admit(req, float(rid))
            m.on_token(rid, served_node=1, now=rid + 0.5, token=1)
            m.on_finish(rid, rid + 0.5)
        path = tmp_path / f"r_{P.name}.json"
        doc = m.to_json(str(path), slo=1.0, max_records=4)
        assert len(doc["requests"]) == 4
        assert doc["requests_dropped"] == 6
        assert sorted(r["rid"] for r in doc["requests"]) == [6, 7, 8, 9]
        full = m.to_json(str(path), slo=1.0, max_records=None)
        assert len(full["requests"]) == 10
        assert full["requests_dropped"] == 0
        out[P.name] = (_json(doc), _json(full))
    assert out["torch"] == out["jax"]


# --------------------------------------------------------------------------
# test_obs.py: export + attribution
# --------------------------------------------------------------------------

def test_perfetto_export_structure_and_validator(sim_cascade, tmp_path):
    from benchmarks.check_trace import validate_trace

    def run(P, casc, bank):
        requests = _workload(P)
        _, obs = _serve(P, casc, bank, requests)
        path = tmp_path / f"trace_{P.name}.json"
        doc = P.export.write_trace(obs.tracer, str(path), title="unit serve")
        assert validate_trace(doc) == []
        with open(path) as f:
            on_disk = json.load(f)
        assert validate_trace(on_disk) == []
        spans = [ev for ev in doc["traceEvents"] if ev["ph"] == "X"]
        assert len(spans) == len(requests)
        assert all(ev["pid"] == 0 and ev["dur"] >= 0 for ev in spans)
        phases = {ev["ph"] for ev in doc["traceEvents"]}
        assert {"C", "i"} <= phases
        assert doc["otherData"]["events_dropped"] == 0
        return on_disk
    out = _both(sim_cascade, run)
    assert out["torch"] == out["jax"]


def test_perfetto_open_span_for_unfinished_request():
    out = {}
    for P in PKGS:
        tr = P.obs.SpanTracer()
        tr.emit("admitted", t=1.0, rid=5, lane=2, sid=0)
        tr.emit("token", t=2.0, rid=5, lane=2, node=1, sid=0)
        doc = P.export.to_perfetto(tr.events)
        [span] = [ev for ev in doc["traceEvents"] if ev["ph"] == "X"]
        assert span["name"] == "req 5 (open)" and span["args"]["open"]
        assert span["ts"] == 1e6 and span["dur"] == 1e6
        out[P.name] = doc
    assert out["torch"] == out["jax"]


def test_decision_attribution_accounts_every_token(sim_cascade):
    def run(P, casc, bank):
        metrics, obs = _serve(P, casc, bank, _workload(P))
        rows = P.obs.decision_attribution(obs.tracer.events,
                                          gear_of=lambda sid: f"gear{sid}")
        assert sum(r["tokens"] for r in rows) == \
            sum(rec.n_tokens for rec in metrics.records.values())
        assert all(r["gear"] == "gear0" for r in rows)
        assert all(r["latency_sum_s"] >= 0.0 for r in rows)
        assert all(r["served_loss_mean"] is not None for r in rows)
        assert len({r["node"] for r in rows}) > 1
        return rows
    out = _both(sim_cascade, run)
    assert out["torch"] == out["jax"]


# --------------------------------------------------------------------------
# test_obs.py: report rendering
# --------------------------------------------------------------------------

def test_serve_report_renders_from_registry():
    out = {}
    for P in PKGS:
        rep = P.report.ServeReport()
        rep.add_runtime({"completed": 3, "requests": 4, "tokens": 41,
                         "duration": 1.5, "throughput_tok_s": 27.3,
                         "throughput_req_s": 2.0,
                         "ttft": {"p50": 0.018, "p95": 0.03, "p99": 0.04},
                         "token_latency": {"p50": 0.004, "p95": 0.01,
                                           "p99": 0.014},
                         "goodput_tok_s": 27.3, "slo_attainment": 1.0},
                        slo_ms=1000.0)
        rep.add_pool({"pages_peak": 9, "n_pages": 13,
                      "prefix_hit_rate": 0.5, "shared_tokens": 12,
                      "cow_splits": 1, "evictions": 0, "grows": 0,
                      "reserve_failures": 2})
        lines = rep.lines()
        assert lines[0] == "completed 3/4 requests, 41 tokens in 1.50s"
        assert any(ln.startswith("goodput (ttft<=1000ms): 27.3 tok/s")
                   for ln in lines)
        [pool_line] = [ln for ln in lines if ln.startswith("kv pool:")]
        assert "peak 9/12 pages" in pool_line
        assert "2 blocked admissions" in pool_line
        assert rep.registry.value("kv_pool_reserve_failures") == 2.0
        out[P.name] = (lines, rep.registry.snapshot())
    assert out["torch"] == out["jax"]


# --------------------------------------------------------------------------
# test_audit.py: the ledger over real serves
# --------------------------------------------------------------------------

def _pool(P):
    return P.Pool(n_lanes=3, page_size=4, lane_pages=8, n_pages=16)


def test_ledger_clean_pool_gated_serve(sim_cascade, tmp_path):
    from benchmarks.check_trace import validate_ledger

    def run(P, casc, bank):
        ledger = P.obs.InvariantLedger()
        obs = P.obs.Observability(ledger=ledger)
        _serve(P, casc, bank, _workload(P), obs=obs, pool=_pool(P))
        rep = ledger.report()
        assert rep["schema"] == "ledger_report/v1"
        assert rep["total_violations"] == 0, rep["violations"]
        assert rep["finalized"] and rep["mode"] == "live"
        for c in ("lane_conservation", "ttft_exactly_once",
                  "page_conservation", "admission_never_drop"):
            assert rep["contracts"][c]["checks"] > 0, c
            assert rep["contracts"][c]["verdict"] == "pass"
        assert validate_ledger(_json(rep)) == []
        return rep
    out = _both(sim_cascade, run)
    assert out["torch"] == out["jax"]


def test_audited_serve_is_pure_observer(sim_cascade):
    def run(P, casc, bank):
        requests = _workload(P)
        m_off, _ = _serve(P, casc, bank, requests, obs=None, pool=_pool(P))
        obs = P.obs.Observability(ledger=P.obs.InvariantLedger(),
                                  flight=P.obs.FlightRecorder())
        m_on, _ = _serve(P, casc, bank, requests, obs=obs, pool=_pool(P))
        assert _records(m_on) == _records(m_off)
        for rid in m_off.records:
            assert m_on.records[rid].served_depth_sum == \
                m_off.records[rid].served_depth_sum, rid
        return _records(m_on), obs.tracer.span_digest()
    out = _both(sim_cascade, run)
    assert out["torch"] == out["jax"]


# --------------------------------------------------------------------------
# test_audit.py: per-contract synthetic violations
# --------------------------------------------------------------------------

def _feed(P, rows, **ledger_kw):
    ledger = P.obs.InvariantLedger(**ledger_kw)
    tr = P.obs.SpanTracer()
    ledger.bind(tr)
    for kind, t, kw in rows:
        tr.emit(kind, t=t, **kw)
    return ledger


def _feed_both(rows, **ledger_kw):
    """The same stream through each package's ledger; the reports must
    be equal.  Returns the port's ledger."""
    led = {P.name: _feed(P, rows, **ledger_kw) for P in PKGS}
    assert led["torch"].report() == led["jax"].report()
    return led["torch"]


def test_lane_conservation_double_occupancy():
    led = _feed_both([
        ("queued", 0.0, {"rid": 1}),
        ("queued", 0.0, {"rid": 2}),
        ("admitted", 1.0, {"rid": 1, "lane": 0}),
        ("admitted", 2.0, {"rid": 2, "lane": 0}),
    ])
    assert led.n_violations["lane_conservation"] == 1
    assert "still holding rid 1" in led.violations[0]["detail"]


def test_lane_conservation_token_before_admission():
    led = _feed_both([("token", 1.0, {"rid": 5, "lane": 0, "ttft": 1.0})])
    assert led.n_violations["lane_conservation"] == 1


def test_ttft_exactly_once_contract():
    led = _feed_both([
        ("queued", 0.0, {"rid": 1}),
        ("admitted", 0.5, {"rid": 1, "lane": 0}),
        ("token", 1.0, {"rid": 1, "lane": 0, "ttft": 1.0}),
        ("token", 2.0, {"rid": 1, "lane": 0, "ttft": 2.0}),
    ])
    assert led.n_violations["ttft_exactly_once"] == 1
    led2 = _feed_both([
        ("queued", 0.0, {"rid": 1}),
        ("admitted", 0.5, {"rid": 1, "lane": 0}),
        ("token", 1.0, {"rid": 1, "lane": 0}),
    ])
    assert led2.n_violations["ttft_exactly_once"] == 1


def test_escalation_horizon_and_finalize():
    rows = [
        ("escalate", 0.0, {"rid": 1, "model": 1}),
        ("counter", 10.0, {"queue": 0}),
        ("escalate", 11.0, {"rid": 2, "model": 1}),
    ]
    led = {}
    for P in PKGS:
        led[P.name] = _feed(P, rows, horizon=5.0)
        assert led[P.name].n_violations["escalation_resolves"] == 1
        led[P.name].finalize(12.0)
        assert led[P.name].n_violations["escalation_resolves"] == 2
    assert led["torch"].report() == led["jax"].report()
    rows2 = [
        ("escalate", 0.0, {"rid": 1, "model": 1}),
        ("esc_resolve", 1.0, {"rid": 1, "model": 1}),
    ]
    reps = {}
    for P in PKGS:
        led2 = _feed(P, rows2, horizon=5.0)
        led2.finalize(2.0)
        assert led2.n_violations["escalation_resolves"] == 0
        assert led2.checks["escalation_resolves"] == 1
        reps[P.name] = led2.report()
    assert reps["torch"] == reps["jax"]


def test_walk_floor_monotonic_under_commit():
    led = _feed_both([
        ("queued", 0.0, {"rid": 1}),
        ("admitted", 0.5, {"rid": 1, "lane": 0}),
        ("token", 1.0, {"rid": 1, "lane": 0, "ttft": 1.0, "node": 1}),
        ("token", 2.0, {"rid": 1, "lane": 0, "node": 3}),
        ("token", 3.0, {"rid": 1, "lane": 0, "node": 0}),
    ], policy="commit", boundaries=(2, 3))
    assert led.n_violations["walk_floor_monotonic"] == 1
    led2 = _feed_both([
        ("queued", 0.0, {"rid": 1}),
        ("admitted", 0.5, {"rid": 1, "lane": 0}),
        ("token", 1.0, {"rid": 1, "lane": 0, "ttft": 1.0, "node": 3}),
        ("token", 2.0, {"rid": 1, "lane": 0, "node": 0}),
    ], policy="recall", boundaries=(2, 3))
    assert led2.n_violations["walk_floor_monotonic"] == 0


def test_admission_never_drop_at_finalize():
    rows = [
        ("queued", 0.0, {"rid": 1}),
        ("queued", 0.0, {"rid": 2}),
        ("admitted", 0.5, {"rid": 2, "lane": 0}),
    ]
    reps = {}
    for P in PKGS:
        led = _feed(P, rows)
        led.finalize(9.0)
        assert led.n_violations["admission_never_drop"] == 2
        assert led.report()["contracts"]["admission_never_drop"][
            "verdict"] == "violated"
        reps[P.name] = led.report()
    assert reps["torch"] == reps["jax"]


def test_violation_freezes_flight_bundle(tmp_path):
    from benchmarks.check_trace import validate_bundle
    rows = [
        ("queued", 0.0, {"rid": 7}),
        ("admitted", 0.5, {"rid": 7, "lane": 0}),
        ("token", 1.0, {"rid": 7, "lane": 0, "ttft": 1.0}),
        ("token", 2.0, {"rid": 7, "lane": 1, "ttft": 2.0}),
    ]
    out = {}
    for P in PKGS:
        led = _feed(P, rows, out_dir=str(tmp_path / P.name))
        assert led.total_violations >= 1
        bundle = led.bundles[0]
        assert bundle["schema"] == "flight_bundle/v1"
        assert bundle["trigger"].startswith("ledger:")
        assert bundle["rid"] == 7
        assert [e["kind"] for e in bundle["request_span"]][0] == "queued"
        assert led.dump_paths
        with open(led.dump_paths[0]) as f:
            on_disk = json.load(f)
        assert validate_bundle(on_disk) == []
        out[P.name] = (led.bundles, on_disk)
    assert out["torch"] == out["jax"]


def test_pool_check_invariants_catches_tampering():
    out = {}
    for P in PKGS:
        pool = _pool(P)
        assert pool.check_invariants() == []
        assert pool.reserve(np.arange(4, dtype=np.int32), 8)
        pool.admit(0, np.arange(4, dtype=np.int32), 8)
        assert pool.check_invariants() == []
        pool.allocator._ref[int(pool.table[0][0])] += 1
        out[P.name] = pool.check_invariants()
        assert out[P.name] != []
    assert out["torch"] == out["jax"]


# --------------------------------------------------------------------------
# test_audit.py: replay
# --------------------------------------------------------------------------

def test_replay_roundtrip_and_divergence(sim_cascade):
    def run(P, casc, bank):
        requests = _workload(P)
        _, obs = _serve(P, casc, bank, requests, pool=_pool(P))
        doc = _json(P.export.events_doc(obs.tracer))
        rebuilt = P.replay.workload_from_events(
            P.replay.events_from_doc(doc))
        by_rid = {r.rid: r for r in rebuilt}
        assert set(by_rid) == {r.rid for r in requests}
        for r in requests:
            b = by_rid[r.rid]
            assert b.arrival == r.arrival and b.max_tokens == r.max_tokens
            assert np.array_equal(np.asarray(r.prompt, np.int32), b.prompt)

        def reserve(reqs):
            return _serve(P, casc, bank, reqs, pool=_pool(P))[1]

        res = P.replay.replay(doc, reserve)
        assert res.ok, res.mismatches
        assert res.span_digest == doc["span_digest"]
        assert res.decision_digest == doc["decision_digest"]

        def diverge(reqs):
            return _serve(P, casc, bank, reqs, lanes=2)[1]

        bad = P.replay.replay(doc, diverge)
        assert not bad.ok and bad.mismatches
        return doc, res.summary(), bad.summary()
    out = _both(sim_cascade, run)
    assert out["torch"] == out["jax"]


def test_replay_from_perfetto_decision_digest(sim_cascade):
    def run(P, casc, bank):
        requests = _workload(P)
        _, obs = _serve(P, casc, bank, requests)
        doc = P.export.to_perfetto(obs.tracer.events)
        doc["otherData"] = {"events_dropped": obs.tracer.dropped,
                            "decision_digest": obs.tracer.decision_digest()}
        doc = _json(doc)
        rebuilt = P.replay.workload_from_perfetto(doc)
        assert {r.rid for r in rebuilt} == {r.rid for r in requests}
        by_rid = {r.rid: r for r in rebuilt}
        for r in requests:
            assert by_rid[r.rid].arrival == r.arrival

        res = P.replay.replay(
            doc, lambda reqs: _serve(P, casc, bank, reqs)[1])
        assert res.ok, res.mismatches
        assert res.ref_span_digest is None
        return doc, res.summary()
    out = _both(sim_cascade, run)
    assert out["torch"] == out["jax"]


# --------------------------------------------------------------------------
# test_audit.py: ring overflow
# --------------------------------------------------------------------------

def test_ring_overflow_degrades_honestly(sim_cascade):
    from benchmarks.check_trace import validate_ledger

    def run(P, casc, bank):
        requests = _workload(P)
        _, full = _serve(P, casc, bank, requests)
        n_total = full.tracer.n_emitted
        assert full.tracer.dropped == 0
        tiny = P.obs.Observability(tracer=P.obs.SpanTracer(capacity=32))
        _serve(P, casc, bank, requests, obs=tiny)
        assert tiny.tracer.n_emitted == n_total
        assert tiny.tracer.dropped == n_total - 32
        assert len(tiny.tracer.events) == 32
        d1 = tiny.tracer.span_digest()
        assert len(d1) == 64 and d1 == tiny.tracer.span_digest()
        rep = P.obs.audit_events(tiny.tracer.events,
                                 dropped=tiny.tracer.dropped)
        assert rep["mode"] == "offline" and rep["total_violations"] == 0
        assert all(c["verdict"] == "unverifiable"
                   for c in rep["contracts"].values())
        assert "suspect" in rep
        assert validate_ledger(_json(rep)) == []
        dirty = P.obs.audit_events(tiny.tracer.events, dropped=0)
        assert dirty["total_violations"] > 0
        doc = _json(P.export.events_doc(tiny.tracer))

        def never(reqs):
            raise AssertionError("serve_fn must not run for dropped rings")

        res = P.replay.replay(doc, never)
        assert not res.ok and "unverifiable" in res.mismatches[0]
        return d1, rep, dirty, doc, res.summary()
    out = _both(sim_cascade, run)
    assert out["torch"] == out["jax"]


def test_live_ledger_exact_despite_ring_overflow(sim_cascade):
    def run(P, casc, bank):
        ledger = P.obs.InvariantLedger()
        obs = P.obs.Observability(tracer=P.obs.SpanTracer(capacity=32),
                                  ledger=ledger)
        _serve(P, casc, bank, _workload(P), obs=obs)
        assert obs.tracer.dropped > 0
        rep = ledger.report()
        assert rep["total_violations"] == 0
        assert rep["events_seen"] == obs.tracer.n_emitted
        assert all(c["verdict"] == "pass"
                   for c in rep["contracts"].values())
        return rep
    out = _both(sim_cascade, run)
    assert out["torch"] == out["jax"]


# --------------------------------------------------------------------------
# test_audit.py: lossmap
# --------------------------------------------------------------------------

def _emit_all(P, rows):
    tr = P.obs.SpanTracer()
    for kind, t, kw in rows:
        tr.emit(kind, t=t, **kw)
    return tr.events


def test_stall_decomposition_partitions_ttft():
    rows = [
        ("queued", 0.0, {"rid": 1}),
        ("page_blocked", 1.0, {"rid": 1}),
        ("admitted", 3.0, {"rid": 1, "lane": 0}),
        ("token", 4.5, {"rid": 1, "lane": 0, "ttft": 4.5}),
        ("finish", 5.0, {"rid": 1, "lane": 0}),
    ]
    out = {}
    for P in PKGS:
        d = P.lossmap.stall_decomposition(_emit_all(P, rows))
        b = d["requests"][1]["buckets"]
        assert b["queue_wait"] == pytest.approx(1.0)
        assert b["page_blocked"] == pytest.approx(2.0)
        assert b["prefill"] == pytest.approx(1.5)
        assert sum(b.values()) == pytest.approx(d["requests"][1]["ttft"])
        out[P.name] = d
    assert out["torch"] == out["jax"]


def test_stall_decomposition_escalation_and_gear():
    rows = [
        ("queued", 0.0, {"rid": 1}),
        ("admitted", 0.0, {"rid": 1, "lane": 0}),
        ("escalate", 1.0, {"rid": 1, "model": 1}),
        ("esc_wait", 1.0, {"rid": 1, "model": 1}),
        ("esc_grant", 2.0, {"rid": 1, "model": 1, "lane": 0}),
        ("esc_resolve", 3.0, {"rid": 1, "model": 1}),
        ("token", 4.0, {"rid": 1, "lane": 0, "ttft": 4.0}),
        ("finish", 4.5, {"rid": 1, "lane": 0}),
        ("gear_switch", 10.0, {"src": 0, "dst": 1}),
    ]
    out = {}
    for P in PKGS:
        events = _emit_all(P, rows)
        d = P.lossmap.stall_decomposition(events)
        b = d["requests"][1]["buckets"]
        assert b["esc_wait"] == pytest.approx(1.0)
        assert b["esc_catchup"] == pytest.approx(1.0)
        assert b["prefill"] == pytest.approx(2.0)
        assert sum(b.values()) == pytest.approx(4.0)
        d2 = P.lossmap.stall_decomposition(events, gear_transient_s=1.0)
        assert d2["transient_windows"] == [(10.0, 11.0)]
        out[P.name] = (d, d2)
    assert out["torch"] == out["jax"]


def test_goodput_lossmap_totals(sim_cascade):
    def run(P, casc, bank):
        requests = _workload(P, rate=8.0)
        metrics, obs = _serve(P, casc, bank, requests)
        slo = 0.5
        ceiling = P.lossmap.sim_token_ceiling(3, 0.05, 0.01)
        lm = P.lossmap.goodput_lossmap(
            obs.tracer.events, slo=slo,
            duration=metrics.summary(slo=slo)["duration"],
            ceiling_tok_s=ceiling)
        assert lm["schema"] == "obs_lossmap/v1"
        assert lm["requests_total"] == len(requests)
        assert lm["throughput_tok_s"] <= ceiling + 1e-9
        assert lm["goodput_tok_s"] <= lm["throughput_tok_s"] + 1e-9
        assert lm["loss_total_tok_s"] == pytest.approx(
            ceiling - lm["goodput_tok_s"])
        assert all(v >= 0 for v in lm["loss_tok_s"].values())
        for c in P.lossmap.STALL_CAUSES:
            assert c in lm["loss_tok_s"]
        assert "unserved_capacity" in lm["loss_tok_s"]
        return lm
    out = _both(sim_cascade, run)
    assert out["torch"] == out["jax"]


# --------------------------------------------------------------------------
# test_audit.py: flight recorder re-arm
# --------------------------------------------------------------------------

def test_flight_rearm_fires_repeat_bundles():
    out = {}
    for P in PKGS:
        tr = P.obs.SpanTracer()
        fl = P.obs.FlightRecorder(slo=0.1, slo_burst=2,
                                  max_bundles_per_kind=1,
                                  rearm_interval=10.0)
        fl.bind(tr)
        for i in range(2):
            tr.emit("token", t=float(i), rid=i, ttft=0.5, node=0, sid=0)
        assert [b["trigger"] for b in fl.bundles] == ["slo_burst"]
        tr.emit("token", t=2.0, rid=9, ttft=0.5, node=0, sid=0)
        assert len(fl.bundles) == 1
        for i in range(2):
            tr.emit("token", t=12.0 + i, rid=20 + i, ttft=0.5, node=0,
                    sid=0)
        assert len(fl.bundles) == 2
        assert fl.stats()["rearms"] >= 1
        out[P.name] = (fl.bundles, fl.stats())
    assert out["torch"] == out["jax"]


def test_flight_reset_unit():
    out = {}
    for P in PKGS:
        tr = P.obs.SpanTracer()
        fl = P.obs.FlightRecorder(slo=0.1, slo_burst=3)
        fl.bind(tr)
        tr.emit("token", t=0.0, rid=1, ttft=0.5, node=0, sid=0)
        tr.emit("token", t=0.1, rid=2, ttft=0.5, node=0, sid=0)
        assert fl._slo_streak == 2
        fl.reset()
        assert fl._slo_streak == 0
        assert fl.stats()["rearms"] == 1
        assert not fl.bundles
        out[P.name] = fl.stats()
    assert out["torch"] == out["jax"]


# --------------------------------------------------------------------------
# test_audit.py: artifact validators
# --------------------------------------------------------------------------

def test_validators_reject_corruption(sim_cascade):
    from benchmarks.check_trace import (validate_bundle, validate_events,
                                        validate_ledger)

    def run(P, casc, bank):
        obs = P.obs.Observability(ledger=P.obs.InvariantLedger())
        _serve(P, casc, bank, _workload(P, duration=3.0), obs=obs)
        doc = _json(P.export.events_doc(obs.tracer))
        assert validate_events(doc) == []
        assert validate_events(dict(doc, span_digest="nope")) != []
        rep = _json(obs.ledger.report())
        assert validate_ledger(rep) == []
        rep_bad = _json(rep)
        rep_bad["total_violations"] = 99
        assert validate_ledger(rep_bad) != []
        assert validate_bundle({"schema": "flight_bundle/v1"}) != []
        return doc, rep
    out = _both(sim_cascade, run)
    assert out["torch"] == out["jax"]


# --------------------------------------------------------------------------
# test_regret.py: the meter is a pure observer; recall is regret-free
# --------------------------------------------------------------------------

def _regret_serve(P, casc, bank, *, policy="skip_recall", regret=True):
    obs = P.obs.Observability(
        regret=P.obs.RegretMeter(casc) if regret else None)
    return _serve(P, casc, bank, _workload(P), obs=obs, policy=policy)


def test_meter_is_pure_listener(sim_cascade):
    def run(P, casc, bank):
        _, off = _regret_serve(P, casc, bank, regret=False)
        _, on = _regret_serve(P, casc, bank, regret=True)
        assert on.tracer.span_digest() == off.tracer.span_digest()
        assert on.regret.records
        return on.tracer.span_digest(), on.regret.records
    out = _both(sim_cascade, run)
    assert out["torch"] == out["jax"]


def test_recall_serve_is_regret_free_golden(sim_cascade):
    def run(P, casc, bank):
        _, obs = _regret_serve(P, casc, bank)
        meter = obs.regret
        assert meter.finalized and meter.mode == "exact" and meter.records
        assert all(rec["regret"] == 0.0 for rec in meter.records.values())
        rep = meter.report()
        assert rep["verdict"] == "exact"
        assert rep["regret_mean"] == 0.0 and rep["regret_total"] == 0.0
        _, obs2 = _regret_serve(P, casc, bank)
        assert meter.regret_digest() == obs2.regret.regret_digest()
        return meter.regret_digest(), rep
    out = _both(sim_cascade, run)
    assert out["torch"] == out["jax"]
    assert out["torch"][0] == GOLDEN_REGRET_DIGEST


def test_norecall_serve_pays_regret(sim_cascade):
    def run(P, casc, bank):
        _, obs = _regret_serve(P, casc, bank, policy="norecall_threshold")
        rep = obs.regret.report()
        assert rep["regret_mean"] > 0.0
        assert sum(rep["causes"].values()) > 0.0
        return rep
    out = _both(sim_cascade, run)
    assert out["torch"] == out["jax"]


def test_oracle_serves_min_over_probed_and_memoizes(sim_cascade):
    def run(P, casc, bank):
        meter = P.obs.RegretMeter(casc, traces=bank)
        oracle_loss, oracle_node = meter._oracle(casc.lam)
        scaled = np.asarray(round(float(casc.lam), 9) * bank, np.float32)
        rows = np.arange(len(bank))
        assert np.allclose(oracle_loss, scaled[rows, oracle_node],
                           atol=1e-6)
        assert np.all(oracle_loss >= scaled.min(axis=1) - 1e-6)
        assert meter._oracle(casc.lam)[0] is oracle_loss
        return oracle_loss, oracle_node
    out = _both(sim_cascade, run)
    np.testing.assert_array_equal(out["torch"][0], out["jax"][0])
    np.testing.assert_array_equal(out["torch"][1], out["jax"][1])


# --------------------------------------------------------------------------
# test_regret.py: causes partition regret; offline mirror; honesty
# --------------------------------------------------------------------------

def test_cause_partition_is_exact(sim_cascade):
    def run(P, casc, bank):
        _, obs = _regret_serve(P, casc, bank, policy="norecall_threshold")
        meter = obs.regret
        assert [r for r in meter.records.values() if r["regret"] > 0]
        for rec in meter.records.values():
            assert set(rec["causes"]) == set(P.regret.REGRET_CAUSES)
            assert sum(rec["causes"].values()) == \
                pytest.approx(rec["regret"], rel=1e-9, abs=1e-12)
        rep = meter.report()
        assert sum(rep["causes"].values()) == \
            pytest.approx(rep["regret_total"], rel=1e-9, abs=1e-9)
        return meter.records, meter.regret_digest()
    out = _both(sim_cascade, run)
    assert out["torch"] == out["jax"]


def test_regret_events_mirrors_live_meter(sim_cascade):
    def run(P, casc, bank):
        _, obs = _regret_serve(P, casc, bank, policy="norecall_threshold")
        live = obs.regret.report()
        offline = P.obs.regret_events(list(obs.tracer.events), casc=casc,
                                      traces=bank)
        assert offline["verdict"] == "exact"
        assert offline["digest"] == live["digest"]
        assert offline["regret_mean"] == pytest.approx(live["regret_mean"])
        assert offline["events_dropped"] == 0
        return offline
    out = _both(sim_cascade, run)
    assert out["torch"] == out["jax"]


def test_ring_overflow_demotes_verdict(sim_cascade):
    from benchmarks.check_trace import validate_regret

    def run(P, casc, bank):
        _, obs = _regret_serve(P, casc, bank, policy="norecall_threshold")
        events = list(obs.tracer.events)
        clean = P.obs.regret_events(events, casc=casc, traces=bank)
        suspect = P.obs.regret_events(events, dropped=3, casc=casc,
                                      traces=bank)
        assert suspect["verdict"] == "unverifiable"
        for key in ("regret_mean", "regret_p99", "regret_max",
                    "regret_total"):
            assert suspect[key] is None
        assert suspect["causes"] == {} and suspect["worst"] == []
        assert suspect["suspect"]["regret_mean"] == \
            pytest.approx(clean["regret_mean"])
        assert suspect["events_dropped"] == 3
        assert validate_regret(clean) == []
        assert validate_regret(suspect) == []
        return clean, suspect
    out = _both(sim_cascade, run)
    assert out["torch"] == out["jax"]


# --------------------------------------------------------------------------
# test_regret.py: flight recorder's regret_burst trigger
# --------------------------------------------------------------------------

def test_flight_regret_burst_trigger_and_rearm(tmp_path):
    from benchmarks.check_trace import validate_bundle
    out = {}
    for P in PKGS:
        tracer = P.obs.SpanTracer()
        flight = P.obs.FlightRecorder(out_dir=str(tmp_path / P.name),
                                      regret_threshold=0.5,
                                      rearm_interval=10.0)
        flight.bind(tracer)
        tracer.emit("queued", t=0.8, rid=100)
        tracer.emit("token", t=0.9, rid=100, node=1, loss=0.4)
        tracer.emit("finish", t=1.0, rid=100)
        for i in range(8):
            flight.note_regret(0.05 * i, i, 0.1)
        assert flight.bundles == []
        for i in range(8):
            flight.note_regret(1.0 + 0.05 * i, 100 + i, 2.0)
        assert [b["trigger"] for b in flight.bundles] == ["regret_burst"]
        assert flight.bundles[0]["detail"]["threshold"] == 0.5
        assert flight.bundles[0]["detail"]["worst_regret"] == 2.0
        assert flight.bundles[0]["rid"] == 100
        assert [e["kind"] for e in flight.bundles[0]["request_span"]] == \
            ["queued", "token", "finish"]
        for i in range(4):
            flight.note_regret(25.0 + 0.05 * i, 200 + i, 2.0)
        assert len(flight.bundles) == 2
        with open(flight.dump_paths[0]) as f:
            assert validate_bundle(json.load(f)) == []
        out[P.name] = (flight.bundles, flight.stats())
    assert out["torch"] == out["jax"]


def test_flight_regret_disabled_by_default():
    for P in PKGS:
        flight = P.obs.FlightRecorder()
        for i in range(16):
            flight.note_regret(0.1 * i, i, 100.0)
        assert flight.bundles == []


# --------------------------------------------------------------------------
# test_regret.py: the streaming Pareto frontier
# --------------------------------------------------------------------------

def test_pareto_tracker_dominance_ties_and_gears():
    from benchmarks.check_trace import validate_pareto
    out = {}
    for P in PKGS:
        pt = P.obs.ParetoTracker()
        assert pt.add(0, 1.0, 1.0, gear="quality")
        assert pt.add(1, 0.5, 2.0, gear="turbo")
        assert pt.add(2, 2.0, 0.5, gear="quality")
        assert not pt.add(3, 1.0, 1.0, gear="turbo")
        assert not pt.add(4, 1.5, 1.5, gear="turbo")
        assert [q["rid"] for q in pt.frontier] == [1, 0, 2]
        assert pt.add(5, 0.4, 0.9, gear="turbo")
        assert [q["rid"] for q in pt.frontier] == [5, 2]
        doc = pt.as_doc()
        assert doc["points"] == 6 and doc["frontier_size"] == 2
        assert doc["by_gear"]["turbo"] == {"points": 4, "frontier": 1}
        assert doc["by_gear"]["quality"] == {"points": 2, "frontier": 1}
        assert validate_pareto(doc) == []
        out[P.name] = doc
    assert out["torch"] == out["jax"]


def test_serve_pareto_doc_validates(sim_cascade):
    from benchmarks.check_trace import validate_pareto

    def run(P, casc, bank):
        _, obs = _regret_serve(P, casc, bank)
        doc = obs.regret.pareto.as_doc()
        assert doc["points"] == len(obs.regret.records)
        assert 1 <= doc["frontier_size"] <= doc["points"]
        assert validate_pareto(doc) == []
        return doc
    out = _both(sim_cascade, run)
    assert out["torch"] == out["jax"]


# --------------------------------------------------------------------------
# test_regret.py: report + Perfetto surfaces
# --------------------------------------------------------------------------

def test_report_renders_regret_and_pareto_sections(sim_cascade):
    def run(P, casc, bank):
        _, obs = _regret_serve(P, casc, bank, policy="norecall_threshold")
        report = P.report.ServeReport()
        report.add_regret(obs.regret.report())
        report.add_pareto(obs.regret.pareto.as_doc())
        lines = report.lines()
        text = "\n".join(lines)
        assert "regret: mean" in text and "(exact)" in text
        assert "exited_too_early" in text
        assert "pareto:" in text and "frontier points" in text
        report2 = P.report.ServeReport()
        report2.add_regret(P.obs.regret_events(
            list(obs.tracer.events), dropped=1, casc=casc, traces=bank))
        assert "UNVERIFIABLE" in "\n".join(report2.lines())
        return lines, report2.lines()
    out = _both(sim_cascade, run)
    assert out["torch"] == out["jax"]


def test_perfetto_regret_counter_track(sim_cascade, tmp_path):
    from benchmarks.check_trace import validate_trace

    def run(P, casc, bank):
        _, obs = _regret_serve(P, casc, bank, policy="norecall_threshold")
        path = tmp_path / f"trace_{P.name}.json"
        P.export.write_trace(obs.tracer, str(path), regret=obs.regret)
        with open(path) as f:
            doc = json.load(f)
        counters = [e for e in doc["traceEvents"]
                    if e.get("ph") == "C" and e.get("name") == "regret"]
        assert len(counters) == len(obs.regret.records)
        assert all(e["pid"] == 2 for e in counters)
        assert validate_trace(doc) == []
        return doc
    out = _both(sim_cascade, run)
    assert out["torch"] == out["jax"]
