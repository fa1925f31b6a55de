"""The port's adaptive control plane (repro_torch.serving.control) against
the JAX package's, mirroring tests/serving/test_control.py on both
packages with the same numpy traces, tables and workloads:

  * telemetry windows, rate slope and gauges; diurnal inflections and
    the diurnal workload: equal to the reference's;
  * the gear planner: the same quality-first order and slots, ``work``
    and ``max_rate`` within 1e-9 of the reference's; spec and bank
    validation; the publish signature guard; refit shape stability
    (tables within 1e-5 of the reference's refit); the recalibrator's
    gates and re-pricing; hold hysteresis; the steppers' gear knobs
    (``apply_gear``);
  * hot-swap safety on the `SimStepper`: a swap and a publish mid-serve
    drop no lane, the decision program is handed one set of bank
    storages (``decide_cache_size() == 1``) and every reserved tensor
    keeps its ``data_ptr`` while the publish changes its values;
    in-flight lanes are bit-identical across a swap; admission order
    cannot change a stream or the switch log — each serve's records
    EQUAL to the reference's;
  * the adaptive leg of the reference's ``bench_runtime.
    adaptive_vs_frozen`` (`repro_torch.bench.adaptive`): switch times,
    publish times, records and the row's decision ``attribution`` EQUAL
    to the reference's leg built directly from the reference bench's
    setup under a tracer, and ``benchmarks.adaptive_smoke.check``'s
    claims hold on the port's rows.

Tolerances: 1e-9 on the planner's float64 prices (the same float32
evaluation in both packages); 1e-5 on refit tables (f32 solves).
"""

import numpy as np
import pytest
import torch

from repro import strategy as jstrategy
from repro.core import traces as jtraces
from repro.serving import control as jcontrol
from repro.serving import runtime as jrt
from repro.serving.obs import Observability as JObs
from repro.serving.obs import decision_attribution as j_attribution
from repro.serving.runtime.metrics import RuntimeMetrics as JMetrics
from repro.serving.runtime.metrics import SlidingWindow as JWindow
from repro.serving.runtime.workload import WorkloadSpec as JSpec
from repro.serving.runtime.workload import inflection_times as j_inflections
from repro.serving.runtime.workload import make_workload as j_workload
from repro.strategy.base import dynamic_arrays as j_arrays
from repro.strategy.registry import make as j_make
from repro_torch import strategy as tstrategy
from repro_torch.core import traces as ttraces
from repro_torch.serving import control as tcontrol
from repro_torch.serving import runtime as trt
from repro_torch.bench import adaptive as legs
from repro_torch.serving.runtime.metrics import RuntimeMetrics as TMetrics
from repro_torch.serving.runtime.metrics import SlidingWindow as TWindow
from repro_torch.serving.runtime.workload import WorkloadSpec as TSpec
from repro_torch.serving.runtime.workload import \
    inflection_times as t_inflections
from repro_torch.serving.runtime.workload import make_workload as t_workload
from repro_torch.strategy.base import array_leaves
from repro_torch.strategy.base import dynamic_arrays as t_arrays
from repro_torch.strategy.registry import make as t_make
from repro_torch.strategy.registry import slot_signature

N_NODES = 5
SEG, OVH, SLO, LANES = 0.01, 0.002, 0.5, 3
PRICE = dict(rel=1e-9, abs=1e-9)
CPU = "cpu"


def _mini_traces():
    rng = np.random.default_rng(3)
    losses, _, flops = jtraces.ee_like_traces(rng, 800, N_NODES,
                                              overthink_prob=0.2)
    tl, _, tf = ttraces.ee_like_traces(np.random.default_rng(3), 800,
                                       N_NODES, overthink_prob=0.2)
    np.testing.assert_array_equal(tl, losses)
    np.testing.assert_array_equal(tf, flops)
    return losses, flops


def _mini_bank(control, k=8):
    """A tiny two-gear bank solved on synthetic calibration traces."""
    losses, flops = _mini_traces()
    planner = control.GearPlanner(losses[:600], flops, k=k, seg_time=SEG,
                                  overhead=OVH, n_lanes=LANES,
                                  mean_tokens=8.0)
    bank = planner.plan((control.GearSpec("hi", 0.95),
                         control.GearSpec("lo", 0.6)))
    return planner, bank, losses[600:]


def _requests(spec_cls, make, rate=6.0, duration=4.0, seed=5):
    spec = spec_cls(rate=rate, duration=duration, prompt_len=4,
                    max_tokens=(3, 10), seed=seed)
    return make("poisson", spec)


PKG = {
    "jax": dict(control=jcontrol, rt=jrt, spec=JSpec, make=j_workload,
                kw={}),
    "torch": dict(control=tcontrol, rt=trt, spec=TSpec, make=t_workload,
                  kw={"device": CPU}),
}


def _serve(pkg, bank, serve_rows, requests, *, controller=None, sid=0):
    p = PKG[pkg]
    stepper = p["rt"].SimStepper(bank.strategies, serve_rows,
                                 n_lanes=LANES, seg_time=SEG, overhead=OVH,
                                 **p["kw"])
    sid_of = controller.sid_of if controller else (lambda r: sid)
    server = p["rt"].Server(stepper, p["rt"].LaneScheduler(LANES), sid_of,
                            slo=SLO, controller=controller)
    return server.serve(requests), stepper


class _Scripted:
    """Minimal controller: lands scripted swap/publish actions at fixed
    virtual times — no telemetry, no recalibration.  Exercises exactly
    the `BankSwap` + ``bank_source`` machinery the real controller
    drives."""

    def __init__(self, swap_cls, strategies, actions, start=0):
        self.swap = swap_cls(strategies, start=start)
        self.actions = sorted(actions, key=lambda a: a[0])

    def begin(self, metrics, stepper):
        stepper.bank_source = self.swap

    def sid_of(self, req):
        return self.swap.sid_of(req)

    def on_arrivals(self, times):
        pass

    def on_step_end(self, now, queue_depth):
        while self.actions and now >= self.actions[0][0]:
            _, fn = self.actions.pop(0)
            fn(self.swap, now)


def _records(metrics):
    return {rid: (r.tokens, r.n_tokens, r.admitted, r.first_token,
                  r.finished, r.status)
            for rid, r in sorted(metrics.records.items())}


def _ptrs(swap):
    return [t.data_ptr() for a in swap.bank_arrays()
            for t in array_leaves(a)]


# --------------------------------------------------------------------------
# telemetry: bounded windows, rate/slope signals
# --------------------------------------------------------------------------

@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_sliding_window_bounded_and_edge_semantics(pkg):
    w = (JWindow if pkg == "jax" else TWindow)(1.0, maxlen=4)
    assert w.values(0.0) == []
    assert w.percentiles(0.0)["p50"] is None        # empty -> None
    w.push(0.0, 5.0)
    p = w.percentiles(0.5)
    assert p["p50"] == p["p99"] == 5.0              # one sample IS it
    for i in range(10):
        w.push(1.0 + 0.01 * i, float(i))
    assert len(w) <= 4                              # maxlen bound
    assert w.values(3.0) == []                      # span prune


def test_telemetry_rate_slope_and_gauges():
    out = {}
    for pkg, metrics_cls in (("jax", JMetrics), ("torch", TMetrics)):
        control = PKG[pkg]["control"]
        tw = control.TelemetryWindow(2.0, slo=SLO)
        m = metrics_cls(N_NODES, 2)
        tw.bind(m)
        assert m.window is not None      # bind enables bounded windowing
        tw.on_arrivals([1.6, 1.7, 1.8, 1.9])
        assert tw.arrival_rate(2.0) == pytest.approx(4 / 2.0)
        assert tw.rate_slope(2.0) > 0    # all arrivals in the late half
        assert tw.load_level(2.0, [1.0, 2.0, 100.0]) == 2
        tw.on_gauges(queue_depth=3)
        with pytest.raises(KeyError, match="unknown gauge"):
            tw.on_gauges(bogus=1)
        snap = tw.snapshot(2.0)
        assert snap.queue_depth == 3
        assert snap.arrival_rate == pytest.approx(2.0)
        out[pkg] = (tw.rate_slope(2.0), snap.as_dict())
    assert out["torch"] == out["jax"]


# --------------------------------------------------------------------------
# diurnal workload: parameterized ramps + analytic inflections
# --------------------------------------------------------------------------

def test_diurnal_inflection_times_analytic():
    spec = TSpec(rate=12.5, duration=30.0, seed=7)
    jspec = JSpec(rate=12.5, duration=30.0, seed=7)
    marks = t_inflections(spec, period=15.0)
    assert marks == j_inflections(jspec, period=15.0)
    assert [d for _, d in marks] == ["rising", "falling",
                                     "rising", "falling"]
    assert [t for t, _ in marks] == pytest.approx(
        [3.75, 11.25, 18.75, 26.25])
    assert [t for t, _ in t_inflections(spec)] == pytest.approx(
        [7.5, 22.5])
    assert t_inflections(spec, amplitude=0.4, threshold=0.5) == []


def test_diurnal_default_period_is_the_classic_ramp():
    spec = TSpec(rate=6.0, duration=10.0, seed=3)
    a = t_workload("diurnal", spec)
    b = t_workload("diurnal", spec, period=spec.duration)
    ref = j_workload("diurnal", JSpec(rate=6.0, duration=10.0, seed=3))
    assert [r.arrival for r in a] == [r.arrival for r in b] \
        == [r.arrival for r in ref]
    assert all(np.array_equal(x.prompt, y.prompt)
               and np.array_equal(x.prompt, z.prompt)
               for x, y, z in zip(a, b, ref))
    with pytest.raises(ValueError, match="period"):
        t_workload("diurnal", spec, period=0.0)
    with pytest.raises(ValueError, match="amplitude"):
        t_workload("diurnal", spec, amplitude=1.5)


# --------------------------------------------------------------------------
# gear planning: quality-first order, sim-unit capacity pricing
# --------------------------------------------------------------------------

def test_gear_planner_orders_quality_first_and_prices_capacity():
    planner, bank, _ = _mini_bank(tcontrol)
    _, jbank, _ = _mini_bank(jcontrol)
    # the reference's order, slots and prices
    assert [(g.name, g.slot) for g in bank] == \
        [(g.name, g.slot) for g in jbank]
    for g, jg in zip(bank, jbank):
        assert g.work == pytest.approx(jg.work, **PRICE)
        assert g.max_rate == pytest.approx(jg.max_rate, **PRICE)
        assert g.est_loss == pytest.approx(jg.est_loss, rel=1e-6)
    hi, lo = bank[0], bank[1]
    assert (hi.name, lo.name) == ("hi", "lo")   # most work first
    assert hi.work > lo.work
    assert hi.max_rate < lo.max_rate
    assert hi.est_loss <= lo.est_loss + 1e-9
    tok_s = LANES / (OVH + SEG * hi.work)
    assert hi.max_rate == pytest.approx(
        planner.utilization * tok_s / planner.mean_tokens)
    assert bank.slot_for_rate(0.1) == 0
    assert bank.slot_for_rate((hi.max_rate + lo.max_rate) / 2) == 1
    assert bank.slot_for_rate(10 * lo.max_rate) == 1
    assert bank.rate_thresholds == sorted(g.max_rate for g in bank)


def test_gear_spec_and_bank_validation():
    with pytest.raises(ValueError, match="lam"):
        tcontrol.GearSpec("bad", 0.0)
    planner, _, _ = _mini_bank(tcontrol)
    with pytest.raises(ValueError, match="duplicate"):
        planner.plan((tcontrol.GearSpec("a", 0.9),
                      tcontrol.GearSpec("a", 0.8)))
    with pytest.raises(ValueError, match="start slot"):
        tcontrol.BankSwap(planner.plan((tcontrol.GearSpec("a", 0.9),))
                          .strategies, start=3)


# --------------------------------------------------------------------------
# swap + publish machinery
# --------------------------------------------------------------------------

def test_bank_swap_publish_signature_guard():
    _, bank, rows = _mini_bank(tcontrol)
    swap = tcontrol.BankSwap(bank.strategies)
    ptrs = _ptrs(swap)
    g = bank[0]
    refit = t_make(g.spec.strategy, g.cascade.refit(rows[:128]))
    swap.publish(0, refit, 1.0)     # same signature -> clean publish
    assert swap.publishes == [(1.0, 0)]
    # the publish COPIED into the reserved tensors: same storages, the
    # refit's values, and the refit's own tensors are not the bank's
    assert _ptrs(swap) == ptrs
    for got, want in zip(array_leaves(swap.bank_arrays()[0]),
                         array_leaves(t_arrays(refit))):
        assert torch.equal(got, want) and got.data_ptr() != want.data_ptr()
    rng = np.random.default_rng(11)
    alien_losses, _, flops = ttraces.ee_like_traces(rng, 400, N_NODES)
    alien_casc = tstrategy.Cascade.from_traces(
        alien_losses, 0.05 * flops, k=4, lam=0.95, solve=False)
    alien = t_make("skip_recall", alien_casc)
    before = swap.bank_arrays()
    values = [t.clone() for a in before for t in array_leaves(a)]
    with pytest.raises(ValueError, match="signature"):
        swap.publish(0, alien, 2.0)
    assert all(a is b for a, b in zip(swap.bank_arrays(), before))
    assert all(torch.equal(t, v) for t, v in zip(
        (t for a in swap.bank_arrays() for t in array_leaves(a)), values))
    assert swap.publishes == [(1.0, 0)]
    with pytest.raises(ValueError, match="slot"):
        swap.swap_to(7, 0.0)


def test_cascade_refit_is_shape_stable():
    _, bank, rows = _mini_bank(tcontrol)
    _, jbank, _ = _mini_bank(jcontrol)
    g, jg = bank[0], jbank[0]
    s0 = t_make(g.spec.strategy, g.cascade)
    s1 = t_make(g.spec.strategy, g.cascade.refit(rows[:200]))
    assert slot_signature(s0) == slot_signature(s1)
    a0 = array_leaves(t_arrays(s0))
    a1 = array_leaves(t_arrays(s1))
    assert [x.shape for x in a0] == [x.shape for x in a1]
    assert any(not torch.equal(x, y) for x, y in zip(a0, a1))
    # the reference's refit on the same rows: the same tables
    j1 = j_make(jg.spec.strategy, jg.cascade.refit(rows[:200]))
    ja = j_arrays(j1)
    for name, value in t_arrays(s1).items():
        fields = ([(name, value, ja[name])] if isinstance(value, torch.Tensor)
                  else [(f"{name}.{f}", getattr(value, f),
                         getattr(ja[name], f))
                        for f in value.__dataclass_fields__])
        for path, x, y in fields:
            np.testing.assert_allclose(x.numpy().astype(np.float64),
                                       np.asarray(y, np.float64),
                                       atol=1e-5, rtol=1e-5, err_msg=path)


def test_recalibrator_gates_and_reprices():
    rates = {}
    for pkg in ("jax", "torch"):
        control = PKG[pkg]["control"]
        planner, bank, _ = _mini_bank(control)
        swap = control.BankSwap(bank.strategies)
        rec = control.Recalibrator(bank, swap, interval=1.0, min_rows=64,
                                   planner=planner)
        assert not rec.due(5.0)                         # no rows yet
        drift, _, _ = jtraces.ee_like_traces(np.random.default_rng(9),
                                             128, N_NODES,
                                             overthink_prob=0.9)
        rec.observe(drift[:32], np.zeros(32, np.int64))
        assert not rec.due(5.0)                         # below min_rows
        rec.observe(drift[32:], np.zeros(96, np.int64))
        assert not rec.due(0.5)                         # inside interval
        assert rec.due(5.0)
        before = [g.max_rate for g in bank]
        assert rec.recalibrate(5.0) == len(bank)
        assert rec.recals == 1
        assert len(swap.publishes) == len(bank)
        assert [g.max_rate for g in bank] != before
        rates[pkg] = [(g.work, g.max_rate) for g in bank]
    assert np.allclose(rates["torch"], rates["jax"], rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_controller_hold_hysteresis(pkg):
    control = PKG[pkg]["control"]
    _, bank, _ = _mini_bank(control)
    ctl = control.AdaptiveController(bank, span=1.0, hold=3)
    metrics = (JMetrics if pkg == "jax" else TMetrics)(N_NODES, 1)
    ctl.begin(metrics, object())    # no bank_source: switching only
    assert ctl.recal is None
    ctl.on_arrivals(np.linspace(0.9, 1.0, 100))     # way past capacity
    ctl.on_step_end(1.0, 0)
    ctl.on_step_end(1.0, 0)
    assert ctl.swap.gear == 0       # streak 2 < hold 3: no thrash yet
    ctl.on_step_end(1.0, 0)
    assert ctl.swap.gear == 1       # sustained signal lands the swap
    assert len(ctl.swap.switches) == 1


def test_apply_gear_sets_the_host_knobs():
    """A gear's host knobs land on the steppers as in the reference: the
    sim's chunked-prefill budget; the cascade sim's escalate patience,
    catch-up budgets and rung-1 lane cap."""
    from repro.serving import cascade as jcascade
    from repro_torch.serving import cascade as tcascade
    out = {}
    for pkg, control, rt, cascade in (("jax", jcontrol, jrt, jcascade),
                                      ("torch", tcontrol, trt, tcascade)):
        _, bank, rows = _mini_bank(control)
        kw = PKG[pkg]["kw"]
        sim = rt.SimStepper(bank.strategies, rows, n_lanes=LANES,
                            prefill_chunk=4, **kw)
        sim.apply_gear(control.GearSpec("g", 0.9, prefill_budget=12))
        sim.apply_gear(control.GearSpec("h", 0.9))    # no knob: no change
        mbank = cascade.ModelBank([
            cascade.ModelSpec("small", 2, n_lanes=3),
            cascade.ModelSpec("large", 3, n_lanes=2)])
        casc = (jstrategy if pkg == "jax" else tstrategy).Cascade.uniform(
            5, boundaries=(2, 3), **kw)
        strat = (jstrategy if pkg == "jax" else tstrategy).make(
            "always_last", casc)
        csim = cascade.CascadeSimStepper(mbank, (strat,),
                                         np.full((4, 5), 0.5), chunk=8,
                                         **kw)
        csim.apply_gear(control.GearSpec("g", 0.9, patience=2,
                                         esc_budgets=(8, 4),
                                         lane_split=(1,)))
        out[pkg] = (sim.planner.budget, csim.patience,
                    csim.router.patience, list(csim.esc.budgets),
                    dict(csim.esc.lane_caps))
    assert out["torch"] == out["jax"] == (12, 2, 2, [8, 4], {1: 1})


# --------------------------------------------------------------------------
# hot-swap safety: scripted swaps mid-serve, both packages
# --------------------------------------------------------------------------

def _scripted_serve(pkg, actions_of, requests_of=None):
    p = PKG[pkg]
    _, bank, rows = _mini_bank(p["control"])
    reqs = _requests(p["spec"], p["make"])
    if requests_of is not None:
        reqs = requests_of(reqs)
    ctl = _Scripted(p["control"].BankSwap, bank.strategies,
                    actions_of(pkg, bank, rows))
    metrics, stepper = _serve(pkg, bank, rows, reqs, controller=ctl)
    return metrics, stepper, ctl, reqs


def _refit_actions(pkg, bank, rows):
    mk = j_make if pkg == "jax" else t_make
    refit = [mk(g.spec.strategy, g.cascade.refit(rows[:256]))
             for g in bank]
    return [(1.0, lambda sw, now: sw.swap_to(1, now)),
            (2.0, lambda sw, now: (sw.publish(0, refit[0], now),
                                   sw.publish(1, refit[1], now)))]


def test_swap_and_publish_mid_serve_zero_retrace_no_drops():
    tm, stepper, ctl, reqs = _scripted_serve("torch", _refit_actions)
    jm, jstepper, jctl, _ = _scripted_serve("jax", _refit_actions)
    assert len(ctl.swap.switches) == 1
    assert len(ctl.swap.publishes) == 2
    assert ctl.swap.switches == jctl.swap.switches
    assert ctl.swap.publishes == jctl.swap.publishes
    # one set of bank storages across the swap and both publishes: the
    # reserved tensors the serve started with, values rewritten in place
    assert stepper.decide_cache_size() == 1
    assert jstepper.decide_cache_size() == 1
    [seen] = stepper.storages
    assert list(seen) == _ptrs(ctl.swap)
    done = [r for r in tm.records.values() if r.finished is not None]
    assert len(done) == len(reqs)
    assert _records(tm) == _records(jm)


def _swap_at_1_5(pkg, bank, rows):
    return [(1.5, lambda sw, now: sw.swap_to(1, now))]


def test_swap_leaves_in_flight_lanes_bit_identical():
    _, bank, rows = _mini_bank(tcontrol)
    reqs = _requests(TSpec, t_workload)
    frozen, _ = _serve("torch", bank, rows, reqs, sid=0)
    swapped, _, ctl, _ = _scripted_serve("torch", _swap_at_1_5)
    jswapped, _, _, _ = _scripted_serve("jax", _swap_at_1_5)
    assert _records(swapped) == _records(jswapped)
    t_sw = ctl.swap.switches[0][0]
    pre = [r.rid for r in swapped.records.values() if r.admitted < t_sw]
    post = [r.rid for r in swapped.records.values() if r.admitted >= t_sw]
    assert pre and post             # the swap actually split the run
    for rid in pre:
        assert swapped.records[rid].tokens == frozen.records[rid].tokens
    assert any(swapped.records[rid].tokens != frozen.records[rid].tokens
               for rid in post)


def test_admission_order_invariance_across_swap_boundary():
    a, _, ctl_a, _ = _scripted_serve("torch", _swap_at_1_5)
    b, _, ctl_b, _ = _scripted_serve("torch", _swap_at_1_5,
                                     lambda r: list(reversed(r)))
    assert ctl_a.swap.switches == ctl_b.swap.switches
    assert set(a.records) == set(b.records)
    for rid in a.records:
        assert a.records[rid].tokens == b.records[rid].tokens


# --------------------------------------------------------------------------
# the adaptive leg of the reference bench, on the port
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def adaptive():
    """The port's four legs (`legs.adaptive_vs_frozen` on the CPU) and
    the reference's adaptive leg, built directly from the reference
    bench's own setup under a tracer, with its decision attribution as
    the reference bench computes it."""
    from benchmarks import bench_runtime as B
    torch.set_num_threads(2)
    rows, (tm, tst, tctl) = legs.adaptive_vs_frozen(device=CPU)
    serve_rows = legs.adaptive_serve_mix()
    np.testing.assert_array_equal(
        serve_rows, B._adaptive_serve_mix(B.ADAPT_MIX_SEED, 4_000))
    spec = JSpec(rate=B.ADAPT_PEAK, duration=B.ADAPT_DURATION,
                 prompt_len=8, max_tokens=(4, 32), seed=B.ADAPT_SEED)
    jreqs = j_workload("diurnal", spec, period=B.ADAPT_PERIOD)
    planner, jbank = B._adaptive_setup()
    jctl = jcontrol.AdaptiveController(
        jbank, span=B.ADAPT_SPAN, slo=B.SLO, hold=B.ADAPT_HOLD,
        lead=B.ADAPT_LEAD, recal_interval=B.ADAPT_RECAL_INTERVAL,
        recal_min_rows=B.ADAPT_RECAL_MIN_ROWS, planner=planner)
    jst = jrt.SimStepper(jbank.strategies, serve_rows, n_lanes=B.LANES,
                         seg_time=B.SEG_TIME, overhead=B.OVERHEAD)
    jobs = JObs()
    jm = jrt.Server(jst, jrt.LaneScheduler(B.LANES), jctl.sid_of,
                    slo=B.SLO, controller=jctl, obs=jobs).serve(jreqs)
    jattr = j_attribution(jobs.tracer.events,
                          gear_of=lambda sid: jbank[int(sid)].name)
    return dict(rows=rows, tm=tm, tst=tst, tctl=tctl, jm=jm, jst=jst,
                jctl=jctl, jattr=jattr)


def test_adaptive_leg_matches_reference(adaptive):
    a = adaptive
    tctl, jctl = a["tctl"], a["jctl"]
    assert tctl.swap.switches == jctl.swap.switches
    assert tctl.swap.publishes == jctl.swap.publishes
    assert tctl.stats()["recalibrations"] == jctl.stats()["recalibrations"]
    assert _records(a["tm"]) == _records(a["jm"])
    assert a["tst"].mean_served_loss == pytest.approx(
        a["jst"].mean_served_loss, rel=1e-12)
    # the leg's publishes copied into the storages the serve began with
    assert a["tst"].decide_cache_size() == 1
    [seen] = a["tst"].storages
    assert list(seen) == _ptrs(tctl.swap)


def test_adaptive_leg_attribution_matches_reference(adaptive):
    """Each row carries its decision attribution, as the reference bench's
    rows do; the adaptive leg's equals the reference's, and every row's
    accounts for every token its leg served."""
    rows = adaptive["rows"]
    ad = next(r for r in rows if r["adaptive"] == "adaptive")
    assert ad["attribution"] == adaptive["jattr"]
    names = {g.name for g in legs.adaptive_setup()[1]}
    for row in rows:
        attr = row["attribution"]
        assert sum(c["tokens"] for c in attr) == row["summary"]["tokens"]
        assert {c["gear"] for c in attr} <= names
        if row["adaptive"] != "adaptive":
            assert {c["gear"] for c in attr} == {row["gear"]}


def test_adaptive_smoke_acceptance_claims(adaptive):
    """`benchmarks.adaptive_smoke.check` on the port's rows: strict
    goodput dominance over every frozen gear at equal-or-better served
    loss, >= 2 switches, >= 1 recalibration, no dropped lane, one set
    of bank storages."""
    from benchmarks.adaptive_smoke import check
    assert check(adaptive["rows"]) == []


def test_controller_switches_ride_the_inflections(adaptive):
    spec = TSpec(rate=legs.PEAK, duration=legs.DURATION, prompt_len=8,
                 max_tokens=(4, 32), seed=legs.SEED)
    marks = t_inflections(spec, period=legs.PERIOD)
    assert len(marks) == 4
    ad = next(r for r in adaptive["rows"] if r["adaptive"] == "adaptive")
    times = [sw["t"] for sw in ad["controller"]["switches"]]
    assert len(times) >= 2
    tol = legs.SPAN + legs.LEAD + 0.5
    for t_mark, direction in marks:
        nearest = min(abs(t - t_mark) for t in times)
        assert nearest <= tol, (
            f"no gear switch within {tol}s of the {direction} "
            f"inflection at t={t_mark} (switches at {times})")

