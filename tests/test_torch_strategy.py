"""The port's calibration and strategies (repro_torch.core,
repro_torch.strategy) against the JAX package's, on the same numpy
losses: support grid and edges equal, stop tables equal, cont / sigma /
value within 1e-5, and RecallIndexStrategy observe/serve decisions
equal — including at the final node, where the JAX package relies on a
clamped out-of-range gather and the port clamps explicitly.  The line
solve through the Bellman-backup kernel (its plain version on the CPU)
is held against the JAX solve through the Pallas kernel in interpret
mode, with the same tolerances.

The registry: the same ten names, online flags and table needs as the
JAX package's; every name through `evaluate` on numpy-drawn early-exit
traces gives the reference's served nodes and probe counts, and its
served loss and explore cost within 1e-6; the table strategies built
without a Support read precomputed bins from ``aux`` as the reference's
do.  The cascade's refit, multi-model construction, placeholder spec,
bank reservation and slot signatures, and the swappable arrays behave as
the reference's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import strategy as jstrategy
from repro.configs import get_config
from repro.models import model as M
from repro.models.param import materialize
from repro_torch import strategy as tstrategy
from repro_torch.bridge import (chain_from_numpy, line_tables_from_numpy,
                                params_from_numpy, support_from_numpy,
                                to_tensor)
from repro_torch.strategy.base import init_lane, reset_lanes

TOL = dict(atol=1e-5, rtol=1e-5)


def _traces(seed, t=600, n=6):
    """Correlated per-node losses in (0, 1) that shrink with depth."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(0.05, 0.95, size=(t, 1))
    drift = np.linspace(1.0, 0.4, n)[None, :]
    noise = rng.normal(scale=0.08, size=(t, n))
    return np.clip(base * drift + noise, 1e-3, 1.0).astype(np.float32)


@pytest.fixture(scope="module", params=[(0, 0.6, 16), (1, 0.9, 24)],
                ids=["lam0.6-k16", "lam0.9-k24"])
def cascades(request):
    torch.set_num_threads(2)
    seed, lam, k = request.param
    losses = _traces(seed)
    n = losses.shape[1]
    costs = (1.0 - lam) * np.full((n,), 1.0 / n)
    jc = jstrategy.Cascade.from_traces(losses, costs, k=k, lam=lam)
    tc = tstrategy.Cascade.from_traces(losses, costs, k=k, lam=lam)
    return losses, jc, tc


def test_support_chain_and_tables_match(cascades):
    _, jc, tc = cascades
    np.testing.assert_array_equal(tc.support.grid.numpy(),
                                  np.asarray(jc.support.grid))
    np.testing.assert_array_equal(tc.support.edges.numpy(),
                                  np.asarray(jc.support.edges))
    np.testing.assert_allclose(tc.chain.p0.numpy(), np.asarray(jc.chain.p0),
                               **TOL)
    np.testing.assert_allclose(tc.chain.trans.numpy(),
                               np.asarray(jc.chain.trans), **TOL)
    jt, tt = jc.line_tables, tc.line_tables
    np.testing.assert_array_equal(tt.stop.numpy(), np.asarray(jt.stop))
    np.testing.assert_allclose(tt.cont.numpy(), np.asarray(jt.cont), **TOL)
    np.testing.assert_allclose(tt.phi.numpy(), np.asarray(jt.phi), **TOL)
    np.testing.assert_allclose(tt.sigma.numpy(), np.asarray(jt.sigma),
                               **TOL)
    np.testing.assert_allclose(float(tt.value), float(jt.value), **TOL)


def test_solve_line_kernel_route_matches(cascades):
    """solve_line(use_kernel=True) in both packages on the same fitted
    chain: stop tables equal, cont / phi / sigma / value within 1e-5.
    On CPU tensors the port's route is the plain solve: no launch."""
    _, jc, tc = cascades
    from repro.core.line_dp import solve_line as jsolve
    from repro_torch.core.line_dp import solve_line as tsolve
    from repro_torch.kernels import bellman_backup
    jt = jsolve(jc.chain, jc.costs, jc.support, use_kernel=True)
    before = bellman_backup.launches
    tt = tsolve(tc.chain, tc.costs, tc.support, use_kernel=True)
    assert bellman_backup.launches == before
    np.testing.assert_array_equal(tt.stop.numpy(), np.asarray(jt.stop))
    for f in ("cont", "phi", "sigma"):
        np.testing.assert_allclose(getattr(tt, f).numpy(),
                                   np.asarray(getattr(jt, f)), **TOL)
    np.testing.assert_allclose(float(tt.value), float(jt.value), **TOL)
    # and the kernel route agrees with the port's own plain route
    np.testing.assert_array_equal(tt.stop.numpy(),
                                  tc.line_tables.stop.numpy())


@pytest.mark.parametrize("name", ["recall_index", "always_last"])
def test_evaluate_decisions_match(cascades, name):
    """Offline evaluation over every node (so the final-node stop lookup
    runs for every lane that gets there): served node and probe counts
    equal, costs within 1e-5."""
    losses, jc, tc = cascades
    jr = jstrategy.evaluate(jstrategy.make(name, jc), jnp.asarray(losses))
    tr = tstrategy.evaluate(tstrategy.make(name, tc), losses)
    np.testing.assert_array_equal(tr.served_node.numpy(),
                                  np.asarray(jr.served_node))
    np.testing.assert_array_equal(tr.n_probed.numpy(),
                                  np.asarray(jr.n_probed))
    np.testing.assert_allclose(tr.served_loss.numpy(),
                               np.asarray(jr.served_loss), **TOL)
    np.testing.assert_allclose(tr.explore_cost.numpy(),
                               np.asarray(jr.explore_cost), **TOL)
    if name == "recall_index":
        # the traces make some lanes probe every node
        assert (tr.n_probed.numpy() == losses.shape[1]).any()


def test_recall_observe_stepwise_with_bridged_tables(cascades):
    """Node by node, the port's RecallIndexStrategy built from the JAX
    tables (via the bridge) keeps the same state and the same continue
    mask as the JAX strategy, on lanes that start partly inactive."""
    losses, jc, _ = cascades
    js = jstrategy.make("recall_index", jc)
    tc = tstrategy.Cascade(
        support=support_from_numpy(jax.tree.map(np.asarray, jc.support)),
        chain=chain_from_numpy(jax.tree.map(np.asarray, jc.chain)),
        costs=to_tensor(np.asarray(jc.costs)), lam=jc.lam,
        line_tables=line_tables_from_numpy(
            jax.tree.map(np.asarray, jc.line_tables)))
    ts = tstrategy.make("recall_index", tc)
    t = losses.shape[0]
    active0 = np.arange(t) % 5 != 0
    jst, jact = js.init(t), jnp.asarray(active0)
    tst, tact = ts.init(t), torch.from_numpy(active0)
    for node in range(losses.shape[1]):
        jst, jact = js.observe(jst, jnp.int32(node),
                               jnp.asarray(losses[:, node]), jact)
        tst, tact = ts.observe(tst, node, torch.from_numpy(losses[:, node]),
                               tact)
        np.testing.assert_array_equal(tact.numpy(), np.asarray(jact))
        for f in ("x_idx", "s_bin", "best_node", "n_probed"):
            np.testing.assert_array_equal(getattr(tst, f).numpy(),
                                          np.asarray(getattr(jst, f)))
    np.testing.assert_array_equal(ts.serve(tst).numpy(),
                                  np.asarray(js.serve(jst)))
    assert not tact.any()            # everyone stops after the last node


def test_reset_and_init_lane_match(cascades):
    losses, jc, tc = cascades
    js, ts = jstrategy.make("recall_index", jc), \
        tstrategy.make("recall_index", tc)
    t = losses.shape[0]
    jst, _ = js.observe(js.init(t), 0, jnp.asarray(losses[:, 0]),
                        jnp.ones((t,), bool))
    tst, _ = ts.observe(ts.init(t), 0, torch.from_numpy(losses[:, 0]),
                        torch.ones((t,), dtype=torch.bool))
    mask = np.arange(t) % 3 == 0
    jr = jstrategy.reset_lanes(js, jst, jnp.asarray(mask))
    tr = reset_lanes(ts, tst, torch.from_numpy(mask))
    jl = jstrategy.init_lane(js, jst, 4)
    tl = init_lane(ts, tst, 4)
    for f in ("x_idx", "s_bin", "best_loss", "best_node", "n_probed"):
        np.testing.assert_array_equal(getattr(tr, f).numpy(),
                                      np.asarray(getattr(jr, f)))
        np.testing.assert_array_equal(getattr(tl, f).numpy(),
                                      np.asarray(getattr(jl, f)))


def test_calibrate_on_reference_prompts_matches():
    """`Cascade.calibrate` fed the JAX package's own calibration prompts
    (the port takes explicit tokens) solves the same tables."""
    cfg = get_config("paper-ee-100m", smoke=True)
    params = materialize(M.model_defs(cfg), jax.random.PRNGKey(0))
    key = jax.random.PRNGKey(1)
    jc = jstrategy.Cascade.calibrate(params, cfg, key, lam=0.5, k=8, t=64,
                                     seq=16)
    toks = np.asarray(jax.random.randint(key, (64, 16), 0, cfg.vocab))
    tc = tstrategy.Cascade.calibrate(
        params_from_numpy(jax.tree.map(np.asarray, params)), cfg, toks,
        lam=0.5, k=8)
    np.testing.assert_allclose(tc.support.grid.numpy(),
                               np.asarray(jc.support.grid), **TOL)
    np.testing.assert_array_equal(tc.line_tables.stop.numpy(),
                                  np.asarray(jc.line_tables.stop))
    np.testing.assert_allclose(tc.line_tables.cont.numpy(),
                               np.asarray(jc.line_tables.cont), **TOL)


# --------------------------------------------------------------------------
# every policy of the registry
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ee_cascades():
    """Early-exit traces drawn with numpy (the JAX package's own
    generator, ported), a cascade fitted on them in each package, and
    numpy-drawn predictions for the patience policy."""
    torch.set_num_threads(2)
    from repro_torch.core import traces
    rng = np.random.default_rng(21)
    losses, _, flops = traces.ee_like_traces(rng, 800, 6,
                                             overthink_prob=0.25)
    preds = rng.integers(0, 3, losses.shape).astype(np.int32)
    lam = 0.6
    costs = (1.0 - lam) * flops
    jc = jstrategy.Cascade.from_traces(losses, costs, k=24, lam=lam)
    tc = tstrategy.Cascade.from_traces(losses, costs, k=24, lam=lam)
    return losses, preds, jc, tc


def test_registry_matches_the_reference():
    assert tstrategy.available() == jstrategy.available()
    assert len(tstrategy.available()) == 10
    assert tstrategy.available(online_only=True) == \
        jstrategy.available(online_only=True)
    for name in tstrategy.available():
        assert tstrategy.needs_tables(name) == jstrategy.needs_tables(name)
    with pytest.raises(KeyError, match="unknown strategy"):
        tstrategy.make("nope", None)


@pytest.mark.parametrize("name", jstrategy.available() + ("skip_free",))
def test_every_policy_evaluates_like_the_reference(ee_cascades, name):
    """``skip_free``: skip_recall on skip-free edge costs."""
    losses, preds, jc, tc = ee_cascades
    kw = {"mode": "skip_free"} if name == "skip_free" else {}
    name = "skip_recall" if name == "skip_free" else name
    js, ts = jstrategy.make(name, jc, **kw), tstrategy.make(name, tc, **kw)
    assert ts.online == js.online and type(ts).__name__ == \
        type(js).__name__
    aux = preds if name == "norecall_patience" else None
    jr = jstrategy.evaluate(js, jnp.asarray(losses),
                            aux=None if aux is None else jnp.asarray(aux))
    tr = tstrategy.evaluate(ts, losses, aux=aux)
    np.testing.assert_array_equal(tr.served_node.numpy(),
                                  np.asarray(jr.served_node))
    np.testing.assert_array_equal(tr.n_probed.numpy(),
                                  np.asarray(jr.n_probed))
    for f in ("served_loss", "explore_cost"):
        np.testing.assert_allclose(getattr(tr, f).numpy(),
                                   np.asarray(getattr(jr, f)),
                                   atol=1e-6, rtol=1e-6)
    assert float(tr.mean_total()) == pytest.approx(float(jr.mean_total()),
                                                   abs=1e-6)
    # the traces exercise more than one decision
    assert len(np.unique(tr.n_probed.numpy())) > 1 or name in (
        "always_first", "always_last", "oracle", "oracle_norecall")


@pytest.mark.parametrize("name", ["recall_index", "tree_index",
                                  "skip_recall"])
def test_table_strategies_read_aux_bins(ee_cascades, name):
    """Built without a Support, the table strategies read precomputed
    bins from aux, as the reference's; the engine refuses them."""
    from repro.strategy import line as jline
    from repro.strategy import skip as jskip
    from repro_torch.serving.engine import _check_online
    from repro_torch.strategy import line as tline
    from repro_torch.strategy import skip as tskip
    losses, _, jc, tc = ee_cascades
    bins = np.asarray(tc.support.edges.numpy().searchsorted(
        (jc.lam * losses).astype(np.float32)), np.int32)
    if name == "skip_recall":
        js = jskip.SkipRecallStrategy(jc.solve_skip(), None, jc.edge_costs,
                                      lam=jc.lam)
        ts = tskip.SkipRecallStrategy(tc.solve_skip(), None, tc.edge_costs,
                                      lam=tc.lam)
    else:
        cls = "RecallIndexStrategy" if name == "recall_index" \
            else "TreeIndexStrategy"
        js = getattr(jline, cls)(jc.line_tables, None, costs=jc.costs,
                                 lam=jc.lam)
        ts = getattr(tline, cls)(tc.line_tables, None, costs=tc.costs,
                                 lam=tc.lam)
    jr = jstrategy.evaluate(js, jnp.asarray(losses), aux=jnp.asarray(bins))
    tr = tstrategy.evaluate(ts, losses, aux=bins)
    np.testing.assert_array_equal(tr.served_node.numpy(),
                                  np.asarray(jr.served_node))
    np.testing.assert_array_equal(tr.n_probed.numpy(),
                                  np.asarray(jr.n_probed))
    with pytest.raises(ValueError, match="aux channel"):
        tstrategy.evaluate(ts, losses)
    with pytest.raises(ValueError, match="without a Support"):
        _check_online(ts)


def test_engine_refuses_hindsight_strategies(ee_cascades):
    from repro_torch.serving.engine import _check_online
    _, _, _, tc = ee_cascades
    for name in tstrategy.available():
        strat = tstrategy.make(name, tc)
        if tstrategy.available(online_only=True).count(name):
            assert _check_online(strat) is strat
        else:
            with pytest.raises(ValueError, match="hindsight"):
                _check_online(strat)


def test_refit_matches_and_keeps_the_slot_signatures(ee_cascades):
    """refit on new rows: the same tables as the reference's refit, the
    same families solved, and every strategy's slot signature kept."""
    from repro_torch.core import traces
    losses, _, jc, tc = ee_cascades
    jc.solve_skip("cumulative")
    tc.solve_skip("cumulative")
    new, _, _ = traces.ee_like_traces(np.random.default_rng(22), 500, 6)
    jr, tr = jc.refit(new), tc.refit(new)
    np.testing.assert_array_equal(tr.line_tables.stop.numpy(),
                                  np.asarray(jr.line_tables.stop))
    np.testing.assert_array_equal(tr.skip_tables.nxt.numpy(),
                                  np.asarray(jr.skip_tables.nxt))
    assert tr.skip_mode == "cumulative" and tr.lam == tc.lam
    np.testing.assert_array_equal(tr.costs.numpy(), tc.costs.numpy())
    for name in tstrategy.available():
        assert tstrategy.slot_signature(tstrategy.make(name, tr)) == \
            tstrategy.slot_signature(tstrategy.make(name, tc))
    with pytest.raises(ValueError, match="refit rows"):
        tc.refit(new[:, :4])


def test_slot_signature_and_reserve_bank(ee_cascades):
    losses, _, _, tc = ee_cascades
    a = tstrategy.make("recall_index", tc)
    sig = tstrategy.slot_signature(a)
    assert sig[0] == "RecallIndexStrategy"
    paths = [p for p, _, _ in sig[1]]
    assert paths[:5] == ["tables.cont", "tables.stop", "tables.phi",
                         "tables.sigma", "tables.value"]
    assert ("tables.stop", (6, 24, 26), "bool") in sig[1]
    other = tstrategy.Cascade.from_traces(losses, tc.costs.numpy(), k=16,
                                          lam=tc.lam)
    assert tstrategy.slot_signature(tstrategy.make("recall_index",
                                                   other)) != sig
    assert tstrategy.slot_signature(tstrategy.make("oracle", tc)) == \
        ("OracleStrategy", ())
    bank, sigs = tstrategy.reserve_bank(
        [a, tstrategy.make("norecall_threshold", tc)])
    assert len(bank) == 2 and sigs[0] == sig
    with pytest.raises(ValueError, match="hindsight"):
        tstrategy.reserve_bank([a, tstrategy.make("oracle", tc)])
    with pytest.raises(ValueError, match="one bank serves one ladder"):
        tstrategy.reserve_bank([a, tstrategy.make(
            "always_last", tstrategy.Cascade.uniform(4))])
    with pytest.raises(ValueError, match="at least one slot"):
        tstrategy.reserve_bank([])


def test_dynamic_arrays_and_with_arrays(ee_cascades):
    """The swappable arrays are the reference's (same names per
    strategy); swapping in another same-shaped cascade's arrays decides
    as a strategy built from that cascade."""
    from repro_torch.core import traces
    losses, preds, jc, tc = ee_cascades
    for name in tstrategy.available():
        assert tuple(tstrategy.dynamic_arrays(
            tstrategy.make(name, tc))) == tuple(jstrategy.dynamic_arrays(
                jstrategy.make(name, jc)))
    new, _, _ = traces.ee_like_traces(np.random.default_rng(23), 500, 6)
    tc.solve_skip("cumulative")
    tr = tc.refit(new)
    for name in ("recall_index", "tree_index", "skip_recall",
                 "norecall_threshold"):
        base = tstrategy.make(name, tc)
        swapped = tstrategy.with_arrays(
            base, tstrategy.dynamic_arrays(tstrategy.make(name, tr)))
        assert swapped is not base        # the base keeps its arrays
        want = tstrategy.evaluate(tstrategy.make(name, tr), losses)
        got = tstrategy.evaluate(swapped, losses)
        assert torch.equal(got.served_node, want.served_node)
        assert torch.equal(got.n_probed, want.n_probed)
    fixed = tstrategy.make("oracle", tc)
    assert tstrategy.with_arrays(fixed, {}) is fixed


def test_model_ladder_and_placeholder_cascades():
    """from_model_traces, n_models / node_model, and uniform with costs
    and boundaries, as the reference's."""
    from repro_torch.core import traces
    losses, bounds = traces.cascade_traces(np.random.default_rng(24), 400,
                                           [[1.0, 2.0], [4.0, 8.0, 12.0]])
    parts, costs = [losses[:, :2], losses[:, 2:]], [[0.1, 0.1],
                                                    [0.2, 0.2, 0.2]]
    jc = jstrategy.Cascade.from_model_traces(parts, costs, k=8,
                                             entry_costs=(0.0, 0.05))
    tc = tstrategy.Cascade.from_model_traces(parts, costs, k=8,
                                             entry_costs=(0.0, 0.05))
    assert tc.boundaries == jc.boundaries == bounds == (2, 3)
    assert tc.entry_costs == jc.entry_costs and tc.n_models == 2
    assert [tc.node_model(i) for i in range(5)] == \
        [jc.node_model(i) for i in range(5)] == [0, 0, 1, 1, 1]
    with pytest.raises(ValueError, match="out of range"):
        tc.node_model(5)
    np.testing.assert_array_equal(tc.line_tables.stop.numpy(),
                                  np.asarray(jc.line_tables.stop))
    with pytest.raises(ValueError, match="share the T axis"):
        tstrategy.Cascade.from_model_traces([parts[0], parts[1][:10]],
                                            costs)
    with pytest.raises(ValueError, match="model_costs cover"):
        tstrategy.Cascade.from_model_traces(parts, [[0.1], [0.2]])
    with pytest.raises(ValueError, match="needs multi-model boundaries"):
        tstrategy.Cascade.from_traces(losses, np.full(5, 0.1), k=8
                                      ).solve_skip("cascade")
    u = tstrategy.Cascade.uniform(5, k=6, costs=[0.1, 0.2, 0.3, 0.4, 0.5],
                                  boundaries=(2, 3))
    ju = jstrategy.Cascade.uniform(5, k=6, costs=[0.1, 0.2, 0.3, 0.4, 0.5],
                                   boundaries=(2, 3))
    assert (u.n_nodes, u.support.size, u.boundaries, u.n_models) == \
        (ju.n_nodes, ju.support.size, ju.boundaries, ju.n_models)
    np.testing.assert_array_equal(u.costs.numpy(), np.asarray(ju.costs))
    assert u.line_tables is None and u.node_model(3) == 1
    with pytest.raises(ValueError, match="do not cover"):
        tstrategy.Cascade.uniform(5, boundaries=(2, 2))
