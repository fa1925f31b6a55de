"""The port's calibration and strategies (repro_torch.core,
repro_torch.strategy) against the JAX package's, on the same numpy
losses: support grid and edges equal, stop tables equal, cont / sigma /
value within 1e-5, and RecallIndexStrategy observe/serve decisions
equal — including at the final node, where the JAX package relies on a
clamped out-of-range gather and the port clamps explicitly.  The line
solve through the Bellman-backup kernel (its plain version on the CPU)
is held against the JAX solve through the Pallas kernel in interpret
mode, with the same tolerances.
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
    chain: stop tables equal, cont / phi / sigma / value within 1e-5."""
    _, jc, tc = cascades
    from repro.core.line_dp import solve_line as jsolve
    from repro_torch.core.line_dp import solve_line as tsolve
    jt = jsolve(jc.chain, jc.costs, jc.support, use_kernel=True)
    tt = tsolve(tc.chain, tc.costs, tc.support, use_kernel=True)
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
