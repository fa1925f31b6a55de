"""The port's core (repro_torch.core) against the JAX package's, and the
paper's claims held on the port.

Parity, on the same numpy inputs (tolerance 1e-5: both solve in f32,
summing in other orders; integer tables and decisions equal):

  * markov: `estimate_from_losses`, `marginals`, `cumulative_transitions`;
  * line_dp: `suffix_tables`;
  * skip_dp: the three edge-cost constructors (equal), `solve_skip` in
    every mode (``nxt`` equal, ``value_tab`` within 1e-5) and
    `simulate_skip` (equal);
  * the numpy copies (traces, brute_force, impossibility, tree_dp) give
    the JAX package's numbers from the same generator state;
  * pareto: the sweep's frontier points within 1e-6.

Claims, mirroring tests/core/test_claims.py, test_line_dp.py and
test_skip_tree.py on the port (its `sample_chain` draws from a
``torch.Generator``; every other input is numpy): the line DP equals
brute force (Thm 4.5) and its Phi keeps Lemma B.1's shape, the policy's
simulated value converges to the DP value and beats the baselines, skip
equals its brute force and is never worse than the line (Thm 5.2), the
tree index policy is optimal (Thm C.14), the impossibility ratio grows
with alpha (Thm 3.4), recall's frontier dominates no-recall's (§6), and
the oracle lower-bounds everything.
"""

import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # hypothesis optional — property tests skip without it
    from conftest import hypothesis_stubs
    given, settings, st = hypothesis_stubs()

from repro import strategy as jstrategy
from repro.core import brute_force as jbf
from repro.core import impossibility as jimp
from repro.core import line_dp as jline
from repro.core import markov as jmarkov
from repro.core import pareto as jpareto
from repro.core import skip_dp as jskip
from repro.core import traces as jtraces
from repro.core import tree_dp as jtree
from repro_torch import strategy
from repro_torch.core import (brute_force, impossibility, line_dp, markov,
                              pareto, skip_dp, traces, tree_dp)
from repro_torch.core.brute_force import bf_forest, bf_line, bf_skip
from repro_torch.core.markov import MarkovChain, estimate_chain, sample_chain
from repro_torch.core.support import Support, build_support, quantize
from repro_torch.core.traces import random_instance

TOL = dict(atol=1e-5, rtol=1e-5)


def make_support(grid):
    grid = torch.as_tensor(np.asarray(grid), dtype=torch.float32)
    return Support(grid=grid, edges=(grid[1:] + grid[:-1]) / 2)


def make_chain(p0, trans):
    return MarkovChain(p0=torch.as_tensor(p0, dtype=torch.float32),
                       trans=torch.as_tensor(np.asarray(trans),
                                             dtype=torch.float32))


@pytest.fixture(scope="module")
def ee():
    torch.set_num_threads(2)
    losses, correct, flops = traces.ee_like_traces(
        np.random.default_rng(11), 1500, 6, overthink_prob=0.25)
    return losses, correct, flops


# --------------------------------------------------------------------------
# parity with the JAX package
# --------------------------------------------------------------------------

def test_markov_helpers_match(ee):
    losses, _, _ = ee
    jc, js = jmarkov.estimate_from_losses(losses, 16)
    tc, ts = markov.estimate_from_losses(losses, 16)
    np.testing.assert_array_equal(ts.edges.numpy(), np.asarray(js.edges))
    np.testing.assert_allclose(tc.p0.numpy(), np.asarray(jc.p0), **TOL)
    np.testing.assert_allclose(tc.trans.numpy(), np.asarray(jc.trans), **TOL)
    np.testing.assert_allclose(markov.marginals(tc).numpy(),
                               np.asarray(jmarkov.marginals(jc)), **TOL)
    np.testing.assert_allclose(
        markov.cumulative_transitions(tc).numpy(),
        np.asarray(jmarkov.cumulative_transitions(jc)), **TOL)


@pytest.mark.parametrize("start", [0, 2, 5])
def test_suffix_tables_match(ee, start):
    losses, _, flops = ee
    jc = jstrategy.Cascade.from_traces(losses, 0.4 * flops, k=16, lam=0.6)
    tc = strategy.Cascade.from_traces(losses, 0.4 * flops, k=16, lam=0.6)
    jt = jline.suffix_tables(jc.chain, np.asarray(jc.costs), jc.support,
                             start)
    tt = line_dp.suffix_tables(tc.chain, tc.costs, tc.support, start)
    assert tt.n == 6 - start
    np.testing.assert_array_equal(tt.stop.numpy(), np.asarray(jt.stop))
    np.testing.assert_allclose(tt.cont.numpy(), np.asarray(jt.cont), **TOL)
    np.testing.assert_allclose(tt.sigma.numpy(), np.asarray(jt.sigma), **TOL)


@pytest.mark.parametrize("ctor", ["edge_costs_skip_free",
                                     "edge_costs_cumulative"])
def test_edge_costs_match(ctor):
    costs = np.random.default_rng(3).uniform(0.01, 0.2, 7)
    np.testing.assert_array_equal(getattr(skip_dp, ctor)(costs),
                                  getattr(jskip, ctor)(costs))


def test_edge_costs_cascade_match():
    costs = np.random.default_rng(4).uniform(0.01, 0.2, 7)
    for entry in (None, (0.0, 0.05, 0.1)):
        np.testing.assert_array_equal(
            skip_dp.edge_costs_cascade(costs, (2, 3, 2), entry),
            jskip.edge_costs_cascade(costs, (2, 3, 2), entry))
    # one model: cumulative
    np.testing.assert_allclose(skip_dp.edge_costs_cascade(costs, (7,)),
                               skip_dp.edge_costs_cumulative(costs),
                               atol=1e-7)
    with pytest.raises(ValueError, match="boundaries"):
        skip_dp.edge_costs_cascade(costs, (2, 2))


@pytest.fixture(scope="module")
def ladders():
    """The same two-model ladder (4 + 3 nodes) in both packages."""
    losses, bounds = traces.cascade_traces(
        np.random.default_rng(5), 1200, [[1.0, 1.5, 2.0, 2.5],
                                         [4.0, 8.0, 12.0]],
        head_overthink=0.3)
    costs = [np.full(4, 0.05), np.full(3, 0.15)]
    parts = [losses[:, :4], losses[:, 4:]]
    kw = dict(k=16, lam=0.7, entry_costs=(0.0, 0.02))
    return (jstrategy.Cascade.from_model_traces(parts, costs, **kw),
            strategy.Cascade.from_model_traces(parts, costs, **kw))


@pytest.mark.parametrize("mode", ["cumulative", "skip_free", "cascade"])
def test_solve_skip_matches(ladders, mode):
    """solve_skip on the same fitted chain: NEXT tables equal, values
    within 1e-5, in each of the three edge-cost modes."""
    jc, tc = ladders
    jt, tt = jc.solve_skip(mode), tc.solve_skip(mode)
    np.testing.assert_array_equal(tc.edge_costs, jc.edge_costs)
    np.testing.assert_array_equal(tt.nxt.numpy(), np.asarray(jt.nxt))
    np.testing.assert_allclose(tt.value_tab.numpy(),
                               np.asarray(jt.value_tab), **TOL)
    np.testing.assert_allclose(float(tt.value), float(jt.value), **TOL)
    assert (tt.n, tt.k) == (7, 16)
    # skipping a node saves its cost only where edges are not
    # cumulative: there the solve must skip somewhere
    nxt = tt.nxt.numpy()
    last = np.arange(-1, 7)[:, None, None]
    assert ((nxt > last + 1) & (nxt >= 0)).any() == (mode != "cumulative")


def test_simulate_skip_matches(ladders):
    jc, tc = ladders
    jt, tt = jc.solve_skip("skip_free"), tc.solve_skip("skip_free")
    rng = np.random.default_rng(6)
    losses = rng.uniform(0.05, 0.9, (300, 7))
    bins = np.asarray(quantize(tc.support, torch.as_tensor(0.7 * losses)))
    want = jskip.simulate_skip(jt, losses, bins, jc.edge_costs)
    got = skip_dp.simulate_skip(tt, losses, bins, tc.edge_costs)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("fn,args", [
    ("random_instance", (5, 4)),
    ("ee_like_traces", (400, 6)),
    ("cascade_traces", (300, [[1.0, 2.0], [3.0, 6.0, 9.0]])),
])
def test_traces_are_the_reference(fn, args):
    got = getattr(traces, fn)(np.random.default_rng(9), *args)
    want = getattr(jtraces, fn)(np.random.default_rng(9), *args)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_brute_force_and_impossibility_are_the_reference():
    rng = np.random.default_rng(12)
    p0, trans, costs, grid = random_instance(rng, 3, 3)
    ec = skip_dp.edge_costs_cumulative(costs)
    assert brute_force.bf_line(p0, trans, costs, grid) == \
        jbf.bf_line(p0, trans, costs, grid)
    assert brute_force.bf_skip(p0, trans, ec, grid) == \
        jbf.bf_skip(p0, trans, ec, grid)
    for alpha in (3.0, 7.0):
        a, b = impossibility.make_instance(alpha), jimp.make_instance(alpha)
        assert impossibility.best_norecall_value(a) == \
            jimp.best_norecall_value(b)
        assert impossibility.offline_opt_value(a) == \
            jimp.offline_opt_value(b)


def test_tree_dp_is_the_reference():
    rng = np.random.default_rng(13)
    lines = [random_instance(rng, 2, 3) for _ in range(2)]
    grid = lines[0][3]
    lines = [(p0, tr, cs, grid) for p0, tr, cs, _ in lines]
    f, jf = tree_dp.forest_from_lines(lines), jtree.forest_from_lines(lines)
    assert tree_dp.solve_forest_exact(f) == jtree.solve_forest_exact(jf)
    assert tree_dp.index_policy_value(f) == jtree.index_policy_value(jf)
    bins = rng.integers(0, 3, (50, f.n))
    for g, w in zip(tree_dp.simulate_forest(f, bins),
                    jtree.simulate_forest(jf, bins)):
        np.testing.assert_array_equal(g, w)


def test_pareto_sweep_matches(ee):
    """The port's sweep (its strategies and evaluate) gives the JAX
    package's frontier points."""
    losses, correct, flops = ee
    kw = dict(lambdas=[0.5, 0.9], k=16, thresholds=(0.1, 0.3))
    got = pareto.sweep(losses, correct, flops, **kw)
    want = jpareto.sweep(losses, correct, flops, **kw)
    assert [p.policy for p in got] == [p.policy for p in want]
    for g, w in zip(got, want):
        assert g.lam == w.lam
        for f in ("error", "latency", "objective", "mean_probed"):
            assert getattr(g, f) == pytest.approx(getattr(w, f), abs=1e-6)
    assert [(p.policy, p.lam) for p in pareto.pareto_filter(got)] == \
        [(p.policy, p.lam) for p in jpareto.pareto_filter(want)]


# --------------------------------------------------------------------------
# claims (mirrors of tests/core on the port)
# --------------------------------------------------------------------------

def solve_np(p0, trans, costs, grid):
    chain = make_chain(p0, trans)
    return line_dp.solve_line(chain, torch.as_tensor(costs,
                                                     dtype=torch.float32),
                              make_support(grid)), chain


@pytest.mark.parametrize("alpha", [2.0, 5.0, 10.0, 50.0])
def test_impossibility_ratio_grows_with_alpha(alpha):
    """Thm 3.4: ALG/OPT == alpha exactly on the construction."""
    inst = impossibility.make_instance(alpha)
    alg = impossibility.best_norecall_value(inst)
    opt = impossibility.offline_opt_value(inst)
    assert alg == pytest.approx(1.0 / alpha**2, rel=1e-12)
    assert opt == pytest.approx(1.0 / alpha**3, rel=1e-12)
    assert alg / opt == pytest.approx(alpha, rel=1e-9)


def test_impossibility_empirical():
    inst = impossibility.make_instance(8.0)
    _, _, ratio = impossibility.empirical_ratio(
        inst, np.random.default_rng(0), t=400_000)
    assert ratio == pytest.approx(8.0, rel=0.15)


@settings(max_examples=10, deadline=None)
@given(st.integers(0, 10_000), st.integers(2, 5), st.integers(2, 4))
def test_markov_estimation_recovers_chain(seed, n, k):
    rng = np.random.default_rng(seed)
    p0 = rng.dirichlet(np.ones(k) * 5)
    trans = rng.dirichlet(np.ones(k) * 5, size=(n - 1, k))
    gen = torch.Generator().manual_seed(seed)
    bins = sample_chain(make_chain(p0, trans), gen, 60_000)
    est = estimate_chain(bins, k, alpha=0.1)
    np.testing.assert_allclose(est.p0.numpy(), p0, atol=0.02)
    np.testing.assert_allclose(est.trans.numpy(), trans, atol=0.06)
    np.testing.assert_allclose(markov.marginals(est).sum(-1).numpy(), 1.0,
                               atol=1e-4)


@settings(max_examples=20, deadline=None)
@given(st.integers(0, 10_000), st.integers(2, 64))
def test_quantizer_invariants(seed, k):
    samples = np.random.default_rng(seed).lognormal(size=5_000)
    grid = build_support(samples, k).grid.numpy()
    assert (np.diff(grid) > 0).all() and (grid > 0).all()
    bins = quantize(build_support(samples, k),
                    torch.as_tensor(samples, dtype=torch.float32)).numpy()
    assert bins.min() >= 0 and bins.max() < k
    err = np.abs(grid[bins] - samples)
    alt = np.abs(grid[np.clip(bins + 1, 0, k - 1)] - samples)
    alt2 = np.abs(grid[np.clip(bins - 1, 0, k - 1)] - samples)
    assert (err <= np.minimum(alt, alt2) + 1e-5).all()


def test_recall_pareto_dominates_norecall_on_ee_workload():
    """§6 headline: recall-based indexing yields a frontier that
    dominates confidence thresholding on EE-like traces."""
    losses, correct, flops = traces.ee_like_traces(
        np.random.default_rng(42), 12_000, 8, overthink_prob=0.25)
    lambdas = [0.3, 0.5, 0.7, 0.9]
    pts = pareto.sweep(losses, correct, flops, lambdas, k=24)
    for lam in lambdas:
        o = min(p.objective for p in pts
                if p.policy == "recall_index" and p.lam == lam)
        b = min(p.objective for p in pts
                if p.policy.startswith("norecall") and p.lam == lam)
        assert o <= b * 1.02 + 1e-4, (lam, o, b)


def test_oracle_lower_bounds_everything():
    losses, _, flops = traces.ee_like_traces(np.random.default_rng(1),
                                             4_000, 6)
    lam = 0.6
    ls = lam * losses
    cj = torch.as_tensor((1 - lam) * flops, dtype=torch.float32)
    n = ls.shape[1]
    oracle = float(strategy.evaluate(
        strategy.OracleStrategy(n, costs=cj, recall=True), ls).mean_total())
    for strat in (strategy.FixedNodeStrategy(n, n - 1, costs=cj),
                  strategy.FixedNodeStrategy(n, 0, costs=cj),
                  strategy.ThresholdStrategy(n, 0.1, recall=False,
                                             costs=cj),
                  strategy.OracleStrategy(n, costs=cj, recall=False)):
        assert oracle <= float(strategy.evaluate(strat, ls).mean_total()) \
            + 1e-6


@settings(max_examples=25, deadline=None)
@given(st.integers(0, 10_000), st.integers(2, 5), st.integers(2, 4))
def test_dp_matches_bruteforce(seed, n, k):
    """Thm 4.5: the DP value equals the expectimax online optimum."""
    p0, trans, costs, grid = random_instance(np.random.default_rng(seed),
                                             n, k)
    tables, _ = solve_np(p0, trans, costs, grid)
    assert float(tables.value) == pytest.approx(
        bf_line(p0, trans, costs, grid), rel=2e-4, abs=2e-5)


@settings(max_examples=15, deadline=None)
@given(st.integers(0, 10_000), st.integers(2, 4), st.integers(2, 4))
def test_phi_properties(seed, n, k):
    """Lemma B.1 in the loss-minimization convention (see
    tests/core/test_line_dp.py): Phi non-decreasing and 1-Lipschitz in
    x, H = Phi - x non-positive and non-increasing, Phi = x wherever
    stopping is optimal."""
    p0, trans, costs, grid = random_instance(np.random.default_rng(seed),
                                             n, k)
    tables, _ = solve_np(p0, trans, costs, grid)
    xv = line_dp.x_values(torch.as_tensor(grid, dtype=torch.float32)
                          ).numpy()
    phi = tables.phi.numpy()
    dphi, dx = np.diff(phi, axis=-1), np.diff(xv)
    assert (dphi >= -1e-5).all()
    assert (dphi <= dx[None, None, :] + 1e-4 + 1e-6 * np.abs(xv[1:])).all()
    h = phi - xv[None, None, :]
    htol = 1e-4 + 1e-6 * np.abs(xv)
    assert (h <= htol).all()
    assert (np.diff(h, axis=-1) <= htol[1:]).all()
    eq = np.isclose(phi[:-1], xv[None, None, :], atol=1e-5)
    assert (eq | ~tables.stop.numpy()).all()


def _sampled(seed, n, k, draw_seed):
    p0, trans, costs, grid = random_instance(np.random.default_rng(seed),
                                             n, k)
    tables, chain = solve_np(p0, trans, costs, grid)
    bins = sample_chain(chain, torch.Generator().manual_seed(draw_seed),
                        40_000)
    losses = torch.as_tensor(grid, dtype=torch.float32)[bins]
    return tables, bins, losses, torch.as_tensor(costs,
                                                 dtype=torch.float32), grid


@settings(max_examples=10, deadline=None)
@given(st.integers(0, 10_000), st.integers(2, 5), st.integers(2, 3))
def test_policy_simulation_matches_value(seed, n, k):
    """Alg. 1 on sampled chains (precomputed bins on the aux channel, no
    Support) converges to tables.value."""
    tables, bins, losses, costs, _ = _sampled(seed, n, k, seed)
    res = strategy.evaluate(
        strategy.RecallIndexStrategy(tables, support=None, costs=costs),
        losses, aux=bins)
    mc, val = float(res.mean_total()), float(tables.value)
    se = float(res.total.std()) / np.sqrt(bins.shape[0])
    assert abs(mc - val) < max(5 * se, 5e-3), (mc, val, se)


@settings(max_examples=10, deadline=None)
@given(st.integers(0, 10_000), st.integers(2, 5), st.integers(2, 3))
def test_policy_dominates_baselines_in_expectation(seed, n, k):
    tables, bins, losses, costs, grid = _sampled(seed, n, k, seed + 1)
    ours = float(strategy.evaluate(
        strategy.RecallIndexStrategy(tables, support=None, costs=costs),
        losses, aux=bins).mean_total())
    thr = strategy.ThresholdStrategy(n, float(np.median(grid)),
                                     recall=False, costs=costs)
    for base in (strategy.FixedNodeStrategy(n, n - 1, costs=costs),
                 strategy.FixedNodeStrategy(n, 0, costs=costs), thr):
        assert ours <= float(strategy.evaluate(base, losses).mean_total()) \
            + 0.01


def test_sigma_independent_of_x():
    p0, trans, costs, grid = random_instance(np.random.default_rng(0), 4, 4)
    tables, _ = solve_np(p0, trans, costs, grid)
    assert (np.diff(tables.stop.numpy().astype(int), axis=-1) <= 0).all()


def test_sigma_interpolation_exact_on_two_node_instance():
    grid = np.array([0.2, 0.8])
    tables, _ = solve_np(np.array([0.5, 0.5]),
                         np.array([[[1.0, 0.0], [1.0, 0.0]]]),
                         np.array([0.01, 0.1]), grid)
    np.testing.assert_allclose(tables.sigma.numpy()[1], 0.3, atol=1e-5)


@settings(max_examples=15, deadline=None)
@given(st.integers(0, 10_000), st.integers(2, 4), st.integers(2, 3),
       st.booleans())
def test_skip_dp_matches_bruteforce(seed, n, k, skip_free):
    p0, trans, costs, grid = random_instance(np.random.default_rng(seed),
                                             n, k)
    ec = (skip_dp.edge_costs_skip_free(costs) if skip_free
          else skip_dp.edge_costs_cumulative(costs))
    tables = skip_dp.solve_skip(make_chain(p0, trans), ec,
                                make_support(grid))
    assert float(tables.value) == pytest.approx(
        bf_skip(p0, trans, ec, grid), rel=2e-4, abs=2e-5)


@settings(max_examples=10, deadline=None)
@given(st.integers(0, 10_000), st.integers(2, 4), st.integers(2, 3))
def test_skip_never_worse_than_line(seed, n, k):
    p0, trans, costs, grid = random_instance(np.random.default_rng(seed),
                                             n, k)
    skip_val = float(skip_dp.solve_skip(
        make_chain(p0, trans), skip_dp.edge_costs_skip_free(costs),
        make_support(grid)).value)
    assert skip_val <= bf_line(p0, trans, costs, grid) + 1e-5


def random_forest(rng, n, k, max_children=2):
    grid = np.sort(rng.uniform(0.05, 1.0, size=k)) + np.arange(k) * 1e-6
    parents, root_pmfs, trans = [], {}, {}
    for v in range(n):
        candidates = [-1] + [u for u in range(v) if sum(
            1 for p in parents if p == u) < max_children]
        p = int(rng.choice(candidates))
        parents.append(p)
        if p < 0:
            root_pmfs[v] = rng.dirichlet(np.ones(k))
        else:
            trans[v] = rng.dirichlet(np.ones(k), size=k)
    return tree_dp.Forest(parents=tuple(parents), root_pmfs=root_pmfs,
                          trans=trans, costs=rng.uniform(0.01, 0.2, size=n),
                          grid=grid)


@settings(max_examples=8, deadline=None)
@given(st.integers(0, 10_000), st.integers(2, 5), st.integers(2, 3))
def test_tree_index_policy_is_optimal(seed, n, k):
    """Thm C.14: the dynamic-index policy attains the expectimax
    optimum."""
    forest = random_forest(np.random.default_rng(seed), n, k)
    opt = tree_dp.solve_forest_exact(forest)
    pol = tree_dp.index_policy_value(forest)
    assert pol == pytest.approx(opt, rel=1e-5, abs=1e-7)
    assert pol >= opt - 1e-9


@settings(max_examples=6, deadline=None)
@given(st.integers(0, 10_000), st.integers(2, 4), st.integers(2, 3))
def test_multiline_forest_matches_bf(seed, n_per_line, k):
    rng = np.random.default_rng(seed)
    lines = [random_instance(rng, n_per_line, k)[:3] for _ in range(2)]
    grid = np.sort(rng.uniform(0.05, 1.0, size=k)) + np.arange(k) * 1e-6
    forest = tree_dp.forest_from_lines([(p0, tr, cs, grid)
                                        for p0, tr, cs in lines])
    opt = tree_dp.solve_forest_exact(forest)
    assert tree_dp.index_policy_value(forest) == pytest.approx(
        opt, rel=1e-5, abs=1e-7)
    assert opt == pytest.approx(bf_forest(
        list(forest.parents), forest.root_pmfs, forest.trans, forest.costs,
        forest.grid), rel=1e-9)


def test_single_line_forest_matches_line_dp():
    p0, trans, costs, grid = random_instance(np.random.default_rng(7), 3, 3)
    forest = tree_dp.forest_from_lines([(p0, trans, costs, grid)])
    assert tree_dp.solve_forest_exact(forest) == pytest.approx(
        bf_line(p0, trans, costs, grid), rel=1e-9)


def test_simulate_skip_consistent_with_value():
    """MC rollout of the skip policy converges to the DP value."""
    rng = np.random.default_rng(3)
    p0, trans, costs, grid = random_instance(rng, 4, 3)
    ec = skip_dp.edge_costs_skip_free(costs)
    tables = skip_dp.solve_skip(make_chain(p0, trans), ec,
                                make_support(grid))
    t = 30_000
    bins = np.zeros((t, 4), np.int64)
    bins[:, 0] = rng.choice(3, size=t, p=p0)
    for i in range(1, 4):
        for s in range(3):
            mask = bins[:, i - 1] == s
            bins[mask, i] = rng.choice(3, size=mask.sum(), p=trans[i - 1][s])
    served, spent, _ = skip_dp.simulate_skip(tables, grid[bins], bins, ec)
    assert float((served + spent).mean()) == pytest.approx(
        float(tables.value), abs=0.01)


def test_sample_chain_follows_the_generator():
    """The same generator seed gives the same draws; another, others."""
    p0, trans, _, _ = random_instance(np.random.default_rng(2), 4, 3)
    chain = make_chain(p0, trans)
    a = sample_chain(chain, torch.Generator().manual_seed(5), 500)
    b = sample_chain(chain, torch.Generator().manual_seed(5), 500)
    c = sample_chain(chain, torch.Generator().manual_seed(6), 500)
    assert a.shape == (500, 4) and torch.equal(a, b)
    assert not torch.equal(a, c)
    assert int(a.min()) >= 0 and int(a.max()) < 3
