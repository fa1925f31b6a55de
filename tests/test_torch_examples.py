"""The port's four examples (`repro_torch.examples.{quickstart,
forest_cascade,skip_cascade,serve_cascade}`) against the JAX package's
(`examples/*.py`), on the CPU, on the same numpy inputs.

  * quickstart and forest_cascade draw everything from
    ``np.random.default_rng(0)``: the reference script runs in-process
    (``runpy``) and the port's ``main(["--device", "cpu"])`` must print
    the same lines, every number equal at its printed precision.
  * skip_cascade: three numpy weight sets and one numpy query array go
    into both packages.  The reference's library calls (``M.prefill``,
    ``Cascade.from_traces(solve=False)``, ``solve_skip`` in both modes,
    ``evaluate``, ``skip_dp.simulate_skip``) are composed as its script
    composes them and held against the port's example steps: losses
    within 1e-5, skip-table values within 1e-6, decisions, probe rates
    and the skip fraction equal.  The query stream is cut from 2000 to
    600 rows to keep the file inside its time budget.
  * serve_cascade: the smoke config on numpy weights, untrained
    (``--no-train``), calibrated on the reference's own calibration draw
    (``jax.random.randint`` at ``src/repro/strategy/cascade.py:148``)
    handed to both packages: equal stop tables and table values within
    1e-6, then `Engine.generate`'s tokens, served nodes and segment
    counters equal for all four strategies.
"""

import contextlib
import io
import math
import runpy
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import strategy as jstrategy
from repro.configs import get_config as jget_config
from repro.core import skip_dp as jskip_dp
from repro.core.support import quantize as jquantize
from repro.models import model as JM
from repro.models.param import ParamDef, count_params as jcount_params
from repro.serving.engine import Engine as JEngine
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config as tget_config
from repro_torch.examples import (forest_cascade, quickstart, serve_cascade,
                                  skip_cascade)

ROOT = Path(__file__).resolve().parents[1]
TOL_LOSS = 1e-5       # model losses, JAX vs torch f32 on the CPU
TOL_TABLE = 1e-6      # table values fitted from the same losses
SKIP_T = 600          # the skip example's query stream (2000 there)
SERVE_TOKENS = 8


def _reference_stdout(name: str) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        runpy.run_path(str(ROOT / "examples" / f"{name}.py"),
                       run_name="__main__")
    return out.getvalue()


def _port_stdout(main):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = main(["--device", "cpu"])
    return out.getvalue(), result


@pytest.mark.parametrize("name, module", [("quickstart", quickstart),
                                          ("forest_cascade",
                                           forest_cascade)])
def test_example_prints_the_reference_lines(name, module):
    """Same draws from ``default_rng(0)``, the same lines printed."""
    torch.set_num_threads(2)
    port, result = _port_stdout(module.main)
    assert port.splitlines() == _reference_stdout(name).splitlines()
    if name == "quickstart":
        assert round(result["optimum"], 4) == 0.2103
        row = result["strategies"]["recall_index (T-Tamer)"]
        assert (round(row["objective"], 4), round(row["explored"], 2),
                round(row["served_node"], 2)) == (0.2326, 3.29, 2.22)
    else:
        assert (round(result["expectimax"], 4),
                round(result["index_policy"], 4),
                round(result["simulated"], 4)) == (0.4252, 0.4252, 0.4246)


def _numpy_params(defs, seed):
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

    return jax.tree.map(leaf, defs, is_leaf=lambda x: isinstance(x, ParamDef))


def _reference_shaping(losses):
    """The reference script's shaping block, line for line."""
    rng = np.random.default_rng(0)
    hardness = rng.uniform(0, 1, size=(losses.shape[0], 1))
    capacity = np.array([[0.35, 0.65, 0.95]])
    solved = hardness <= capacity
    losses = np.where(solved, 0.05 * losses + 0.02,
                      0.25 + 0.65 * hardness + 0.05 * losses) \
        + rng.normal(0, 0.01, losses.shape)
    return np.clip(losses, 1e-3, 1.0)


def test_skip_cascade_steps_match_the_reference():
    torch.set_num_threads(2)
    ref = runpy.run_path(str(ROOT / "examples" / "skip_cascade.py"))
    jcfgs = ref["make_family"]()
    tcfgs = skip_cascade.make_family()
    assert [c.name for c in tcfgs] == [c.name for c in jcfgs]
    np_params = [_numpy_params(JM.model_defs(c), i)
                 for i, c in enumerate(jcfgs)]
    toks = np.random.default_rng(3).integers(
        0, skip_cascade.VOCAB, (SKIP_T, skip_cascade.SEQ)).astype(np.int32)

    # 1. per-model losses: the reference's prefill and the port's step
    #    (its flash route: the plain version on the CPU)
    jraw = np.stack([np.asarray(JM.prefill(
        jax.tree.map(jnp.asarray, p), c, {"tokens": jnp.asarray(toks)},
        cache_len=skip_cascade.SEQ + 8)[2])[:, -1]
        for c, p in zip(jcfgs, np_params)], axis=1)
    traw = skip_cascade.model_losses(
        tcfgs, [params_from_numpy(p) for p in np_params], toks,
        use_flash=True)
    np.testing.assert_allclose(traw, jraw, atol=TOL_LOSS, rtol=0)

    # 2. the shaping, then fit / solve / evaluate / walk on the same
    #    shaped losses in both packages
    losses = _reference_shaping(jraw)
    np.testing.assert_array_equal(
        skip_cascade.shape_losses(jraw, np.random.default_rng(0)), losses)
    lam = skip_cascade.LAM
    rel = np.array([jcount_params(JM.model_defs(c)) for c in jcfgs],
                   np.float64)
    rel = rel / rel.sum()
    np.testing.assert_array_equal(skip_cascade.relative_costs(tcfgs), rel)
    fit, ev = losses[:SKIP_T // 2], losses[SKIP_T // 2:]
    casc = jstrategy.Cascade.from_traces(fit, (1 - lam) * rel, k=24,
                                         lam=lam, solve=False)
    tables = casc.solve_skip(mode="skip_free")
    res = jstrategy.evaluate(
        jstrategy.make("skip_recall", casc, mode="skip_free", lam=1.0),
        jnp.asarray(lam * ev))
    scaled_ev = jnp.asarray(lam * ev)
    bins = np.asarray(jquantize(casc.support, scaled_ev))
    _, _, probed = jskip_dp.simulate_skip(tables, np.asarray(scaled_ev),
                                          bins, casc.edge_costs)
    line = casc.solve_skip(mode="cumulative")

    out = skip_cascade.fit_and_evaluate(losses, rel, "cpu")
    np.testing.assert_allclose(out["skip_tables"].value.numpy(),
                               np.asarray(tables.value), atol=TOL_TABLE)
    np.testing.assert_array_equal(out["skip_tables"].nxt.numpy(),
                                  np.asarray(tables.nxt))
    assert abs(out["skip_value"] - float(tables.value)) <= TOL_TABLE
    assert abs(out["line_value"] - float(line.value)) <= TOL_TABLE
    np.testing.assert_array_equal(out["result"].served_node.numpy(),
                                  np.asarray(res.served_node))
    np.testing.assert_allclose(
        out["objective"],
        float((np.asarray(res.served_loss)
               + np.asarray(res.explore_cost)).mean()), atol=TOL_LOSS)
    np.testing.assert_array_equal(out["probed"], probed)
    assert out["probe_rates"] == [float(h) for h in probed.mean(0)]
    assert out["skip_fraction"] == float(
        (probed[:, 0] & ~probed[:, 1] & probed[:, 2]).mean())
    # the reference script's own mean (f32 over int32)
    assert out["mean_probed"] == float(res.n_probed.mean())


def test_serve_cascade_serves_what_the_reference_serves():
    torch.set_num_threads(2)
    jcfg = jget_config("paper-ee-100m", smoke=True)
    np_params = _numpy_params(JM.model_defs(jcfg), 5)
    jparams = jax.tree.map(jnp.asarray, np_params)
    key = jax.random.PRNGKey(0)
    lam = 0.5
    # the reference calibrates on its own draw; the port gets that draw
    jcasc = jstrategy.Cascade.calibrate(jparams, jcfg, key, lam)
    calib = np.asarray(jax.random.randint(
        key, (serve_cascade.CALIB_PROMPTS, serve_cascade.CALIB_LEN), 0,
        jcfg.vocab))
    prompts = np.random.default_rng(7).integers(
        0, jcfg.vocab, (8, serve_cascade.PROMPT_LEN)).astype(np.int32)
    out = serve_cascade.run(
        tget_config("paper-ee-100m", smoke=True), train_steps=None,
        tokens=SERVE_TOKENS, lam=lam, device="cpu",
        params=params_from_numpy(np_params), calib_tokens=calib,
        prompts=prompts)

    jt, tt = jcasc.solve_line(), out["casc"].solve_line()
    np.testing.assert_array_equal(tt.stop.numpy(), np.asarray(jt.stop))
    for f in ("cont", "phi", "sigma", "value"):
        np.testing.assert_allclose(getattr(tt, f).numpy(),
                                   np.asarray(getattr(jt, f)),
                                   atol=TOL_TABLE, rtol=0, err_msg=f)
    assert out["objective"] == pytest.approx(float(jt.value), abs=TOL_TABLE)

    jstrats = {
        "T-Tamer recall": jstrategy.make("recall_index", jcasc),
        "skip cascade": jstrategy.make("skip_recall", jcasc,
                                       mode="cumulative"),
        "threshold(0.4)": jstrategy.make("norecall_threshold", jcasc,
                                         threshold=0.4, lam=1.0),
        "full depth": jstrategy.make("always_last", jcasc),
    }
    assert tuple(jstrats) == serve_cascade.STRATEGIES
    for name, strat in jstrats.items():
        js = JEngine(jparams, jcfg, strat, cache_len=serve_cascade.CACHE_LEN
                     ).generate({"tokens": jnp.asarray(prompts)},
                                SERVE_TOKENS)
        ts = out["stats"][name]
        np.testing.assert_array_equal(ts.tokens, np.asarray(js.tokens),
                                      err_msg=name)
        np.testing.assert_array_equal(ts.served_nodes,
                                      np.asarray(js.served_nodes),
                                      err_msg=name)
        assert (ts.segments_run_batch, ts.segments_run_policy,
                ts.segments_full) == (int(js.segments_run_batch),
                                      int(js.segments_run_policy),
                                      int(js.segments_full)), name
    full = out["stats"]["full depth"].tokens
    for name in serve_cascade.STRATEGIES[:-1]:
        assert out["agreement"][name] == float(
            (out["stats"][name].tokens == full).mean())
