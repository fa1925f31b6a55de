"""The port's launcher (repro_torch.launch.serve) under the control
plane, on the CPU:

  * ``_build_adaptive``'s gear bank — calibrated on the model's own
    losses — equals the reference's gear order, slots and prices (within
    1e-9) when both packages get the same numpy prompts (the reference
    launcher draws its own with jax.random) and the same bridged
    weights;
  * ``--adaptive`` serves a diurnal workload on the engine stepper with
    gear switching (no recalibration there, as in the reference), every
    request complete, the gear bank and the controller's report
    printed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.launch import serve as jserve
from repro.models import model as M
from repro.models.param import materialize
from repro.serving import control as jcontrol
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config as t_get_config
from repro_torch.launch import serve as tserve

CPU = "cpu"
PRICE = dict(rel=1e-9, abs=1e-9)


def test_build_adaptive_follows_the_reference(capsys):
    """The launcher's gear bank from the model's own losses: the same
    numpy prompts (the reference draws its own with jax.random) and the
    same bridged weights give the reference's gear order, slots and
    prices."""
    torch.set_num_threads(2)
    cfg = get_config("qwen3-4b", smoke=True)
    params = materialize(M.model_defs(cfg), jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, params))
    args = tserve.parse_args(["--arch", "qwen3-4b", "--smoke", "--device",
                              "cpu", "--adaptive", "--lanes", "4"])
    bank, ctl = tserve._build_adaptive(
        args, t_get_config("qwen3-4b", smoke=True), tparams,
        torch.device(CPU), mean_tokens=10.0, slo=1.0)
    assert "gear bank (quality-first): " in capsys.readouterr().out
    toks = np.random.default_rng(args.seed + 1).integers(
        0, cfg.vocab, (tserve.GEAR_PROMPTS, tserve.GEAR_LEN))
    _, _, nl, _ = M.prefill(params, cfg,
                            {"tokens": jnp.asarray(toks, jnp.int32)},
                            cache_len=tserve.GEAR_CACHE)
    rows = np.asarray(nl, np.float64)
    n = rows.shape[1]
    jbank = jcontrol.GearPlanner(
        rows, np.full(n, 1.0 / n), k=tserve.GEAR_K, seg_time=0.01,
        overhead=0.002, n_lanes=4, mean_tokens=10.0).plan(
            jserve.parse_gears(args.gears))
    assert [(g.name, g.slot) for g in bank] == \
        [(g.name, g.slot) for g in jbank]
    for g, jg in zip(bank, jbank):
        assert g.work == pytest.approx(jg.work, **PRICE)
        assert g.max_rate == pytest.approx(jg.max_rate, **PRICE)
    assert ctl.bank is bank and ctl.recal is None


def test_launcher_serves_adaptive_on_cpu(capsys):
    """``--adaptive`` on the engine stepper: gear switching on a diurnal
    workload, every request complete, the gear bank and the controller's
    report printed."""
    torch.set_num_threads(2)
    run = tserve.main([
        "--arch", "qwen3-4b", "--smoke", "--device", "cpu", "--adaptive",
        "--policy", "always_last",
        "--kv", "paged", "--paged-kernel", "--prefill-chunk", "8",
        "--page-size", "8", "--lanes", "2", "--rate", "6", "--duration",
        "1", "--tokens", "4", "--prompt-len", "10", "--workload",
        "diurnal", "--recal-interval", "0.5"])
    out = capsys.readouterr().out
    assert "gear bank (quality-first): " in out
    assert "adaptive: final gear " in out
    assert "--recal-interval applies to sim steppers" in out
    st = run.controller.stats()
    assert st["recalibrations"] == 0 and len(st["gears"]) == 3
    assert not hasattr(run.stepper, "bank_source")
    for req in run.requests:
        assert run.metrics.records[req.rid].n_tokens == req.max_tokens
