"""The port's training and data modules (repro_torch.data,
repro_torch.training, models.model.forward_train, launch.train,
examples.train_ee) against the JAX package's, on the smoke configs,
with the same numpy inputs.

Tolerances, stated per test:
  * synthetic batches, msgpack bytes and checkpoint files: EQUAL;
  * f32 losses and metrics: rtol 1e-5; f32 gradients: per leaf, max
    |port - reference| <= 1e-4 x max |reference| (the frameworks sum
    in other orders);
  * one AdamW step on one numpy tree: atol = rtol = 1e-6;
  * one f32 train step: metrics rtol 1e-5, parameters atol 1e-6 (the
    step moves them by about lr = 1e-5);
  * bf16 (mixed precision): losses rtol 2e-3; gradients per leaf no
    farther from the reference's f32 gradient than twice the distance
    of the reference's own bf16 gradient from it (bf16 has an 8-bit
    mantissa, and a small leaf such as an SSM's a_log carries bf16
    noise as large as itself); the step's grad norm rtol 1e-2;
  * five `train` steps on the same batches: losses rtol 2e-3;
  * `launch.train --mesh 2x1` / `1x2` on two gloo ranks against the
    one-device run: the printed (4-decimal) losses within 5e-4 (bf16
    steps whose sharded reductions add in another order), the saved
    parameters within 1e-3 (AdamW's first steps move a weight by about
    lr = 3e-4 each, whatever the gradient's size, so a near-zero
    gradient that changes sign moves it the other way).
"""

import json
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # hypothesis optional — property tests skip without it
    from conftest import hypothesis_stubs
    given, settings, st = hypothesis_stubs()

from repro.configs import get_config
from repro.data import pipeline as jdata
from repro.launch import serve as jserve
from repro.models import model as JM
from repro.models.param import materialize
from repro.training import checkpoint as jckpt
from repro.training import loop as jloop
from repro.training import optimizer as jopt
from repro_torch.bridge import opt_state_from_numpy, params_from_numpy
from repro_torch.configs import get_config as tget_config
from repro_torch.data import pipeline as tdata
from repro_torch.examples import train_ee
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as tlaunch
from repro_torch.models import model as TM
from repro_torch.models.param import materialize as tmaterialize
from repro_torch.models.param import tree_leaves, tree_map
from repro_torch.training import checkpoint as tckpt
from repro_torch.training import loop as tloop
from repro_torch.training import optimizer as topt

ARCHS = ("paper-ee-100m", "mamba2-130m")
SRC_DIR = os.path.join(os.path.dirname(__file__), "..", "src")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _bits(x):
    """A leaf as comparable numpy: bf16 leaves (a torch tensor or an
    ml_dtypes array) as their 16-bit patterns."""
    if isinstance(x, torch.Tensor):
        return (x.view(torch.int16) if x.dtype == torch.bfloat16
                else x).numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype == jnp.bfloat16 else a


@pytest.fixture(scope="module")
def models():
    """Each smoke config's reference weights (numpy)."""
    torch.set_num_threads(2)
    out = {}
    for arch in ARCHS:
        cfg = get_config(arch, smoke=True)
        out[arch] = (cfg, _np(materialize(JM.model_defs(cfg),
                                          jax.random.PRNGKey(0))))
    return out


def _batch(cfg, seq=41, b=2, seed=0):
    """A synthetic batch with a few masked labels."""
    batch = jdata.SyntheticLM(jdata.DataConfig(
        vocab=cfg.vocab, seq_len=seq, global_batch=b,
        seed=seed)).sample_batch(0)
    batch["labels"][0, :3] = -1
    return batch


def _assert_grads_close(jgrads, tgrads, frac):
    jl = jax.tree.leaves(jgrads)
    assert len(jl) == len(tgrads)
    for a, g in zip(jl, tgrads):
        a = np.asarray(a, np.float32)
        err = float(np.abs(a - g.float().numpy()).max())
        assert err <= frac * float(np.abs(a).max()) + 1e-12, \
            (err, float(np.abs(a).max()))


# ---- data ------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(vocab=512, seq_len=65, global_batch=8),
                                dict(vocab=512, seq_len=65, global_batch=4,
                                     seed=3, easy_frac=0.8, span=16),
                                dict(vocab=50_257, seq_len=257,
                                     global_batch=2)])
def test_synthetic_batches_equal(kw):
    jit_ = jdata.batches(jdata.DataConfig(**kw), start_step=2)
    tit = tdata.batches(tdata.DataConfig(**kw), start_step=2)
    for _ in range(3):
        a, b = next(jit_), next(tit)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    ja = jdata.SyntheticLM(jdata.DataConfig(**kw))
    ta = tdata.SyntheticLM(tdata.DataConfig(**kw))
    np.testing.assert_array_equal(ja.patterns, ta.patterns)
    np.testing.assert_array_equal(ja.unigram, ta.unigram)


# ---- optimizer -------------------------------------------------------------

def test_cosine_schedule_matches():
    cfg = dict(lr=6e-4, warmup_steps=7, total_steps=50)
    for step in range(0, 60):
        want = float(jopt.cosine_schedule(jopt.AdamWConfig(**cfg),
                                          jnp.asarray(step, jnp.int32)))
        got = float(topt.cosine_schedule(topt.AdamWConfig(**cfg),
                                         torch.tensor(step,
                                                      dtype=torch.int32)))
        assert got == pytest.approx(want, rel=1e-6, abs=1e-12), step


@pytest.mark.parametrize("gscale", [0.01, 10.0], ids=["unclipped",
                                                      "clipped"])
def test_adamw_update_matches(gscale):
    """Two AdamW steps on one numpy tree (matrices, vectors, a list):
    parameters, moments, step and the (grad_norm, lr) metrics within
    atol = rtol = 1e-6; the clip engages in the ``clipped`` case only."""
    rng = np.random.default_rng(1)
    params = {"w": rng.normal(size=(4, 6)).astype(np.float32),
              "b": rng.normal(size=(6,)).astype(np.float32),
              "seq": [rng.normal(size=(2, 3, 4)).astype(np.float32),
                      rng.normal(size=(5,)).astype(np.float32)]}
    grads = [jax.tree.map(lambda p: (gscale * rng.normal(size=p.shape))
                          .astype(np.float32), params) for _ in range(2)]
    cfg = dict(lr=1e-2, warmup_steps=1, total_steps=10)
    jp = jax.tree.map(jnp.asarray, params)
    js = jopt.init_opt_state(jp)
    tp = params_from_numpy(params)
    ts = topt.init_opt_state(tp)
    for g in grads:
        jp, js, jm = jopt.adamw_update(jopt.AdamWConfig(**cfg), jp,
                                       jax.tree.map(jnp.asarray, g), js)
        tp, ts, tm = topt.adamw_update(topt.AdamWConfig(**cfg), tp,
                                       params_from_numpy(g), ts)
        for k in ("grad_norm", "lr"):
            assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-6)
    assert (float(jm["grad_norm"]) > 1.0) == (gscale > 1)
    assert int(ts["step"]) == int(js["step"]) == 2
    for jt, tt in ((jp, tp), (js["mu"], ts["mu"]), (js["nu"], ts["nu"])):
        for a, b in zip(jax.tree.leaves(jt), tree_leaves(tt)):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6,
                                       rtol=1e-6)
    # the state bridge carries the reference's state over
    bs = opt_state_from_numpy(_np(js))
    assert bs["step"].dtype == torch.int32 and int(bs["step"]) == 2
    for a, b in zip(jax.tree.leaves(js["nu"]), tree_leaves(bs["nu"])):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


# ---- forward_train ---------------------------------------------------------

@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no-remat"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_matches(models, arch, remat):
    """f32 loss and every metric within rtol 1e-5, every gradient leaf
    within 1e-4 x its largest entry (SSD's f64 prefix sums stay
    differentiable)."""
    cfg, pn = models[arch]
    batch = _batch(cfg)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: JM.forward_train(p, cfg, _j(batch), remat=remat),
        has_aux=True))(jax.tree.map(jnp.asarray, pn))
    tp = tree_map(lambda t: t.requires_grad_(), params_from_numpy(pn))
    tl, tm = TM.forward_train(tp, cfg, _t(batch), remat=remat)
    tg = torch.autograd.grad(tl, tree_leaves(tp))
    assert set(tm) == set(jm) == {"ce_final", "ce_ramp0", "loss"}
    for k in jm:
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-5), k
    _assert_grads_close(jg, tg, 1e-4)


def test_forward_train_masks_labels_below_zero(models):
    """An all-masked row adds nothing: the loss equals the loss of the
    other row alone, within rtol 1e-6."""
    cfg, pn = models["paper-ee-100m"]
    tp = params_from_numpy(pn)
    batch = _batch(cfg)
    batch["labels"][1] = -1
    with torch.no_grad():
        both, _ = TM.forward_train(tp, cfg, _t(batch))
        one, _ = TM.forward_train(tp, cfg, _t({k: v[:1]
                                                for k, v in batch.items()}))
    assert float(both) == pytest.approx(float(one), rel=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_forward_and_step_match(models, arch):
    """Mixed precision: forward_train on bf16 casts of the weights in
    both packages — losses within rtol 2e-3; each gradient leaf of the
    port at most twice as far (max norm) from the reference's f32
    gradient as the reference's bf16 gradient is — and one
    mixed-precision make_train_step: metrics within rtol 2e-3 (grad
    norm 1e-2)."""
    cfg, pn = models[arch]
    batch = _batch(cfg, seq=33, b=4)

    jgrad = jax.jit(jax.value_and_grad(
        lambda p: JM.forward_train(p, cfg, _j(batch)), has_aux=True))

    (jl, _), jg = jgrad(jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16),
                                     pn))
    _, jg32 = jgrad(jax.tree.map(jnp.asarray, pn))
    tpb = tree_map(lambda t: t.to(torch.bfloat16).requires_grad_(),
                   params_from_numpy(pn))
    tl, _ = TM.forward_train(tpb, cfg, _t(batch))
    tg = torch.autograd.grad(tl, tree_leaves(tpb))
    assert all(g.dtype == torch.bfloat16 for g in tg)
    assert float(tl) == pytest.approx(float(jl), rel=2e-3)
    for a, a32, g in zip(jax.tree.leaves(jg), jax.tree.leaves(jg32), tg):
        a32 = np.asarray(a32)
        ref_err = float(np.abs(np.asarray(a, np.float32) - a32).max())
        err = float(np.abs(g.float().numpy() - a32).max())
        assert err <= 2 * ref_err + 1e-7, (err, ref_err)

    opt = dict(lr=1e-3)
    _, _, jm = jax.jit(jloop.make_train_step(cfg, jopt.AdamWConfig(**opt)))(
        jax.tree.map(jnp.asarray, pn),
        jopt.init_opt_state(jax.tree.map(jnp.asarray, pn)), _j(batch))
    tp = params_from_numpy(pn)
    tp, _, tm = tloop.make_train_step(cfg, topt.AdamWConfig(**opt))(
        tp, topt.init_opt_state(tp), _t(batch))
    assert all(p.dtype == torch.float32 for p in tree_leaves(tp))
    for k in jm:
        rel = 1e-2 if k == "grad_norm" else 2e-3
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=rel), k


def test_kernels_refused_under_autograd(models):
    """Both packages refuse to differentiate through a kernel: the
    reference's jax.grad fails on use_flash / use_ssd_kernel, the port's
    forward_train raises; without autograd the port's flash route (its
    plain version on the CPU) gives the plain path's loss (rtol 1e-5)."""
    for arch, flag in (("paper-ee-100m", "use_flash"),
                       ("mamba2-130m", "use_ssd_kernel")):
        cfg, pn = models[arch]
        batch = _batch(cfg, seq=33)
        jp = jax.tree.map(jnp.asarray, pn)
        with pytest.raises((AssertionError, ValueError)):
            jax.grad(lambda p: JM.forward_train(p, cfg, _j(batch),
                                                **{flag: True})[0])(jp)
        tp = tree_map(lambda t: t.requires_grad_(), params_from_numpy(pn))
        with pytest.raises(NotImplementedError, match=flag):
            TM.forward_train(tp, cfg, _t(batch), **{flag: True})
        with torch.no_grad():
            routed, _ = TM.forward_train(tp, cfg, _t(batch), **{flag: True})
            plain, _ = TM.forward_train(tp, cfg, _t(batch))
        assert float(routed) == pytest.approx(float(plain), rel=1e-5)
    # a flag for a mixer the model does not have routes nothing
    cfg, pn = models["paper-ee-100m"]
    tp = tree_map(lambda t: t.requires_grad_(), params_from_numpy(pn))
    TM.forward_train(tp, cfg, _t(_batch(cfg, seq=17)), use_ssd_kernel=True)


# ---- the train step and the loop -------------------------------------------

def test_train_step_f32_matches(models):
    """One make_train_step in f32 (no mixed precision): metrics within
    rtol 1e-5, every parameter within atol 1e-6 after the step."""
    cfg, pn = models["paper-ee-100m"]
    batch = _batch(cfg, seq=33, b=8)
    opt = dict(lr=1e-3)
    jp = jax.tree.map(jnp.asarray, pn)
    jp, js, jm = jax.jit(jloop.make_train_step(
        cfg, jopt.AdamWConfig(**opt), mixed_precision=False))(
        jp, jopt.init_opt_state(jp), _j(batch))
    tp = params_from_numpy(pn)
    tp, ts, tm = tloop.make_train_step(
        cfg, topt.AdamWConfig(**opt), mixed_precision=False)(
        tp, topt.init_opt_state(tp), _t(batch))
    assert set(tm) == set(jm)
    for k in jm:
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-5), k
    for a, b in zip(jax.tree.leaves(jp), tree_leaves(tp)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6,
                                   rtol=0)
    assert int(ts["step"]) == 1


def test_train_five_steps_match(models):
    """`train` (mixed precision, remat, the reference's defaults) for 5
    steps on the same synthetic batches: every step's loss within rtol
    2e-3 of the reference's."""
    cfg, pn = models["paper-ee-100m"]
    opt = dict(lr=3e-3, total_steps=5, warmup_steps=1)
    dkw = dict(vocab=cfg.vocab, seq_len=33, global_batch=4)
    _, _, jh = jloop.train(cfg, jopt.AdamWConfig(**opt),
                           jax.tree.map(jnp.asarray, pn),
                           jdata.batches(jdata.DataConfig(**dkw)), steps=5,
                           log_every=1)
    _, _, th = tloop.train(cfg, topt.AdamWConfig(**opt),
                           params_from_numpy(pn),
                           tdata.batches(tdata.DataConfig(**dkw)), steps=5,
                           log_every=1)
    assert [h["step"] for h in th] == [h["step"] for h in jh] == \
        list(range(5))
    for a, b in zip(jh, th):
        assert b["loss"] == pytest.approx(a["loss"], rel=2e-3), a["step"]
    assert th[-1]["loss"] < th[0]["loss"]


# ---- mirrors of tests/test_system.py's training tests on the port ---------

@pytest.fixture(scope="module")
def trained():
    """`tests/test_system.py`'s fixture on the port: 60 steps of the
    smoke model (lr 3e-3, 8 x 64 tokens, easy_frac 0.8), from the
    reference's initial weights."""
    cfg = get_config("paper-ee-100m", smoke=True)
    params = params_from_numpy(_np(materialize(JM.model_defs(cfg),
                                               jax.random.PRNGKey(0))))
    opt = topt.AdamWConfig(lr=3e-3, total_steps=60, warmup_steps=5)
    data = tdata.batches(tdata.DataConfig(vocab=cfg.vocab, seq_len=65,
                                          global_batch=8, easy_frac=0.8))
    params, _, hist = tloop.train(cfg, opt, params, data, steps=60,
                                  log_every=60)
    return cfg, params, hist


def test_training_reduces_loss(trained):
    _, _, hist = trained
    assert hist[-1]["loss"] < hist[0]["loss"] * 0.8, \
        f"no convergence: {hist[0]['loss']} -> {hist[-1]['loss']}"
    assert np.isfinite(hist[-1]["grad_norm"])


def test_microbatched_step_matches_plain(trained):
    """Grad accumulation must be loss-equivalent to the full batch (the
    reference test's tolerances)."""
    cfg, params, _ = trained
    opt_cfg = topt.AdamWConfig(lr=1e-3)
    data = tdata.batches(tdata.DataConfig(vocab=cfg.vocab, seq_len=33,
                                          global_batch=8))
    batch = _t(next(data))
    outs = []
    for m in (1, 4):
        p = tree_map(lambda t: t.clone(), params)
        p, _, metrics = tloop.make_train_step(cfg, opt_cfg,
                                              num_microbatches=m)(
            p, topt.init_opt_state(p), batch)
        outs.append((p, metrics))
    (p1, m1), (p4, m4) = outs
    assert float(m1["loss"]) == pytest.approx(float(m4["loss"]), rel=2e-3)
    for a, b in zip(tree_leaves(p1), tree_leaves(p4)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=5e-4,
                                   rtol=5e-2)


def test_microbatched_step_matches_reference(models):
    """num_microbatches = 4 in f32 against the reference's: metrics
    within rtol 1e-5, parameters within atol 1e-6."""
    cfg, pn = models["paper-ee-100m"]
    batch = _batch(cfg, seq=33, b=8)
    opt = dict(lr=1e-3)
    jp = jax.tree.map(jnp.asarray, pn)
    jp, _, jm = jax.jit(jloop.make_train_step(
        cfg, jopt.AdamWConfig(**opt), num_microbatches=4,
        mixed_precision=False))(
        jp, jopt.init_opt_state(jp), _j(batch))
    tp = params_from_numpy(pn)
    tp, _, tm = tloop.make_train_step(cfg, topt.AdamWConfig(**opt),
                                      num_microbatches=4,
                                      mixed_precision=False)(
        tp, topt.init_opt_state(tp), _t(batch))
    for k in jm:
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-5), k
    for a, b in zip(jax.tree.leaves(jp), tree_leaves(tp)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6,
                                   rtol=0)


def test_checkpoint_roundtrip(trained, tmp_path):
    cfg, params, _ = trained
    path = tckpt.save(str(tmp_path / "state_40.ckpt"), {"params": params},
                      40)
    loaded, step = tckpt.load(path)
    assert step == 40
    for a, b in zip(tree_leaves(params), tree_leaves(loaded["params"])):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert tckpt.latest_step(str(tmp_path)) == path


@settings(max_examples=10, deadline=None)
@given(st.integers(0, 10_000))
def test_checkpoint_roundtrip_arbitrary_pytree(seed):
    """`tests/test_props.py`'s property on the port (bf16 leaves as
    torch tensors, int64 and nested lists included); the reference reads
    the port's file to the same leaves."""
    import tempfile
    rng = np.random.default_rng(seed)
    tree = {
        "a": torch.as_tensor(rng.normal(size=(3, 4)), dtype=torch.float32),
        "nested": {"b": rng.integers(0, 9, (5,)).astype(np.int32),
                   "c": [torch.as_tensor(rng.normal(size=(2,)),
                                         dtype=torch.bfloat16),
                         np.asarray([seed], np.int64)]},
    }
    with tempfile.TemporaryDirectory() as td:
        path = f"{td}/s_{seed}.ckpt"
        tckpt.save(path, tree, seed)
        loaded, step = tckpt.load(path)
        jloaded, jstep = jckpt.load(path)
    assert step == jstep == seed
    for a, b, c in zip(tree_leaves(tree), tree_leaves(loaded),
                       jax.tree.leaves(jloaded)):
        if isinstance(a, torch.Tensor) and a.dtype == torch.bfloat16:
            assert isinstance(b, torch.Tensor) and b.dtype == a.dtype
            assert c.dtype == jnp.bfloat16
        else:
            assert isinstance(b, np.ndarray)
            assert b.dtype == c.dtype == _bits(a).dtype
        np.testing.assert_array_equal(_bits(a), _bits(b))
        np.testing.assert_array_equal(_bits(a), _bits(c))


# ---- the file format -------------------------------------------------------

MSGPACK_CASES = [
    {"step": None, "arrays": {}},
    {"step": 7, "ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1,
                         2**32, 2**63, -1, -32, -33, -128, -129, -32768,
                         -32769, -2**31, -2**31 - 1, -2**63],
     "floats": [0.0, -1.5, 1e300], "nil": None, "bools": [True, False],
     "strs": ["", "x" * 31, "y" * 32, "z" * 255, "w" * 256, "v" * 65536,
              "é"], "bins": [b"", b"q" * 255, b"r" * 256, b"s" * 65536],
     "arr": list(range(15)) + [list(range(16)), list(range(70000))],
     "maps": [{str(i): i for i in range(15)},
              {str(i): i for i in range(16)},
              {str(i): i for i in range(70000)}]},
]


@pytest.mark.parametrize("case", range(len(MSGPACK_CASES)))
def test_msgpack_subset_matches_msgpack(case):
    """The port's encoder writes msgpack.packb(..., use_bin_type=True)'s
    bytes, and its decoder reads them back as msgpack.unpackb does."""
    obj = MSGPACK_CASES[case]
    want = msgpack.packb(obj, use_bin_type=True)
    assert tckpt.packb(obj) == want
    assert tckpt.unpackb(want) == msgpack.unpackb(want, raw=False)


def _ref_tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"params": {"w": rng.normal(size=(3, 5)).astype(np.float32),
                       "layers": [{"g": rng.normal(size=(4,))
                                   .astype(np.float32)},
                                  {"g": rng.normal(size=(4,))
                                   .astype(np.float32)}]},
            "half": jnp.asarray(rng.normal(size=(6,)), jnp.bfloat16),
            "ids": rng.integers(-5, 5, (2, 2)).astype(np.int64)}


def _port_tree(ref):
    return {"params": params_from_numpy(ref["params"]),
            "half": torch.from_numpy(np.asarray(ref["half"]).view(np.int16)
                                     .copy()).view(torch.bfloat16),
            "ids": torch.as_tensor(ref["ids"])}


@pytest.mark.parametrize("frame", ["zstd", "zlib"])
def test_checkpoints_read_both_ways(tmp_path, monkeypatch, frame):
    """Each package reads the other's file (zstd or ZLB0 frame) to equal
    leaves; the two files are byte for byte equal, and the port's
    payload is msgpack.packb's."""
    if frame == "zlib":
        monkeypatch.setattr(jckpt, "zstandard", None)
        monkeypatch.setattr(tckpt, "zstandard", None)
    ref = _ref_tree()
    jpath = jckpt.save(str(tmp_path / "ref" / "state_3.ckpt"), ref, 3)
    tpath = tckpt.save(str(tmp_path / "port" / "state_3.ckpt"),
                       _port_tree(ref), 3)
    jbytes, tbytes = open(jpath, "rb").read(), open(tpath, "rb").read()
    assert (jbytes[:4] == b"ZLB0") == (frame == "zlib")
    assert tckpt.codec() == ("zstd" if frame == "zstd" else "zlib (ZLB0)")
    assert jbytes == tbytes
    raw = tckpt._decompress(tbytes)
    assert raw == msgpack.packb(msgpack.unpackb(raw, raw=False),
                                use_bin_type=True)
    for loader, path in ((tckpt.load, jpath), (jckpt.load, tpath)):
        tree, step = loader(path)
        assert step == 3
        got = tree_leaves(tree) if loader is tckpt.load \
            else jax.tree.leaves(tree)
        want = jax.tree.leaves(ref)
        assert len(got) == len(want)
        for a, b in zip(want, got):
            np.testing.assert_array_equal(_bits(a), _bits(b))


def test_zstd_frame_without_zstandard_raises(tmp_path, monkeypatch):
    path = tckpt.save(str(tmp_path / "s_1.ckpt"), {"a": np.zeros(3)}, 1)
    monkeypatch.setattr(tckpt, "zstandard", None)
    with pytest.raises(ImportError, match="zstandard"):
        tckpt.load(path)


# ---- the entry points ------------------------------------------------------

def test_launch_train_on_cpu_then_serve_its_checkpoint(tmp_path, capsys):
    """launch.train --smoke --device cpu writes a checkpoint after its
    last step; launch.serve --ckpt serves it on the chunked paged path
    and every request gets its tokens."""
    torch.set_num_threads(2)
    hist = tlaunch.main(["--smoke", "--device", "cpu", "--steps", "3",
                         "--seq", "32", "--batch", "4", "--log-every", "1",
                         "--ckpt-dir", str(tmp_path)])
    assert [h["step"] for h in hist] == [0, 1, 2]
    assert all(np.isfinite(h["loss"]) for h in hist)
    path = tckpt.latest_step(str(tmp_path))
    assert path.endswith("state_3.ckpt")
    run = tserve.main(["--smoke", "--device", "cpu", "--server", "--kv",
                       "paged", "--paged-kernel", "--prefill-chunk", "8",
                       "--page-size", "8", "--lanes", "2", "--rate", "6",
                       "--duration", "0.5", "--tokens", "4",
                       "--prompt-len", "10", "--ckpt", path])
    out = capsys.readouterr().out
    assert f"loaded checkpoint {path}" in out
    assert "random init" not in out
    for req in run.requests:
        assert run.metrics.records[req.rid].n_tokens == req.max_tokens
    # the served weights are the checkpoint's
    saved, _ = tckpt.load(path)
    table = run.stepper.params["embed"]["table"]
    np.testing.assert_array_equal(table.numpy(),
                                  saved["params"]["embed"]["table"])


def test_launchers_refuse_what_they_cannot_do(tmp_path, monkeypatch):
    with pytest.raises(SystemExit, match="torch.distributed.run"):
        tlaunch.main(["--smoke", "--device", "cpu", "--mesh", "2x1"])
    cfg = get_config("paper-ee-100m", smoke=True)
    params = _np(materialize(JM.model_defs(cfg), jax.random.PRNGKey(0)))
    params["segments"][1]["blocks"]["mlp"]["w_up"] = np.zeros(
        (1, 4, 4), np.float32)
    path = tckpt.save(str(tmp_path / "state_1.ckpt"), {"params": params}, 1)
    with pytest.raises(ValueError, match="/segments/#1/blocks/mlp/w_up"):
        tserve.main(["--smoke", "--device", "cpu", "--ckpt", path])
    params["segments"][1]["blocks"]["mlp"]["w_up"] = np.zeros(
        (1, 128, 256), np.float64)
    path = tckpt.save(str(tmp_path / "state_2.ckpt"), {"params": params}, 2)
    with pytest.raises(ValueError, match="w_up: .* torch.float64"):
        tserve.main(["--smoke", "--device", "cpu", "--ckpt", path])
    with pytest.raises(SystemExit, match="--ckpt"):
        tserve.main(["--smoke", "--device", "cpu", "--ckpt", path,
                     "--cascade", "paper-ee-100m:paper-ee-100m"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA is not available"):
        tlaunch.main(["--smoke"])
    with pytest.raises(SystemExit, match="CUDA is not available"):
        train_ee.main(["--smoke"])


def test_train_ee_example_on_cpu(tmp_path):
    """The example trains, saves its last step and exports the node
    losses of a held-out batch from prefill (finite, in [0, 1])."""
    torch.set_num_threads(2)
    out = train_ee.main(["--smoke", "--device", "cpu", "--steps", "3",
                         "--seq", "32", "--batch", "4", "--ckpt-dir",
                         str(tmp_path)])
    assert out["ckpt"].endswith("state_3.ckpt")
    nl = np.load(out["calibration"])["node_losses"]
    assert nl.shape == (4, 2)
    assert np.isfinite(nl).all() and (nl >= 0).all() and (nl <= 1).all()
    assert out["history"][-1]["step"] == 2


def test_launchers_serve_the_same_checkpoint(tmp_path, monkeypatch):
    """A checkpoint the reference trained and wrote, served by both
    launchers on the CPU (one lane, so a stream never shares a step;
    the threshold policy needs no calibration prompts, which the two
    launchers draw differently): every request's tokens and mean served
    node EQUAL."""
    cfg = get_config("paper-ee-100m", smoke=True)
    params = materialize(JM.model_defs(cfg), jax.random.PRNGKey(0))
    params, _, _ = jloop.train(
        cfg, jopt.AdamWConfig(lr=3e-3, total_steps=30, warmup_steps=3),
        params, jdata.batches(jdata.DataConfig(vocab=cfg.vocab, seq_len=33,
                                               global_batch=8)),
        steps=30, log_every=30)
    path = jckpt.save(str(tmp_path / "state_30.ckpt"), {"params": params},
                      30)
    argv = ["--smoke", "--server", "--kv", "paged", "--prefill-chunk", "8",
            "--page-size", "8", "--lanes", "1", "--rate", "8",
            "--duration", "0.6", "--tokens", "5", "--prompt-len", "10",
            "--policy", "norecall_threshold", "--threshold", "0.985",
            "--ckpt", path]
    monkeypatch.setattr(sys, "argv", ["serve"] + argv + [
        "--json", str(tmp_path / "ref.json")])
    jserve.main()
    tserve.main(argv + ["--device", "cpu", "--json",
                        str(tmp_path / "port.json")])
    ref = json.load(open(tmp_path / "ref.json"))["requests"]
    port = json.load(open(tmp_path / "port.json"))["requests"]
    assert len(ref) == len(port) >= 3
    for a, b in zip(ref, port):
        assert (a["rid"], a["tokens"]) == (b["rid"], b["tokens"])
        assert a["mean_served_node"] == b["mean_served_node"]
    # the threshold splits the tokens between the two nodes
    means = {r["mean_served_node"] for r in ref}
    assert min(means) < 1.0


# ---- launch.train --mesh on two gloo ranks -----------------------------------

MESH_STEPS, MESH_LR = 4, 3e-4
MESH_ARGV = ["--smoke", "--device", "cpu", "--steps", str(MESH_STEPS),
             "--seq", "64", "--batch", "4", "--log-every", "1", "--lr",
             str(MESH_LR)]


def _logged_losses(text):
    return [float(x) for x in re.findall(r"^step +\d+ loss (\S+)", text,
                                         re.M)]


@pytest.fixture(scope="module")
def one_device_run(tmp_path_factory):
    """The 1x1 run's logged losses, its last checkpoint, and the
    parameters it started from (the launcher's seed-0 materialize)."""
    torch.set_num_threads(2)
    path = tmp_path_factory.mktemp("mesh1x1")
    hist = tlaunch.main(MESH_ARGV + ["--ckpt-dir", str(path)])
    cfg = tget_config("paper-ee-100m", smoke=True)
    p0 = tmaterialize(TM.model_defs(cfg), torch.Generator().manual_seed(0),
                      torch.device("cpu"))
    return ([h["loss"] for h in hist],
            str(path / f"state_{MESH_STEPS}.ckpt"), _np(p0))


def _update_agreement(got, want, p0, lr):
    """Over the entries the one-device run moved by lr/2 or more: the
    share whose update (p - p0) in ``got`` is within lr/10 of the
    one-device update, over the whole tree and the least of any leaf."""
    ok = n = 0
    least = 1.0
    for g, w, p in zip(tree_leaves(got), tree_leaves(want), tree_leaves(p0)):
        moved = np.abs(w - p) >= lr / 2
        good = (np.abs((g - p) - (w - p)) <= lr / 10)[moved]
        ok, n = ok + good.sum(), n + moved.sum()
        if moved.any():
            least = min(least, good.mean())
    return ok / n, least


def test_launch_train_mesh_without_torchrun_raises(monkeypatch):
    for var in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(SystemExit, match="--nproc-per-node 2 -m "
                                         "repro_torch.launch.train"):
        tlaunch.main(MESH_ARGV + ["--mesh", "2x1"])


@pytest.mark.parametrize("mesh", ["2x1", "1x2"])
def test_launch_train_mesh_matches_one_device(one_device_run, mesh,
                                              tmp_path):
    """Two gloo ranks under torch.distributed.run: parameters and moments
    sharded by FSDP_TRAIN_RULES (and the batch over "data" at 2x1) train
    as the one-device run does; the gathered checkpoint loads in both
    packages; no op fell back to replicated operands.

    Four steps at lr 3e-4 (warm-up 1): every logged loss, steps 2 and 3
    after one and two updates included, within 5e-4 of the 1x1 run's
    (its 4-decimal print).  And the updates themselves: of the entries
    the 1x1 run moved by lr/2 or more (AdamW moves an entry about lr a
    step), at least 98% in all and 90% of every leaf moved within lr/10
    of the 1x1 update.  Not all: the step runs in bf16, so the two runs'
    reduction orders part the sign of some near-zero gradients, and
    Adam's normalized step turns such a flip into a move of up to 2 lr
    a step (measured: 99.5-99.7% in all, 98.2% the least leaf).  A run
    that applied no update agrees on none of them, one that trained on
    half the batch on far fewer."""
    losses, ckpt_1x1, p0 = one_device_run
    env = dict(os.environ, PYTHONPATH=SRC_DIR)
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
         *MESH_ARGV, "--mesh", mesh, "--ckpt-dir", str(tmp_path)],
        capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    got = _logged_losses(out.stdout)
    assert len(got) == MESH_STEPS, out.stdout
    # every op of this model has a DTensor strategy: none ran replicated
    assert "replicated ops" not in out.stdout, out.stdout
    np.testing.assert_allclose(got, [round(x, 4) for x in losses],
                               rtol=0, atol=5e-4)
    path = str(tmp_path / f"state_{MESH_STEPS}.ckpt")
    want = _np(tckpt.load(ckpt_1x1)[0]["params"])
    for tree in (tckpt.load(path)[0], jckpt.load(path)[0]):
        a = _np(tree["params"])
        for x, y in zip(tree_leaves(a), tree_leaves(want)):
            assert x.shape == y.shape and x.dtype == y.dtype
        share, least = _update_agreement(a, want, p0, MESH_LR)
        assert share >= 0.98 and least >= 0.9, (share, least)
