"""The port's early-exit decoder (repro_torch.models) against the JAX
package's, on the smoke config (and a windowed GQA config whose prompt
outruns the ring) and on the smoke sizes of the dense tied configs
granite-3-2b, qwen3-4b (qk-norm) and starcoder2-3b (GeLU, GQA 4:1, a
64-token window its 80-token ring prompt outruns), of qwen3-14b
(untied, GQA 5:1) and of phi3.5-moe (untied, MoE), with weights —
qk-norm scales, untied unembeddings and experts included — carried over
by the bridge.  (tests/test_torch_families.py holds the embeds,
multimodal and MLA configs.)

Tolerances: f32 tensors that never pass through the bf16 KV pool agree
within atol = rtol = 1e-5; tensors downstream of the pool within 1e-3,
and the bf16 ring/pool K/V within atol = rtol = 1e-2 (one bf16 ulp),
because the two frameworks' f32 K/V can round to bf16 values one ulp
apart.  Greedy tokens and served nodes are equal; where a token ever
differs, the assertion prints the step and that step's top-2 logit
margin.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import strategy as jstrategy
from repro.configs import get_config
from repro.configs.common import dense_decoder
from repro.models import attention as A
from repro.models import model as M
from repro.models.param import materialize
from repro.serving.engine import Classifier as JClassifier
from repro.serving.engine import Engine as JEngine
from repro_torch import strategy as tstrategy
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.common import dense_decoder as t_dense_decoder
from repro_torch.models import attention as TA
from repro_torch.models import model as TM
from repro_torch.serving.engine import Classifier as TClassifier
from repro_torch.serving.engine import Engine as TEngine

F32 = dict(atol=1e-5, rtol=1e-5)
POOL = dict(atol=1e-3, rtol=1e-3)
BF16 = dict(atol=1e-2, rtol=1e-2)
B, PS, LANE_PAGES, C = 3, 4, 4, 5


@pytest.fixture(scope="module")
def setup():
    torch.set_num_threads(2)
    cfg = get_config("paper-ee-100m", smoke=True)
    params = materialize(M.model_defs(cfg), jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, params))
    return cfg, params, tparams


def test_ramp_readout_matches(setup):
    cfg, params, tparams = setup
    h = np.random.default_rng(0).normal(size=(4, cfg.d_model)) \
        .astype(np.float32)
    for seg in (0, None):
        lj, ej = M.ramp_readout(params, cfg, jnp.asarray(h), segment=seg)
        lt, et = TM.ramp_readout(tparams, cfg, torch.from_numpy(h),
                                 segment=seg)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **F32)
        np.testing.assert_allclose(et.numpy(), np.asarray(ej), **F32)


def test_prefill_matches(setup):
    _check_prefill(*setup)


def _check_prefill(cfg, params, tparams):
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (4, 12))
    lj, _, nlj, npj = M.prefill(params, cfg,
                                {"tokens": jnp.asarray(toks, jnp.int32)},
                                cache_len=16)
    lt, _, nlt, npt = TM.prefill(tparams, cfg,
                                 {"tokens": torch.from_numpy(toks)},
                                 cache_len=16)
    assert nlt.shape == (4, cfg.n_ramps + 1)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **F32)
    np.testing.assert_allclose(nlt.numpy(), np.asarray(nlj), **F32)
    np.testing.assert_array_equal(npt.numpy(), np.asarray(npj))


def _paged_setup(cfg):
    """Per-lane sequential page tables over a shared pool; lane 2 is an
    idle prefill slot in the chunks."""
    n_pages = B * LANE_PAGES + 1
    table = (np.arange(1, LANE_PAGES + 1)[None, :]
             + np.arange(B)[:, None] * LANE_PAGES).astype(np.int32)
    jspecs = M.paged_cache_specs(cfg, B, n_pages, PS)

    def mat(spec, key=None):
        if isinstance(spec, dict):
            return {k: mat(v, k) for k, v in spec.items()}
        shape, dtype = spec
        return (jnp.full(shape, -1, dtype) if key == "pos"
                else jnp.zeros(shape, dtype))

    jcaches = [mat(s) for s in jspecs]

    def tmat(spec, key=None):
        if isinstance(spec, dict):
            return {k: tmat(v, k) for k, v in spec.items()}
        shape, dtype = spec
        return (torch.full(shape, -1, dtype=dtype) if key == "pos"
                else torch.zeros(shape, dtype=dtype))

    tcaches = [tmat(s) for s in TM.paged_cache_specs(cfg, B, n_pages, PS)]
    return table, jcaches, tcaches


def _chunk(toks, table, start, width, lanes_active):
    b = table.shape[0]
    pos = np.full((b, C), -1, np.int32)
    dp = np.zeros((b, C), np.int32)
    ds = np.zeros((b, C), np.int32)
    for lane in range(b):
        if lanes_active[lane]:
            idx = np.arange(start, start + width)
            pos[lane, :width] = idx
            dp[lane, :width] = table[lane, idx // PS]
            ds[lane, :width] = idx % PS
    act = np.asarray(lanes_active, bool)
    fields = dict(tok=toks[:, start:start + C].astype(np.int32), pos=pos,
                  dest_page=dp, dest_slot=ds,
                  start=np.full((b,), start, np.int32),
                  last_idx=np.full((b,), width - 1, np.int32), emit=act,
                  active=act)
    return (A.PrefillChunk(**{k: jnp.asarray(v) for k, v in fields.items()}),
            TA.PrefillChunk(**{k: torch.from_numpy(np.ascontiguousarray(v))
                               for k, v in fields.items()}))


@pytest.mark.parametrize("kernel", [False, True], ids=["gather", "kernel"])
def test_prefill_chunks_then_decode_match(setup, kernel):
    """Two prefill chunks (a full one, then a ragged one starting mid-
    page) through every segment, then one decode token per lane with one
    lane masked out — the port (gather path, or the kernel switch, which
    runs the plain versions on CPU) against the JAX gather path."""
    _check_chunks_then_decode(*setup, kernel)


def _check_chunks_then_decode(cfg, params, tparams, kernel):
    table, jcaches, tcaches = _paged_setup(cfg)
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (B, 2 * C))
    active = (True, True, False)
    with TA.paged_kernel(kernel):
        for start, width in ((0, C), (C, C - 2)):
            jc, tc = _chunk(toks, table, start, width, active)
            xj = params["embed"]["table"][jc.tok]
            xt = tparams["embed"]["table"][tc.tok.long()]
            for si in range(len(cfg.segments)):
                xj, jcaches[si] = M.prefill_chunk_segment(
                    params, cfg, si, xj, jcaches[si], jnp.asarray(table), jc)
                xt, _ = TM.prefill_chunk_segment(
                    tparams, cfg, si, xt, tcaches[si],
                    torch.from_numpy(table), tc)
            live = np.asarray(tc.pos) >= 0
            np.testing.assert_allclose(xt.numpy()[live],
                                       np.asarray(xj)[live], **POOL)
        for si in range(len(cfg.segments)):
            np.testing.assert_array_equal(
                tcaches[si]["attn"]["pos"].numpy(),
                np.asarray(jcaches[si]["attn"]["pos"]))
            # written pages agree to a bf16 ulp; the garbage page 0 holds
            # whatever the pad rows wrote last (all at position -1)
            for name in ("k", "v"):
                np.testing.assert_allclose(
                    tcaches[si]["attn"][name][:, 1:].float().numpy(),
                    np.asarray(jcaches[si]["attn"][name][:, 1:],
                               np.float32), atol=1e-2, rtol=1e-2)
            assert (tcaches[si]["attn"]["pos"][:, 0] == -1).all()

        # one decode token at the position after each lane's prompt
        pos = np.asarray([2 * C - 2, 2 * C - 2, 0], np.int32)
        write_page = table[np.arange(B), pos // PS]
        write_slot = (pos % PS).astype(np.int32)
        wmask = np.asarray([True, False, True])
        dtok = np.asarray([3, 7, 11], np.int32)
        jkv = A.PagedKV(jnp.asarray(table), jnp.asarray(write_page),
                        jnp.asarray(write_slot))
        tkv = TA.PagedKV(torch.from_numpy(table),
                         torch.from_numpy(write_page),
                         torch.from_numpy(write_slot))
        xj = params["embed"]["table"][dtok][:, None, :]
        xt = tparams["embed"]["table"][torch.from_numpy(dtok).long()][:,
                                                                      None]
        for si in range(len(cfg.segments)):
            xj, jcaches[si], roj = M.decode_segment(
                params, cfg, si, xj, jcaches[si], jnp.asarray(pos),
                paged=jkv, write_mask=jnp.asarray(wmask))
            xt, _, rot = TM.decode_segment(
                tparams, cfg, si, xt, tcaches[si], torch.from_numpy(pos),
                paged=tkv, write_mask=torch.from_numpy(wmask))
            np.testing.assert_allclose(xt.numpy(), np.asarray(xj), **POOL)
            assert (roj is None) == (rot is None)
            if rot is not None:
                np.testing.assert_allclose(rot[0].numpy(),
                                           np.asarray(roj[0]), **POOL)
                np.testing.assert_allclose(rot[1].numpy(),
                                           np.asarray(roj[1]), **POOL)
        for si in range(len(cfg.segments)):
            np.testing.assert_array_equal(
                tcaches[si]["attn"]["pos"].numpy(),
                np.asarray(jcaches[si]["attn"]["pos"]))


def test_paged_cache_specs_match():
    """The paged spec tree, (cfg, n_lanes, n_pages, page_size) as in the
    reference: attention leaves page-pooled, SSM state lane-indexed."""
    for arch in ("paper-ee-100m", "mamba2-130m"):
        cfg = get_config(arch, smoke=True)
        jspecs = M.paged_cache_specs(cfg, 2, 9, PS)
        tspecs = TM.paged_cache_specs(cfg, 2, 9, PS)
        assert len(tspecs) == len(jspecs) == len(cfg.segments)
        for js, ts in zip(jspecs, tspecs):
            assert set(ts) == set(js)
            for key in ts:
                assert set(ts[key]) == set(js[key])
                for name in ts[key]:
                    assert ts[key][name][0] == js[key][name][0]
                    assert str(ts[key][name][1]).split(".")[-1] == \
                        jnp.dtype(js[key][name][1]).name
        if arch == "paper-ee-100m":
            assert tspecs[0]["attn"]["k"][0][1] == 9      # the page pool
        else:
            assert tspecs[0]["ssm"]["ssm"][0][1] == 2     # one per lane


# --------------------------------------------------------------------------
# whole-prompt prefill into ring caches, ring decode, Engine.generate
# --------------------------------------------------------------------------

WIN = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=32,
           d_ff=128, vocab=256, n_segments=2, window=6)
RING_CASES = {
    # name: (prompt_len, cache_len); "window": the prompt outruns the
    # 8-slot ring, so build_ring_cache wraps it
    "smoke": (12, 16),
    "window": (13, 8),
}


@pytest.fixture(scope="module", params=sorted(RING_CASES))
def ring_setup(request, setup):
    """(cfg, jax params, port params, prompt_len, cache_len) for the
    smoke config and a windowed GQA config."""
    torch.set_num_threads(2)
    prompt_len, cache_len = RING_CASES[request.param]
    if request.param == "smoke":
        cfg, params, tparams = setup
    else:
        cfg = dense_decoder("win-gqa", **WIN)
        assert repr(t_dense_decoder("win-gqa", **WIN)) == repr(cfg)
        params = materialize(M.model_defs(cfg), jax.random.PRNGKey(3))
        tparams = params_from_numpy(jax.tree.map(np.asarray, params))
    return cfg, params, tparams, prompt_len, cache_len


def _check_ring(tcaches, jcaches):
    for tc, jc in zip(tcaches, jcaches):
        np.testing.assert_array_equal(tc["attn"]["pos"].numpy(),
                                      np.asarray(jc["attn"]["pos"]))
        for name in ("k", "v"):
            np.testing.assert_allclose(
                tc["attn"][name].float().numpy(),
                np.asarray(jc["attn"][name], np.float32), **BF16)


@pytest.mark.parametrize("use_flash", [False, True],
                         ids=["sdpa", "flash"])
def test_prefill_ring_caches_match(ring_setup, use_flash):
    """Port prefill (einsum path, or the flash route, which runs the
    kernel's plain version on the CPU) against the JAX package's own
    CPU path, prefill(use_flash=False)."""
    _check_prefill_ring(*ring_setup, use_flash)


def _check_prefill_ring(cfg, params, tparams, prompt_len, cache_len,
                        use_flash):
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (3, prompt_len))
    lj, cj, nlj, npj = M.prefill(params, cfg,
                                 {"tokens": jnp.asarray(toks, jnp.int32)},
                                 cache_len)
    lt, ct, nlt, npt = TM.prefill(tparams, cfg,
                                  {"tokens": torch.from_numpy(toks)},
                                  cache_len, use_flash=use_flash)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **F32)
    np.testing.assert_allclose(nlt.numpy(), np.asarray(nlj), **F32)
    np.testing.assert_array_equal(npt.numpy(), np.asarray(npj))
    _check_ring(ct, cj)
    jspecs = M.cache_specs(cfg, 3, cache_len)
    for tc, js in zip(ct, jspecs):
        for name in ("k", "v", "pos"):
            assert tuple(tc["attn"][name].shape) == js["attn"][name][0]
    if prompt_len > cache_len:      # the ring wrapped: slot p % C holds p
        pos = ct[0]["attn"]["pos"][0, 0].numpy()
        assert pos.min() == prompt_len - cache_len
        np.testing.assert_array_equal(pos % cache_len, np.arange(cache_len))


def _first_divergence(tt, jt, tl, jl):
    """Message naming the first step whose greedy tokens differ, with
    that step's top-2 logit margin in each package."""
    step = int(np.flatnonzero((tt != jt).any(axis=0))[0])

    def margin(logits):
        top = np.sort(logits, axis=-1)[:, -2:]
        return (top[:, 1] - top[:, 0]).round(6).tolist()
    return (f"tokens first differ at step {step}: port {tt[:, step]} vs "
            f"reference {jt[:, step]}; top-2 margins port "
            f"{margin(tl[step])}, reference {margin(jl[step])}")


def test_ring_decode_step_matches(ring_setup):
    """Greedy full-depth decode on the ring caches, 6 tokens: logits
    within 1e-3, tokens equal, ring caches within a bf16 ulp."""
    _check_ring_decode(*ring_setup)


def _check_ring_decode(cfg, params, tparams, prompt_len, cache_len):
    toks = np.random.default_rng(5).integers(0, cfg.vocab, (3, prompt_len))
    lj, cj, _, pj = M.prefill(params, cfg,
                              {"tokens": jnp.asarray(toks, jnp.int32)},
                              cache_len)
    lt, ct, _, pt = TM.prefill(tparams, cfg,
                               {"tokens": torch.from_numpy(toks)},
                               cache_len)
    jt, tt, jl, tl = [], [], [], []
    tok_j = jnp.argmax(lj, axis=-1).astype(jnp.int32)
    tok_t = torch.argmax(lt, dim=-1).to(torch.int32)
    with torch.no_grad():
        for _ in range(6):
            lj, cj, nj = M.decode_step(params, cfg, {"tokens": tok_j}, cj,
                                       pj)
            lt, ct, nt = TM.decode_step(tparams, cfg, {"tokens": tok_t}, ct,
                                        pt)
            np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **POOL)
            np.testing.assert_allclose(nt.numpy(), np.asarray(nj), **POOL)
            jl.append(np.asarray(lj))
            tl.append(lt.numpy())
            tok_j = jnp.argmax(lj, axis=-1).astype(jnp.int32)
            tok_t = torch.argmax(lt, dim=-1).to(torch.int32)
            jt.append(np.asarray(tok_j))
            tt.append(tok_t.numpy())
            pj, pt = pj + 1, pt + 1
    jt, tt = np.stack(jt, 1), np.stack(tt, 1)
    assert (tt == jt).all(), _first_divergence(tt, jt, tl, jl)
    _check_ring(ct, cj)


def _engines(cfg, params, tparams, name, cache_len):
    """The same strategy in both packages, from the same numpy loss
    traces (so the solved tables are equal, as test_torch_strategy
    shows)."""
    rng = np.random.default_rng(6)
    n = cfg.n_ramps + 1
    losses = np.clip(rng.uniform(0.05, 0.95, (400, 1))
                     * np.linspace(1.0, 0.5, n)[None, :]
                     + rng.normal(scale=0.05, size=(400, n)), 1e-3,
                     1.0).astype(np.float32)
    costs = 0.5 * np.full((n,), 1.0 / n)
    js = jstrategy.make(name, jstrategy.Cascade.from_traces(
        losses, costs, k=8, lam=0.5))
    ts = tstrategy.make(name, tstrategy.Cascade.from_traces(
        losses, costs, k=8, lam=0.5))
    return (JEngine(params, cfg, js, cache_len, jit=False),
            TEngine(tparams, cfg, ts, cache_len))


@pytest.mark.parametrize("name", ["recall_index", "always_last"])
def test_engine_generate_matches(ring_setup, name):
    """`Engine.generate` (prefill, then the early-exit token step on the
    ring caches): tokens, served nodes and segment counters equal."""
    cfg, params, tparams, prompt_len, cache_len = ring_setup
    je, te = _engines(cfg, params, tparams, name, cache_len)
    toks = np.random.default_rng(7).integers(0, cfg.vocab, (4, prompt_len))
    js = je.generate({"tokens": jnp.asarray(toks, jnp.int32)}, 5)
    with torch.no_grad():
        ts = te.generate({"tokens": torch.from_numpy(toks)}, 5)
    if not (ts.tokens == js.tokens).all():
        step = int(np.flatnonzero((ts.tokens != js.tokens).any(0))[0])
        raise AssertionError(
            f"tokens first differ at step {step}: port "
            f"{ts.tokens[:, step]} vs reference {js.tokens[:, step]}")
    np.testing.assert_array_equal(ts.served_nodes, js.served_nodes)
    assert (ts.segments_run_batch, ts.segments_run_policy,
            ts.segments_full) == (js.segments_run_batch,
                                  js.segments_run_policy, js.segments_full)


@pytest.mark.parametrize("name", ["recall_index", "always_last"])
def test_classifier_matches(ring_setup, name):
    """`Classifier.classify` (segment-wise over the prefill, exiting at
    the strategy's node): labels, served nodes and counters equal."""
    cfg, params, tparams, prompt_len, cache_len = ring_setup
    je, te = _engines(cfg, params, tparams, name, cache_len)
    toks = np.random.default_rng(8).integers(0, cfg.vocab, (5, prompt_len))
    jr = JClassifier(params, cfg, je.strategy).classify(
        {"tokens": jnp.asarray(toks, jnp.int32)})
    with torch.no_grad():
        tr = TClassifier(tparams, cfg, te.strategy).classify(
            {"tokens": torch.from_numpy(toks)})
    for key in ("labels", "served_node"):
        np.testing.assert_array_equal(tr[key], np.asarray(jr[key]))
    for key in ("segments_run_batch", "segments_run_policy",
                "segments_full"):
        assert tr[key] == jr[key], key


# --------------------------------------------------------------------------
# the token-input GQA configs (smoke size): the dense tied ones (qk-norm,
# SwiGLU / GeLU, GQA, a 64-token window), qwen3-14b (untied, GQA 5:1)
# and phi3.5-moe (untied, MoE MLPs)
# --------------------------------------------------------------------------

# arch: (prompt_len, cache_len) of the ring cases; starcoder2's prompt
# outruns its 64-token window
DENSE = {"granite-3-2b": (12, 16), "qwen3-4b": (12, 16),
         "starcoder2-3b": (80, 96), "qwen3-14b": (12, 16),
         "phi3.5-moe-42b-a6.6b": (12, 16)}


@pytest.fixture(scope="module", params=sorted(DENSE))
def dense_setup(request):
    """(cfg, jax params, port params) of a token-input GQA config's
    smoke size; the port's registry holds the reference's config."""
    from repro_torch.configs import get_config as t_get_config
    torch.set_num_threads(2)
    cfg = get_config(request.param, smoke=True)
    assert repr(t_get_config(request.param, smoke=True)) == repr(cfg)
    assert repr(t_get_config(request.param)) == \
        repr(get_config(request.param))
    params = materialize(M.model_defs(cfg), jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, params))
    return cfg, params, tparams


def test_dense_prefill_matches(dense_setup):
    _check_prefill(*dense_setup)


@pytest.mark.parametrize("kernel", [False, True], ids=["gather", "kernel"])
def test_dense_prefill_chunks_then_decode_match(dense_setup, kernel):
    _check_chunks_then_decode(*dense_setup, kernel)


@pytest.mark.parametrize("use_flash", [False, True],
                         ids=["sdpa", "flash"])
def test_dense_prefill_ring_caches_match(dense_setup, use_flash):
    cfg = dense_setup[0]
    _check_prefill_ring(*dense_setup, *DENSE[cfg.name.removesuffix(
        "-smoke")], use_flash)


def test_dense_ring_decode_step_matches(dense_setup):
    cfg = dense_setup[0]
    _check_ring_decode(*dense_setup, *DENSE[cfg.name.removesuffix("-smoke")])
