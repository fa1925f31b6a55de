"""The port's other model families against the JAX package's, on their
smoke sizes, with the same numpy inputs and weights carried over by the
bridge: qwen3-14b (untied embeddings, GQA 5:1), musicgen-large
(embeds input), phi-3-vision-4.2b (multimodal: image embeds before the
text tokens, untied), phi3.5-moe-42b-a6.6b (MoE),
deepseek-v2-lite-16b (MLA attention and MoE with a shared expert) and
hymba-1.5b (the hybrid mixer: windowed GQA attention and SSD heads on
the same input).

Tolerances, stated per test:
  * parameter shape trees: EQUAL;
  * f32 tensors that never pass through the bf16 caches (prefill
    logits and node losses, the MoE layer's output): atol = rtol = 1e-5;
    the MoE aux losses rel 1e-5; router assignments EQUAL (the number
    that differ is printed: 0);
  * tensors downstream of the bf16 ring caches or the paged pool
    (decode logits, node losses): atol = rtol = 1e-3, the bf16 caches
    within atol = rtol = 1e-2 (one bf16 ulp) with equal positions; a
    hybrid block's f32 SSM state within 1e-3 and its bf16 conv window
    within one bf16 ulp;
  * the reference's own decode-after-prefill check (MLA's absorbed
    decode reads the bf16 latent cache, the S + 1 prefill recomputes in
    f32): 2.5e-2, its tolerance, on the port alone; the port's decode
    against the reference's on the same path: 1e-3;
  * forward_train: loss and metrics rel 1e-5, gradients per leaf within
    1e-4 x the leaf's largest entry (the frameworks sum in other
    orders);
  * checkpoints: leaves EQUAL.
Greedy tokens are EQUAL.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # hypothesis optional — property tests skip without it
    from conftest import hypothesis_stubs
    given, settings, st = hypothesis_stubs()

from repro.configs import get_config
from repro.models import attention as JA
from repro.models import model as JM
from repro.models import moe as JMOE
from repro.models.config import MoEConfig
from repro.models.param import ParamDef as JParamDef
from repro.models.param import materialize
from repro.training import checkpoint as jckpt
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config as t_get_config
from repro_torch.models import attention as TA
from repro_torch.models import model as TM
from repro_torch.models import moe as TMOE
from repro_torch.models.param import ParamDef, check_params, tree_leaves
from repro_torch.training import checkpoint as tckpt

F32 = dict(atol=1e-5, rtol=1e-5)
POOL = dict(atol=1e-3, rtol=1e-3)
BF16 = dict(atol=1e-2, rtol=1e-2)
FAMILIES = ("qwen3-14b", "musicgen-large", "phi-3-vision-4.2b",
            "phi3.5-moe-42b-a6.6b", "deepseek-v2-lite-16b", "hymba-1.5b")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _inputs(cfg, b, s, seed):
    """A numpy batch of ``s`` positions: tokens, embeds (N(0, 0.5)) or,
    multimodal, ``s - image_tokens`` text tokens after image embeds
    (N(0, 0.1))."""
    rng = np.random.default_rng(seed)
    if cfg.input_mode == "embeds":
        return {"embeds": (rng.normal(size=(b, s, cfg.d_model)) * 0.5)
                .astype(np.float32)}
    if cfg.input_mode == "multimodal":
        text = s - cfg.image_tokens
        return {"tokens": rng.integers(0, cfg.vocab, (b, text))
                .astype(np.int32),
                "image_embeds": (rng.normal(size=(b, cfg.image_tokens,
                                                  cfg.d_model)) * 0.1)
                .astype(np.float32)}
    return {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}


def _step_input(cfg, b, seed):
    """One decode position's input: a token or, embeds-input, an embed."""
    rng = np.random.default_rng(seed)
    if cfg.input_mode == "embeds":
        return {"embeds": (rng.normal(size=(b, cfg.d_model)) * 0.5)
                .astype(np.float32)}
    return {"tokens": rng.integers(0, cfg.vocab, (b,)).astype(np.int32)}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


@pytest.fixture(scope="module", params=FAMILIES)
def family(request):
    """(cfg, jax params, port params) of a family's smoke size; the
    port's registry holds the reference's configs, smoke and full."""
    torch.set_num_threads(2)
    cfg = get_config(request.param, smoke=True)
    assert repr(t_get_config(request.param, smoke=True)) == repr(cfg)
    assert repr(t_get_config(request.param)) == \
        repr(get_config(request.param))
    params = materialize(JM.model_defs(cfg), jax.random.PRNGKey(0))
    return cfg, params, params_from_numpy(_np(params))


# --------------------------------------------------------------------------
# parameter trees
# --------------------------------------------------------------------------

def _shapes(defs, path=""):
    """{path: shape} of a ParamDef tree (either package's)."""
    if isinstance(defs, (ParamDef, JParamDef)):
        return {path: tuple(defs.shape)}
    items = defs.items() if isinstance(defs, dict) else enumerate(defs)
    out = {}
    for k, v in items:
        out.update(_shapes(v, f"{path}/{k}"))
    return out


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_model_defs_shapes_match(arch, smoke):
    """The same leaves of the same shapes (``unembed`` where untied,
    ``embed`` where tokens come in or the output is tied, the experts'
    stacks, the MLA projections)."""
    cfg = get_config(arch, smoke=smoke)
    tdefs = _shapes(TM.model_defs(cfg))
    assert tdefs == _shapes(JM.model_defs(cfg))
    assert ("/unembed" in tdefs) == (not cfg.tie_embeddings)
    assert ("/embed/table" in tdefs) == (cfg.input_mode != "embeds"
                                         or cfg.tie_embeddings)


# --------------------------------------------------------------------------
# prefill, decode
# --------------------------------------------------------------------------

def _check_caches(tcaches, jcaches):
    """Ring caches: positions EQUAL, bf16 leaves within one bf16 ulp; a
    hybrid block's SSM state (f32) within 1e-3 and its conv window
    (bf16) within one bf16 ulp."""
    for tc, jc in zip(tcaches, jcaches):
        assert set(tc) == set(jc)
        assert set(tc["attn"]) == set(jc["attn"])
        for name, leaf in tc["attn"].items():
            ref = np.asarray(jc["attn"][name])
            if name == "pos":
                np.testing.assert_array_equal(leaf.numpy(), ref)
            else:
                np.testing.assert_allclose(leaf.float().numpy(),
                                           ref.astype(np.float32), **BF16)
        for name, leaf in tc.get("ssm", {}).items():
            ref = np.asarray(jc["ssm"][name]).astype(np.float32)
            np.testing.assert_allclose(leaf.float().numpy(), ref,
                                       **(POOL if name == "ssm" else BF16))


def test_family_prefill_matches(family):
    """Whole-prompt prefill into ring caches: logits, node losses and
    next positions (f32), ring caches (GQA k/v or MLA c_kv/k_rope)."""
    cfg, params, tparams = family
    batch = _inputs(cfg, 3, 12 + cfg.image_tokens, seed=1)
    lj, cj, nj, pj = JM.prefill(params, cfg, _j(batch), 24)
    with torch.no_grad():
        lt, ct, nt, pt = TM.prefill(tparams, cfg, _t(batch), 24)
    assert nt.shape == (3, cfg.n_ramps + 1)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **F32)
    np.testing.assert_allclose(nt.numpy(), np.asarray(nj), **F32)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    _check_caches(ct, cj)


def test_family_decode_step_matches(family):
    """Five full-depth decode steps on the ring caches (greedy tokens, or
    a seeded embed a step for the embeds-input model): logits and node
    losses within 1e-3, tokens equal, caches within a bf16 ulp."""
    cfg, params, tparams = family
    batch = _inputs(cfg, 3, 10 + cfg.image_tokens, seed=2)
    lj, cj, _, pj = JM.prefill(params, cfg, _j(batch), 32)
    with torch.no_grad():
        lt, ct, _, pt = TM.prefill(tparams, cfg, _t(batch), 32)
    tok = np.asarray(jnp.argmax(lj, axis=-1), np.int32)
    for step in range(5):
        inp = (_step_input(cfg, 3, seed=10 + step)
               if cfg.input_mode == "embeds" else {"tokens": tok})
        lj, cj, nj = JM.decode_step(params, cfg, _j(inp), cj, pj)
        with torch.no_grad():
            lt, ct, nt = TM.decode_step(tparams, cfg, _t(inp), ct, pt)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **POOL)
        np.testing.assert_allclose(nt.numpy(), np.asarray(nj), **POOL)
        tok = np.asarray(jnp.argmax(lj, axis=-1), np.int32)
        np.testing.assert_array_equal(
            torch.argmax(lt, dim=-1).numpy(), tok)
        pj, pt = pj + 1, pt + 1
    _check_caches(ct, cj)


@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_consistent_with_prefill(arch):
    """The reference's `test_decode_consistent_with_prefill` on the port
    (numpy inputs): the logits of [prefill(S) -> decode position S]
    match prefill(S + 1)'s last position within 2.5e-2 (the decode reads
    the bf16 caches — for MLA the absorbed decode over the bf16 latent —
    while the longer prefill recomputes in f32); and the port's decode
    logits equal the reference's within 1e-3."""
    cfg = get_config(arch, smoke=True)
    params = materialize(JM.model_defs(cfg), jax.random.PRNGKey(0))
    tparams = params_from_numpy(_np(params))
    s = 24
    full = _inputs(cfg, 2, s + 1 + cfg.image_tokens, seed=3)
    key = "embeds" if cfg.input_mode == "embeds" else "tokens"
    head = dict(full, **{key: full[key][:, :-1]})
    nxt = {key: full[key][:, -1]}
    _, cj, _, pj = JM.prefill(params, cfg, _j(head), 40)
    dec_j, _, _ = JM.decode_step(params, cfg, _j(nxt), cj, pj)
    with torch.no_grad():
        _, ct, _, pt = TM.prefill(tparams, cfg, _t(head), 40)
        dec_t, _, _ = TM.decode_step(tparams, cfg, _t(nxt), ct, pt)
        ref_t, _, _, _ = TM.prefill(tparams, cfg, _t(full), 40)
    np.testing.assert_allclose(dec_t.numpy(), ref_t.numpy(), atol=2.5e-2,
                               rtol=2.5e-2)
    np.testing.assert_allclose(dec_t.numpy(), np.asarray(dec_j), **POOL)


# --------------------------------------------------------------------------
# MLA on the paged pool
# --------------------------------------------------------------------------

def _pools(cfg, jspecs, tspecs):
    def jmat(spec, key=None):
        if isinstance(spec, dict):
            return {k: jmat(v, k) for k, v in spec.items()}
        shape, dtype = spec
        return (jnp.full(shape, -1, dtype) if key == "pos"
                else jnp.zeros(shape, dtype))

    def tmat(spec, key=None):
        if isinstance(spec, dict):
            return {k: tmat(v, k) for k, v in spec.items()}
        shape, dtype = spec
        return (torch.full(shape, -1, dtype=dtype) if key == "pos"
                else torch.zeros(shape, dtype=dtype))

    return [jmat(s) for s in jspecs], [tmat(s) for s in tspecs]


@pytest.mark.parametrize("kernel", [False, True], ids=["gather", "kernel"])
def test_mla_paged_decode_matches_reference(kernel):
    """deepseek-v2-lite's MLA decode on the paged pool, token by token
    from empty pages (lane 1 masked out of steps 2 and 5, so its writes
    go to the garbage page): every segment's hidden and readout within
    1e-3 of the reference's page-gather decode, pools within a bf16 ulp
    with equal positions.  Each step starts from the reference's pool:
    a latent both packages compute in f32 may round to bf16 values one
    ulp apart, and a flip carried into later steps would compare the
    rounding, not the decode.  The paged-kernel switch changes nothing for
    MLA (the kernels take GQA only), and the port's paged decode gives
    what its ring decode gives on the same tokens, within 1e-5."""
    cfg = get_config("deepseek-v2-lite-16b", smoke=True)
    params = materialize(JM.model_defs(cfg), jax.random.PRNGKey(0))
    tparams = params_from_numpy(_np(params))
    b, ps, lane_pages = 3, 4, 3
    n_pages = b * lane_pages + 1
    table = (np.arange(1, lane_pages + 1)[None, :]
             + np.arange(b)[:, None] * lane_pages).astype(np.int32)
    jc, tc = _pools(cfg, JM.paged_cache_specs(cfg, b, n_pages, ps),
                    TM.paged_cache_specs(cfg, b, n_pages, ps))
    assert set(tc[0]["attn"]) == {"c_kv", "k_rope", "pos"}
    ring = [{"attn": {k: (torch.full(s, -1, dtype=d) if k == "pos"
                          else torch.zeros(s, dtype=d))
                      for k, (s, d) in spec["attn"].items()}}
            for spec in TM.cache_specs(cfg, b, lane_pages * ps)]
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (b, 9))
    for t in range(9):
        pos = np.full((b,), t, np.int32)
        wmask = np.asarray([True, t not in (2, 5), True])
        jkv = JA.PagedKV(jnp.asarray(table),
                         jnp.asarray(table[:, t // ps]),
                         jnp.asarray(np.full((b,), t % ps, np.int32)))
        tkv = TA.PagedKV(torch.from_numpy(table),
                         torch.from_numpy(table[:, t // ps].copy()),
                         torch.from_numpy(np.full((b,), t % ps, np.int32)))
        xj = params["embed"]["table"][toks[:, t]][:, None, :]
        xt = tparams["embed"]["table"][torch.from_numpy(toks[:, t])][:, None]
        xr = xt
        for tcs, jcs in zip(tc, jc):
            for name, leaf in tcs["attn"].items():
                leaf.copy_(torch.from_numpy(
                    np.asarray(jcs["attn"][name], np.float32)))
        with torch.no_grad(), TA.paged_kernel(kernel):
            for si in range(len(cfg.segments)):
                xj, jc[si], roj = JM.decode_segment(
                    params, cfg, si, xj, jc[si], jnp.asarray(pos),
                    paged=jkv, write_mask=jnp.asarray(wmask))
                xt, _, rot = TM.decode_segment(
                    tparams, cfg, si, xt, tc[si], torch.from_numpy(pos),
                    paged=tkv, write_mask=torch.from_numpy(wmask))
                xr, _, _ = TM.decode_segment(tparams, cfg, si, xr,
                                             ring[si],
                                             torch.from_numpy(pos))
                np.testing.assert_allclose(xt.numpy(), np.asarray(xj),
                                           **POOL)
                if rot is not None:
                    for a, r in zip(rot, roj):
                        np.testing.assert_allclose(a.numpy(), np.asarray(r),
                                                   **POOL)
        # the ring has every lane's write; compare the lanes that wrote
        # every step
        keep = [0, 2]
        np.testing.assert_allclose(xt.numpy()[keep], xr.numpy()[keep], **F32)
    for tcs, jcs in zip(tc, jc):
        for name, leaf in tcs["attn"].items():
            ref = np.asarray(jcs["attn"][name])[:, 1:]
            if name == "pos":
                np.testing.assert_array_equal(leaf[:, 1:].numpy(), ref)
            else:
                np.testing.assert_allclose(leaf[:, 1:].float().numpy(),
                                           ref.astype(np.float32), **BF16)
        assert (tcs["attn"]["pos"][:, 0] == -1).all()


def test_mla_refuses_chunked_prefill():
    """As in the reference: an MLA segment has no prefill chunk, and the
    stepper refuses --prefill-chunk for it before any compute."""
    from repro_torch.serving import runtime as trt
    from repro_torch import strategy as tstrategy
    cfg = t_get_config("deepseek-v2-lite-16b", smoke=True)
    attn = cfg.segments[0].block.attn
    with pytest.raises(NotImplementedError, match="MLA"):
        TA.attn_prefill_chunk({}, torch.zeros(1, 2, cfg.d_model), {}, attn,
                              1e-5, None, None)
    from repro_torch.models.param import materialize as tmat
    tp = tmat(TM.model_defs(cfg), torch.Generator().manual_seed(0), "cpu")
    strat = tstrategy.make("always_last", tstrategy.Cascade.uniform(
        cfg.n_ramps + 1))
    with pytest.raises(ValueError, match="chunked prefill"):
        trt.EngineStepper(tp, cfg, (strat,), n_lanes=2, cache_len=16,
                          prompt_len=8, kv="paged", page_size=4,
                          prefill_chunk=4)


# --------------------------------------------------------------------------
# the MoE layer
# --------------------------------------------------------------------------

def _moe_pair(cfg, d, act, seed):
    p = materialize(JMOE.moe_defs(cfg, d, act), jax.random.PRNGKey(seed))
    return p, params_from_numpy(_np(p))


def _assignments(p, x, cfg):
    """The reference's routing of x (B, S, D), as its moe_forward does
    it: grouped, f32 softmax, lax.top_k."""
    b, s, d = x.shape
    g, ng = JMOE._group_shape(b, s)
    logits = (jnp.asarray(x).reshape(g, ng, d) @ p["router"]).astype(
        jnp.float32)
    return np.asarray(jax.lax.top_k(jax.nn.softmax(logits, axis=-1),
                                    cfg.top_k)[1])


MOE_CASES = {
    # name: (MoEConfig kwargs, d, act, x shape)
    "swiglu": (dict(num_experts=4, top_k=2, d_ff_expert=32,
                    capacity_factor=4.0), 16, "swiglu", (2, 12, 16)),
    "drops": (dict(num_experts=4, top_k=2, d_ff_expert=32,
                   capacity_factor=0.5), 16, "swiglu", (2, 40, 16)),
    "shared-gelu": (dict(num_experts=8, top_k=3, d_ff_expert=16,
                         num_shared=2, d_ff_shared=24), 16, "gelu",
                    (3, 20, 16)),
    "decode-group": (dict(num_experts=8, top_k=2, d_ff_expert=16,
                          capacity_factor=1.25), 16, "swiglu", (12, 1, 16)),
}


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_forward_matches_reference(case):
    """`moe_forward` on numpy inputs: every router assignment EQUAL to
    the reference's (lax.top_k against the port's stable sort), the
    output within 1e-5 and the aux losses within rel 1e-5 — with drops
    (cf 0.5: 40 tokens x 2 over 4 experts of 10 slots), a shared expert,
    and decode's one group of 12 lanes (cap 8 of 24 assignments)."""
    kw, d, act, shape = MOE_CASES[case]
    cfg = MoEConfig(**kw)
    p, tp = _moe_pair(cfg, d, act, seed=sorted(MOE_CASES).index(case))
    x = np.random.default_rng(5).normal(size=shape).astype(np.float32)
    yj, auxj = JMOE.moe_forward(p, jnp.asarray(x), cfg, act)
    with torch.no_grad():
        yt, auxt = TMOE.moe_forward(tp, torch.from_numpy(x), cfg, act)
        g, ng = TMOE._group_shape(*shape[:2])
        _, _, _, assign = TMOE.route(tp, torch.from_numpy(x).reshape(
            g, ng, d), cfg)
    differ = int((assign.numpy() != _assignments(p, x, cfg)).sum())
    assert differ == 0, f"{differ} router assignments differ"
    if case == "drops":
        cap = TMOE.capacity(cfg, shape[1])
        counts = np.stack([np.bincount(a.ravel(), minlength=4)
                           for a in assign.numpy()])
        assert cap == 10 and (counts > cap).any()      # some are dropped
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **F32)
    assert set(auxt) == set(auxj)
    for k in auxj:
        assert float(auxt[k]) == pytest.approx(float(auxj[k]), rel=1e-5), k
    _, empty = TMOE.moe_forward(tp, torch.from_numpy(x), cfg, act,
                                with_aux=False)
    assert empty == {}


def test_moe_pad_rows_never_displace_real_rows():
    """A prefill chunk routes each lane as its own group, with its pad
    rows (position -1, whose values differ between the packages) after
    its real rows.  The stable sort by expert keeps token order, so an
    expert short of slots drops pad rows first: with drops forced (cf
    0.5), the real rows' outputs are EQUAL whatever the pad rows hold."""
    cfg = MoEConfig(num_experts=4, top_k=2, d_ff_expert=16,
                    capacity_factor=0.5)
    d, real = 8, 10
    _, tp = _moe_pair(cfg, d, "swiglu", seed=3)
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 16, d)).astype(np.float32)
    outs = []
    for fill in (np.zeros, lambda shape: rng.normal(size=shape) * 4):
        xx = x.copy()
        xx[:, real:] = fill((2, 16 - real, d))
        with torch.no_grad():
            outs.append(TMOE.moe_forward(tp, torch.from_numpy(xx), cfg,
                                         "swiglu")[0][:, :real])
            assign = TMOE.route(tp, torch.from_numpy(xx), cfg)[3]
        counts = np.stack([np.bincount(a.ravel(), minlength=4)
                           for a in assign.numpy()])
        assert (counts > 8).any()                 # some rows are dropped
    assert TMOE.capacity(cfg, 16) == 8            # 32 assignments, 4 x 8
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)


def test_moe_matches_per_token_reference():
    """The reference's test on the port: sort-based dispatch equals
    looping tokens through their top-k experts (no capacity drops at cf
    4), atol = rtol = 1e-4."""
    cfg = MoEConfig(num_experts=4, top_k=2, d_ff_expert=32,
                    capacity_factor=4.0)
    d = 16
    _, tp = _moe_pair(cfg, d, "swiglu", seed=0)
    x = (0.5 * np.random.default_rng(1).normal(size=(2, 6, d))).astype(
        np.float32)
    with torch.no_grad():
        y, aux = TMOE.moe_forward(tp, torch.from_numpy(x), cfg, "swiglu")
    pn = {k: v.numpy() for k, v in tp.items()}
    xf = x.reshape(-1, d)
    logits = xf @ pn["router"]
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    top_e = np.argsort(-probs, axis=-1, kind="stable")[:, :2]
    top_w = np.take_along_axis(probs, top_e, -1)
    top_w /= top_w.sum(-1, keepdims=True)
    ref = np.zeros_like(xf)
    for t in range(xf.shape[0]):
        for j in range(2):
            e = top_e[t, j]
            up = xf[t] @ pn["w_up"][e]
            gate = xf[t] @ pn["w_gate"][e]
            h = gate / (1 + np.exp(-gate)) * up
            ref[t] += top_w[t, j] * (h @ pn["w_down"][e])
    np.testing.assert_allclose(y.numpy().reshape(-1, d), ref, atol=1e-4,
                               rtol=1e-4)
    assert float(aux["moe_load_balance"]) > 0


def test_moe_capacity_drops_dont_crash():
    """The reference's test on the port (cf 0.3 forces drops): finite,
    and equal to the reference's output within 1e-5."""
    cfg = MoEConfig(num_experts=4, top_k=2, d_ff_expert=16,
                    capacity_factor=0.3)
    d = 8
    p, tp = _moe_pair(cfg, d, "gelu", seed=0)
    x = np.random.default_rng(2).normal(size=(1, 32, d)).astype(np.float32)
    with torch.no_grad():
        y, _ = TMOE.moe_forward(tp, torch.from_numpy(x), cfg, "gelu")
    assert np.isfinite(y.numpy()).all()
    yj, _ = JMOE.moe_forward(p, jnp.asarray(x), cfg, "gelu")
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), **F32)


@settings(max_examples=15, deadline=None)
@given(st.integers(0, 10_000), st.integers(2, 8), st.integers(1, 3),
       st.integers(2, 6), st.floats(0.3, 4.0))
def test_moe_dispatch_invariants(seed, e, k_raw, seq, cf):
    """`tests/test_props.py::test_moe_dispatch_invariants` on the port:
    shape kept, finite, load balance >= 0, zero input -> zero output;
    and the output equals the reference's within 1e-5."""
    k = min(k_raw, e)
    cfg = MoEConfig(num_experts=e, top_k=k, d_ff_expert=8,
                    capacity_factor=cf)
    d = 8
    p, tp = _moe_pair(cfg, d, "gelu", seed=seed)
    x = np.random.default_rng(seed).normal(0, 1, (2, seq, d)).astype(
        np.float32)
    with torch.no_grad():
        y, aux = TMOE.moe_forward(tp, torch.from_numpy(x), cfg, "gelu")
        y0, _ = TMOE.moe_forward(tp, torch.zeros_like(torch.from_numpy(x)),
                                 cfg, "gelu")
    assert y.shape == x.shape
    assert np.isfinite(y.numpy()).all()
    assert float(aux["moe_load_balance"]) >= 0
    np.testing.assert_allclose(y0.numpy(), 0.0, atol=1e-6)
    yj, _ = JMOE.moe_forward(p, jnp.asarray(x), cfg, "gelu")
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), **F32)


# --------------------------------------------------------------------------
# training
# --------------------------------------------------------------------------

def _train_batch(cfg, seed=0, b=2, s=17):
    """Inputs of ``s`` positions and next-token labels; the labels over
    a multimodal model's image embeds are -100 (masked), and, for the
    embeds-input model, labels are drawn over the vocab."""
    batch = _inputs(cfg, b, s, seed)
    rng = np.random.default_rng(seed + 100)
    labels = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    if cfg.input_mode == "multimodal":
        labels[:, :cfg.image_tokens] = -100
    labels[0, -2:] = -1
    batch["labels"] = labels
    return batch


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no-remat"])
def test_family_forward_train_matches(family, remat):
    """forward_train: loss and every metric (the MoE configs' weighted
    ``moe_load_balance`` and ``moe_router_z`` among them) within rel
    1e-5, every gradient leaf within 1e-4 x its largest entry."""
    cfg, params, tparams = family
    batch = _train_batch(cfg, s=13 + cfg.image_tokens)
    (_, jm), jg = jax.value_and_grad(
        lambda p: JM.forward_train(p, cfg, _j(batch), remat=remat),
        has_aux=True)(params)
    tp = params_from_numpy(_np(params))
    leaves = tree_leaves(tp)
    for t in leaves:
        t.requires_grad_()
    tl, tm = TM.forward_train(tp, cfg, _t(batch), remat=remat)
    tg = torch.autograd.grad(tl, leaves)
    moe = any(seg.block.mlp == "moe" for seg in cfg.segments)
    assert set(tm) == set(jm)
    assert ("moe_load_balance" in tm) == ("moe_router_z" in tm) == moe
    for k in jm:
        assert float(tm[k].detach()) == pytest.approx(float(jm[k]),
                                                      rel=1e-5), k
    jl = jax.tree.leaves(jg)
    assert len(jl) == len(tg)
    for a, g in zip(jl, tg):
        a = np.asarray(a, np.float32)
        err = float(np.abs(a - g.numpy()).max())
        assert err <= 1e-4 * float(np.abs(a).max()) + 1e-12, \
            (err, float(np.abs(a).max()))


# --------------------------------------------------------------------------
# bridge and checkpoints
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen3-14b", "phi3.5-moe-42b-a6.6b",
                                  "deepseek-v2-lite-16b", "hymba-1.5b"])
def test_checkpoints_and_bridge_carry_the_new_leaves(arch, tmp_path):
    """The untied ``unembed``, the experts' stacks, the MLA leaves and
    the hybrid block's (``attn``, ``ssm``, ``attn_out_norm``,
    ``ssm_out_norm``) need nothing new: the bridge carries them from numpy (the port's
    `check_params` accepts the tree, every leaf equal), and a smoke
    checkpoint is read both ways, every leaf EQUAL."""
    cfg = get_config(arch, smoke=True)
    params = _np(materialize(JM.model_defs(cfg), jax.random.PRNGKey(0)))
    tparams = params_from_numpy(params)
    check_params(TM.model_defs(cfg), tparams)
    want = jax.tree.leaves(params)
    for a, b in zip(want, tree_leaves(tparams)):
        np.testing.assert_array_equal(a, b.numpy())
    jpath = jckpt.save(str(tmp_path / "ref" / "state_1.ckpt"),
                       {"params": params}, 1)
    tpath = tckpt.save(str(tmp_path / "port" / "state_1.ckpt"),
                       {"params": tparams}, 1)
    tree, _ = tckpt.load(jpath)
    check_params(TM.model_defs(cfg), params_from_numpy(tree["params"]))
    got = tree_leaves(tree["params"])
    assert len(got) == len(want)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(a, np.asarray(b))
    tree, _ = jckpt.load(tpath)
    for a, b in zip(want, jax.tree.leaves(tree["params"])):
        np.testing.assert_array_equal(a, np.asarray(b))
