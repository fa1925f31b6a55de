"""hymba-1.5b's hybrid mixer, the int8 KV cache, the long-prompt
attention (query-chunked and banded) and the analytic counts of the port
against the JAX package's, on the same numpy inputs and weights carried
over by the bridge.  (The hybrid smoke model's prefill, decode and
forward_train parity are in `tests/test_torch_families.py`, its serves
in `tests/test_torch_serve.py`.)

Tolerances, stated per test:
  * configs, ``ASSIGNED``, parameter counts, logical axes, model FLOPs,
    cache lengths: EQUAL;
  * int8 rows from the same f32 or bf16 values (``quantize_rows``, the
    ring a prefill builds from the same K/V): codes and bf16 scales
    EQUAL;
  * int8 caches each package's own prefill builds: codes within 1 and
    scales within one bf16 ulp (the f32 K/V the two frameworks compute
    may round to bf16 one ulp apart), the count of codes that differ
    printed; decode logits within 1e-3 of the reference's int8 decode;
    the reference's own rule against the bf16 cache, error < 0.05 x
    max |logit| + 0.05; a decode from the reference's own int8 caches
    within 1e-3 of the reference's decode (a code one step off moves a
    logit by up to a scale's worth, about 1% of the row's amax, so the
    decode is compared on the same caches);
  * the long-prompt paths: 2e-5 (the reference's test), prefill logits
    through them 1e-5;
  * the hybrid decode's masked lanes: SSM state and ring slots EQUAL
    (bit for bit) to what they held;
  * served tokens, served nodes and segment counters: EQUAL.
"""

import dataclasses

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

from repro import configs as jconfigs
from repro import strategy as jstrategy
from repro.launch import flops as jflops
from repro.launch import serve as jserve
from repro.launch import shapes as jshapes
from repro.models import attention as JA
from repro.models import blocks as JB
from repro.models import model as JM
from repro.models import quant as JQ
from repro.models.param import count_params as jcount
from repro.models.param import logical_specs as jlogical
from repro.models.param import materialize
from repro.serving import runtime as jrt
from repro_torch import configs as tconfigs
from repro_torch import strategy as tstrategy
from repro_torch.bridge import params_from_numpy
from repro_torch.launch import flops as tflops
from repro_torch.launch import serve as tserve
from repro_torch.launch import shapes as tshapes
from repro_torch.models import attention as TA
from repro_torch.models import blocks as TB
from repro_torch.models import model as TM
from repro_torch.models import quant as TQ
from repro_torch.models.param import abstract, count_params, logical_specs
from repro_torch.models.param import tree_leaves
from repro_torch.serving import engine as teng
from repro_torch.serving import runtime as trt

F32 = dict(atol=1e-5, rtol=1e-5)
POOL = dict(atol=1e-3, rtol=1e-3)
ARCHS = tuple(jconfigs.ASSIGNED) + ("paper-ee-100m",)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _pair(arch, seed=0):
    cfg = jconfigs.get_config(arch, smoke=True)
    params = materialize(JM.model_defs(cfg), jax.random.PRNGKey(seed))
    return cfg, params, params_from_numpy(_np(params))


def _toks(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)) \
        .astype(np.int32)


# --------------------------------------------------------------------------
# the config, the hybrid block
# --------------------------------------------------------------------------

def test_registry_holds_the_reference_configs():
    """``ASSIGNED`` is the reference's list in its order, and hymba-1.5b
    (the last config the port lacked) equals the reference's, smoke and
    full."""
    assert tconfigs.ASSIGNED == jconfigs.ASSIGNED
    assert set(tconfigs.REGISTRY) == set(jconfigs.REGISTRY)
    for smoke in (True, False):
        assert repr(tconfigs.get_config("hymba-1.5b", smoke=smoke)) == \
            repr(jconfigs.get_config("hymba-1.5b", smoke=smoke))


def test_hybrid_decode_keeps_masked_lanes_bits():
    """One hybrid segment decoding on the ring with lane 1 masked out
    (``write_mask`` for its SSM state, the engine's `_ring_slots` /
    `_mask_lane_writes` for its ring slot): lane 1's conv and SSM state
    and every ring leaf are EQUAL to what they held; lanes 0 and 2
    changed, and their hidden states are within 1e-3 of the reference's
    decode of the same segment (which updates every lane)."""
    cfg, params, tparams = _pair("hymba-1.5b")
    toks = _toks(cfg, 3, 9, seed=1)
    _, jc, _, jpos = JM.prefill(params, cfg, {"tokens": jnp.asarray(toks)},
                                16)
    with torch.no_grad():
        _, tc, _, tpos = TM.prefill(tparams, cfg,
                                    {"tokens": torch.from_numpy(toks)}, 16)
        x0 = tparams["embed"]["table"][torch.tensor([3, 5, 7])][:, None]
        before = [{k: {n: t.clone() for n, t in tree.items()}
                   for k, tree in seg.items()} for seg in tc]
        active = torch.tensor([True, False, True])
        saved = teng._ring_slots(tc[0], tpos)
        xt, _, _ = TM.decode_segment(tparams, cfg, 0, x0, tc[0], tpos,
                                     write_mask=active)
        teng._mask_lane_writes(tc[0], saved, tpos, active)
    xj, _, _ = JM.decode_segment(
        params, cfg, 0, params["embed"]["table"][jnp.asarray([3, 5, 7])]
        [:, None], jc[0], jpos)
    np.testing.assert_allclose(xt.numpy()[[0, 2]], np.asarray(xj)[[0, 2]],
                               **POOL)
    for key in ("attn", "ssm"):
        for name, leaf in tc[0][key].items():
            old = before[0][key][name]
            assert torch.equal(leaf[:, 1], old[:, 1]), (key, name)
            if key == "ssm":
                assert not torch.equal(leaf[:, 0], old[:, 0]), name


def test_prefill_chunk_refused_for_the_hybrid_mixer():
    """Both packages refuse --prefill-chunk for a hybrid model with the
    same message; the port's launcher refuses it before it makes weights
    or calibrates; a hybrid block has no prefill chunk."""
    cfg, params, tparams = _pair("hymba-1.5b")
    n = cfg.n_ramps + 1
    kw = dict(n_lanes=2, cache_len=32, prompt_len=12, kv="paged",
              page_size=8, prefill_chunk=4)
    with pytest.raises(ValueError) as jerr:
        jrt.EngineStepper(params, cfg, (jstrategy.make(
            "always_last", jstrategy.Cascade.uniform(n)),), **kw)
    with pytest.raises(ValueError) as terr:
        trt.EngineStepper(tparams, cfg, (tstrategy.make(
            "always_last", tstrategy.Cascade.uniform(n)),), **kw)
    assert str(terr.value) == str(jerr.value)
    assert "'hybrid'" in str(terr.value)
    with pytest.raises(ValueError, match="chunked prefill"):
        tserve.main(["--arch", "hymba-1.5b", "--smoke", "--device", "cpu",
                     "--server", "--kv", "paged", "--prefill-chunk", "8",
                     "--ckpt", "/nonexistent/never-read.ckpt"])
    with pytest.raises(NotImplementedError, match="hybrid"):
        TB.block_prefill_chunk({}, torch.zeros(1, 2, cfg.d_model), {},
                               cfg.segments[0].block, 1e-5, None, None)


# --------------------------------------------------------------------------
# int8 KV
# --------------------------------------------------------------------------

def test_quantize_rows_equals_the_reference():
    """Codes and scales EQUAL to the reference's on f32 and bf16 rows,
    among them rows whose quotients fall exactly on .5 (rounded half to
    even by both), an all-zero row (scale 1e-8) and a row at ±127 x
    scale; dequantized rows EQUAL in f32 and in bf16."""
    rng = np.random.default_rng(0)
    x = rng.normal(0, 2, (6, 5, 64)).astype(np.float32)
    x[0, 0] = 0.0
    x[0, 1, :4] = [127.0, -127.0, 0.5, 2.5]          # scale 1: ties
    x[0, 1, 4:] = 0.0
    x[0, 2, :4] = [254.0, 3.0, 5.0, -1.0]            # scale 2: .5 ties
    x[0, 2, 4:] = 0.0
    for dt in (np.float32, "bf16"):
        jx = jnp.asarray(x) if dt is np.float32 else \
            jnp.asarray(x).astype(jnp.bfloat16)
        tx = torch.from_numpy(x) if dt is np.float32 else \
            torch.from_numpy(x).to(torch.bfloat16)
        jq, js = JQ.quantize_rows(jx)
        tq, ts = TQ.quantize_rows(tx)
        assert tq.dtype == torch.int8 and ts.dtype == torch.bfloat16
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.float().numpy(),
                                      np.asarray(js, np.float32))
        for jout, tout in ((jnp.float32, torch.float32),
                           (jnp.bfloat16, torch.bfloat16)):
            np.testing.assert_array_equal(
                TQ.dequantize_rows(tq, ts, tout).float().numpy(),
                np.asarray(JQ.dequantize_rows(jq, js, jout), np.float32))
    assert TQ.dequantize_rows(tq, ts).dtype == torch.bfloat16
    np.testing.assert_array_equal(
        TQ.quantize_rows(torch.tensor([[1.0, -2.5, 0.5, 127.0]]))[0]
        .numpy(), [[1, -2, 0, 127]])


@settings(max_examples=30, deadline=None)
@given(st.integers(0, 10_000), st.integers(1, 8), st.integers(1, 256),
       st.floats(1e-3, 1e3))
def test_quant_roundtrip_bounded_error(seed, rows, d, scale):
    """`tests/test_props.py::test_quant_roundtrip_bounded_error` on the
    port: int8 codes and bf16 scales, the round trip within amax/127 +
    1% amax + 1e-6 a row; and codes and scales EQUAL to the
    reference's."""
    x = np.random.default_rng(seed).normal(0, scale, (rows, d)) \
        .astype(np.float32)
    q, s = TQ.quantize_rows(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.bfloat16
    y = TQ.dequantize_rows(q, s, torch.float32).numpy()
    amax = np.abs(x).max(axis=-1, keepdims=True)
    assert (np.abs(y - x) <= amax / 127 + 0.01 * amax + 1e-6).all()
    jq, js = JQ.quantize_rows(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.float().numpy(),
                                  np.asarray(js, np.float32))


@pytest.mark.parametrize("arch", ["qwen3-4b", "deepseek-v2-lite-16b"])
def test_int8_ring_cache_equals_the_reference(arch):
    """`build_ring_cache` under `cache_int8` from the same f32 prefill
    outputs (GQA k/v; MLA c_kv/k_rope), 20 positions into a 16-slot
    ring: every leaf EQUAL to the reference's, the int8 layout of
    `init_cache_defs` (dtypes and shapes) the reference's."""
    cfg = jconfigs.get_config(arch, smoke=True)
    a = cfg.segments[0].block.attn
    rng = np.random.default_rng(3)
    b, s, c = 2, 20, 16
    if a.mla is not None:
        kv = {"c_kv": rng.normal(size=(b, s, a.mla.kv_lora_rank)),
              "k_rope": rng.normal(size=(b, s, a.mla.qk_rope_head_dim))}
    else:
        kv = {"k": rng.normal(size=(b, s, a.n_kv_heads, a.head_dim)),
              "v": rng.normal(size=(b, s, a.n_kv_heads, a.head_dim))}
    kv = {k: v.astype(np.float32) for k, v in kv.items()}
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
    with JQ.cache_int8(True):
        jring = JB.build_ring_cache(
            {"attn_kv": {k: jnp.asarray(v) for k, v in kv.items()}},
            jnp.asarray(pos), cfg.segments[0].block, c)["attn"]
        jdefs = JA.init_cache_defs(a, b, c)
    with TQ.cache_int8():
        tring = TB.build_ring_cache(
            {"attn_kv": {k: torch.from_numpy(v) for k, v in kv.items()}},
            torch.from_numpy(pos.copy()), c)["attn"]
        tdefs = TA.init_cache_defs(a, b, c)
    assert not TQ.int8_enabled()
    assert set(tring) == set(jring) == set(tdefs)
    for name, leaf in tring.items():
        np.testing.assert_array_equal(
            leaf.float().numpy(), np.asarray(jring[name], np.float32), name)
        shape, dtype = tdefs[name]
        assert tuple(leaf.shape) == shape == tuple(jdefs[name][0])
        assert leaf.dtype == dtype
        assert np.dtype(jdefs[name][1]).name == \
            str(dtype).removeprefix("torch.")


def _to_port(tree):
    """A JAX cache tree as the port's tensors, every value kept (bf16
    through f32, which holds it exactly)."""
    if isinstance(tree, dict):
        return {k: _to_port(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_port(v) for v in tree]
    if tree.dtype == jnp.bfloat16:
        return torch.from_numpy(np.asarray(tree, np.float32)).to(
            torch.bfloat16)
    return torch.from_numpy(np.array(tree))


def _code_diff(tc, jc):
    """(codes that differ, largest code difference, largest scale
    difference in bf16 ulps) over every int8 ring leaf."""
    n = worst = 0
    ulps = 0.0
    for tseg, jseg in zip(tc, jc):
        for name, leaf in tseg["attn"].items():
            ref = np.asarray(jseg["attn"][name], np.float32)
            got = leaf.float().numpy()
            if leaf.dtype == torch.int8:
                d = np.abs(got - ref)
                n += int((d > 0).sum())
                worst = max(worst, int(d.max()))
            elif name.endswith("_s"):
                ulp = 2.0 ** (np.floor(np.log2(np.maximum(ref, 1e-30))) - 7)
                ulps = max(ulps, float((np.abs(got - ref) / ulp).max()))
    return n, worst, ulps


@pytest.mark.parametrize("arch", ["qwen3-4b", "deepseek-v2-lite-16b",
                                  "hymba-1.5b"])
def test_int8_cache_decode_close_to_bf16(arch):
    """The reference's `test_int8_cache_decode_close_to_bf16` on the port
    (numpy tokens): the int8 layout (int8 leaves beside their scales)
    survives a decode, and the int8 decode's logits are within 0.05 x
    max |logit| + 0.05 of the bf16 cache's; and against the reference's
    int8 path: the caches' codes within 1 and scales within one bf16
    ulp; from the reference's own int8 caches, the port's decode logits
    within 1e-3 of the reference's, the slots it writes within a code."""
    cfg, params, tparams = _pair(arch)
    toks = _toks(cfg, 2, 24, seed=7)
    head = {"tokens": toks[:, :-1]}
    step = {"tokens": toks[:, -1]}
    tb = {k: torch.from_numpy(v) for k, v in head.items()}
    ts = {k: torch.from_numpy(v) for k, v in step.items()}
    with torch.no_grad():
        _, caches, _, pos = TM.prefill(tparams, cfg, tb, 32)
        l_ref, _, _ = TM.decode_step(tparams, cfg, ts, caches, pos)
        with TQ.cache_int8():
            _, caches8, _, pos8 = TM.prefill(tparams, cfg, tb, 32)
            dtypes = {t.dtype for t in tree_leaves(caches8)}
            assert torch.int8 in dtypes
            l_q, caches8, _ = TM.decode_step(tparams, cfg, ts, caches8, pos8)
            assert {t.dtype for t in tree_leaves(caches8)} == dtypes
    scale = float(l_ref.abs().max())
    err = float((l_q - l_ref).abs().max())
    assert err < 0.05 * scale + 0.05, (err, scale)
    with JQ.cache_int8(True):
        _, jc, _, jpos = JM.prefill(params, cfg, {"tokens": jnp.asarray(
            head["tokens"])}, 32)
        from_ref = _to_port(jc)
        jl, jc, _ = JM.decode_step(params, cfg, {"tokens": jnp.asarray(
            step["tokens"])}, jc, jpos)
    n, worst, ulps = _code_diff(caches8, jc)
    print(f"{arch}: {n} int8 codes differ (by at most {worst}); scales "
          f"within {ulps:.2f} bf16 ulp")
    assert worst <= 1 and ulps <= 1.0
    with torch.no_grad():
        lt, from_ref, _ = TM.decode_step(tparams, cfg, ts, from_ref,
                                         torch.from_numpy(np.array(jpos)))
    np.testing.assert_allclose(lt.numpy(), np.asarray(jl), **POOL)
    assert _code_diff(from_ref, jc)[1] <= 1


@pytest.mark.parametrize("arch,chunk", [("qwen3-4b", 5), ("hymba-1.5b", None)],
                         ids=["qwen3-chunked", "hymba-stw"])
def test_int8_paged_serve_equals_the_reference(arch, chunk, monkeypatch):
    """A paged serve under `cache_int8` in both packages — qwen3-4b with
    chunked prefill, hymba-1.5b stop-the-world — with the port's
    paged-kernel switch on: the int8 pool takes the page gather (the
    kernels' wrappers are never called), and per request tokens and
    served nodes are EQUAL to the reference's, as are the segment
    counters and the pool stats; the pool's K/V leaves are int8 beside
    bf16 scales."""
    from test_torch_serve import (PROMPT_LEN, _factory, _requests,
                                  _serve_logged, _setup)
    from repro.serving.runtime.request import Request as JRequest
    from repro_torch.serving.runtime.request import Request as TRequest

    cfg, params, casc, tparams, tcasc = _setup(arch)
    kw = dict(n_lanes=2, cache_len=32, prompt_len=PROMPT_LEN, kv="paged",
              page_size=8, prefill_chunk=chunk,
              prefill_budget=8 if chunk else None)
    with JQ.cache_int8(True):
        jreqs = _requests(JRequest, cfg)
        bank, sid_of = jrt.build_bank(jreqs, _factory(jserve, casc),
                                      ("recall_index", None))
        jst = jrt.EngineStepper(params, cfg, bank, **kw)
        jm, jnodes = _serve_logged(jrt, jst, sid_of, jreqs)

    def refuse(*a, **k):
        raise AssertionError("a paged kernel was called on an int8 pool")

    monkeypatch.setattr(TA, "paged_attention", refuse)
    monkeypatch.setattr(TA, "paged_prefill", refuse)
    requests = _requests(TRequest, cfg)
    bank, sid_of = trt.build_bank(requests, _factory(tserve, tcasc),
                                  ("recall_index", None))
    with TQ.cache_int8(), torch.no_grad():
        stepper = trt.EngineStepper(tparams, cfg, bank, paged_kernel=True,
                                    **kw)
        tm, tnodes = _serve_logged(trt, stepper, sid_of, requests)
    attn = stepper.caches[0]["attn"]
    assert attn["k"].dtype == torch.int8 and attn["k_s"].dtype == \
        torch.bfloat16
    for req in jreqs:
        assert tm.records[req.rid].tokens == jm.records[req.rid].tokens, \
            f"request {req.rid}"
        assert tnodes[req.rid] == jnodes[req.rid], f"request {req.rid}"
        assert tm.records[req.rid].n_tokens == req.max_tokens
    assert (tm.steps, tm.seg_batch, tm.seg_policy, tm.lane_steps) == \
        (jm.steps, jm.seg_batch, jm.seg_policy, jm.lane_steps)
    assert stepper.pool.stats() == jst.pool.stats()


# --------------------------------------------------------------------------
# long prompts
# --------------------------------------------------------------------------

def _patch_thresholds(monkeypatch, threshold, q_chunk):
    for mod in (JA, TA):
        monkeypatch.setattr(mod, "_CHUNK_THRESHOLD", threshold)
        monkeypatch.setattr(mod, "_Q_CHUNK", q_chunk)


@pytest.mark.parametrize("window", [None, 1500], ids=["causal", "w1500"])
def test_banded_attention_matches_chunked(window, monkeypatch):
    """The reference's `test_banded_attention_matches_chunked` across the
    packages: S 8192 in 1024-query chunks (both modules' thresholds
    patched to 2048 / 1024), numpy inputs; the port's banded and
    chunked paths each within 2e-5 of the reference's chunked path (and
    of its banded one)."""
    _patch_thresholds(monkeypatch, 2048, 1024)
    rng = np.random.default_rng(0)
    b, s, h, hd = 2, 8192, 4, 32
    q, k, v = ((0.3 * rng.normal(size=(b, s, h, hd))).astype(np.float32)
               for _ in range(3))
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
    jargs = [jnp.asarray(a) for a in (q, k, v, pos, pos)]
    targs = [torch.from_numpy(np.ascontiguousarray(a))
             for a in (q, k, v, pos, pos)]
    with JA.attention_impl("chunked"):
        ref = np.asarray(JA._sdpa_chunked(*jargs, window, 0.17))
    with JA.attention_impl("banded"):
        ref_b = np.asarray(JA._sdpa_chunked(*jargs, window, 0.17))
    for impl in ("banded", "chunked"):
        with TA.attention_impl(impl):
            out = TA._sdpa_chunked(*targs, window, 0.17).numpy()
        np.testing.assert_allclose(out, ref, atol=2e-5, rtol=2e-5)
        np.testing.assert_allclose(out, ref_b, atol=2e-5, rtol=2e-5)
    with pytest.raises(ValueError, match="chunked or banded"):
        with TA.attention_impl("flash"):
            pass


@pytest.mark.parametrize("arch", ["hymba-1.5b", "qwen3-4b",
                                  "deepseek-v2-lite-16b"])
@pytest.mark.parametrize("impl", ["banded", "chunked"])
def test_long_prompt_prefill_routes_as_the_reference(arch, impl,
                                                     monkeypatch):
    """With both modules' thresholds patched to 64 / 32, a 128-token
    prefill (hymba's 32-token window, qwen3's causal attention,
    deepseek's MLA) takes the query-chunked path in every attention
    layer (counted), and its logits, node losses and ring caches match
    the reference's: logits and losses within 1e-5, K/V within one bf16
    ulp; under ``use_flash`` (GQA) the chunked path is not taken."""
    _patch_thresholds(monkeypatch, 64, 32)
    cfg, params, tparams = _pair(arch)
    toks = _toks(cfg, 2, 128, seed=5)
    calls = []
    inner = TA._sdpa_chunked

    def counting(*a):
        calls.append(a[0].shape[1])
        return inner(*a)

    monkeypatch.setattr(TA, "_sdpa_chunked", counting)
    with JA.attention_impl(impl):
        lj, cj, nj, _ = JM.prefill(params, cfg,
                                   {"tokens": jnp.asarray(toks)}, 40)
    with TA.attention_impl(impl), torch.no_grad():
        lt, ct, nt, _ = TM.prefill(tparams, cfg,
                                   {"tokens": torch.from_numpy(toks)}, 40)
    n_layers = sum(seg.n_layers for seg in cfg.segments)
    assert calls == [128] * n_layers
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **F32)
    np.testing.assert_allclose(nt.numpy(), np.asarray(nj), **F32)
    for tseg, jseg in zip(ct, cj):
        for name, leaf in tseg["attn"].items():
            np.testing.assert_allclose(
                leaf.float().numpy(), np.asarray(jseg["attn"][name],
                                                 np.float32),
                atol=1e-2, rtol=1e-2)
    if cfg.segments[0].block.attn.mla is None:
        del calls[:]
        with torch.no_grad():
            TM.prefill(tparams, cfg, {"tokens": torch.from_numpy(toks)}, 40,
                       use_flash=True)
        assert calls == []


# --------------------------------------------------------------------------
# the analytic counts (A10's one-device core)
# --------------------------------------------------------------------------

def _axes_tree(tree):
    """A logical-axes tree with tuples as leaves, lists for sequences."""
    if isinstance(tree, dict):
        return {k: _axes_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_axes_tree(v) for v in tree]
    return tuple(tree)


@pytest.mark.parametrize("arch", ARCHS)
def test_count_params_and_abstract_match_the_reference(arch):
    """Every config at full width: `count_params` EQUAL to the
    reference's; `abstract` gives every leaf on the meta device (no
    storage), bf16, at its ParamDef's shape; `logical_specs` EQUAL to
    the reference's tree."""
    cfg = tconfigs.get_config(arch)
    defs = TM.model_defs(cfg)
    n = count_params(defs)
    assert n == jcount(JM.model_defs(jconfigs.get_config(arch)))
    if arch == "hymba-1.5b":
        assert n == 1_589_784_320
    ab = abstract(defs)
    leaves = tree_leaves(ab)
    assert all(t.device.type == "meta" and t.dtype == torch.bfloat16
               for t in leaves)
    assert sum(t.numel() for t in leaves) == n
    assert [tuple(t.shape) for t in leaves] == \
        [d.shape for d in tree_leaves(defs)]
    assert _axes_tree(logical_specs(defs)) == _axes_tree(
        jlogical(JM.model_defs(jconfigs.get_config(arch))))


@pytest.mark.parametrize("arch", ARCHS)
def test_flops_and_shapes_match_the_reference(arch):
    """For every shape of ``SHAPES`` (equal to the reference's):
    `resolve_config` (the long-context window override) equal, or
    refused by both; `cache_len_for`, `active_matmul_params` and
    `model_flops` EQUAL, for the resolved config and for the smoke
    config."""
    assert {k: dataclasses.astuple(v) for k, v in tshapes.SHAPES.items()} \
        == {k: dataclasses.astuple(v) for k, v in jshapes.SHAPES.items()}
    for smoke in (False, True):
        cfg = tconfigs.get_config(arch, smoke=smoke)
        for name, shape in tshapes.SHAPES.items():
            jshape = jshapes.SHAPES[name]
            try:
                jcfg = jshapes.resolve_config(
                    jconfigs.get_config(arch, smoke=smoke), jshape)
            except AssertionError:
                with pytest.raises(ValueError):
                    tshapes.resolve_config(cfg, shape)
                continue
            rcfg = tshapes.resolve_config(cfg, shape)
            assert repr(rcfg) == repr(jcfg)
            assert tshapes.cache_len_for(rcfg, shape) == \
                jshapes.cache_len_for(jcfg, jshape)
            assert tflops.active_matmul_params(rcfg) == \
                jflops.active_matmul_params(jcfg)
            kw = dict(kind=shape.kind, global_batch=shape.global_batch,
                      seq_len=shape.seq_len)
            assert tflops.model_flops(rcfg, **kw) == \
                jflops.model_flops(jcfg, **kw)
    if arch == "hymba-1.5b":
        cfg = tconfigs.get_config(arch)
        assert tshapes.cache_len_for(cfg, tshapes.SHAPES["long_500k"]) \
            == 1024
        assert tflops.total_params(cfg) == 1_589_784_320
