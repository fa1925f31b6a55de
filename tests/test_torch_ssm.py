"""The port's SSM family (repro_torch.models.ssm, the ssd-chunk kernel's
plain version, the mamba2-130m smoke model and its serving paths)
against the JAX package, on the same numpy inputs and, for the models,
the JAX package's weights carried over by the bridge.

Tolerances:
  * ``ssd_chunk_plain`` against ``ref.ssd_chunk_ref`` and the Pallas
    kernel in interpret mode: atol = rtol = 2e-4, as the JAX package's
    own kernel test (f32 sums over a chunk in another order);
  * f32 tensors of a whole-prompt pass (outputs, SSM state, logits,
    node losses): atol = rtol = 1e-4 (the SSD sums over up to three
    chunks, and the state's decay exp(seg_Q - seg_j) is a difference of
    two cumsums of about -100);
  * anything downstream of the bf16 conv state (decode): 1e-3, and the
    conv state after decode steps within atol = rtol = 1e-2 (a bf16 ulp
    at the largest values; the decode rows of a small value can sit a
    few ulp apart);
  * the bf16 conv state of a prefill or one decode step from equal
    state: within one bf16 ulp of the reference's.
    It is the bf16 rounding of the pre-conv projection rows, and the two
    frameworks' f32 matmuls sum in different orders, so an f32 value a
    few ulp from a bf16 rounding boundary can land one bf16 ulp apart.
    Rows that are left-padding (prompt shorter than d_conv - 1) are
    exactly zero.
Greedy tokens and served nodes are equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import strategy as jstrategy
from repro.configs import get_config
from repro.kernels import ops, ref
from repro.models import model as M
from repro.models import ssm as jssm
from repro.models.config import SSMConfig
from repro.models.param import materialize
from repro.serving import runtime as jrt
from repro.serving.engine import Classifier as JClassifier
from repro.serving.engine import Engine as JEngine
from repro_torch import strategy as tstrategy
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config as t_get_config
from repro_torch.kernels import ssd_chunk, ssd_chunk_plain
from repro_torch.models import model as TM
from repro_torch.models import ssm as tssm
from repro_torch.serving import runtime as trt
from repro_torch.serving.engine import Classifier as TClassifier
from repro_torch.serving.engine import Engine as TEngine
from repro_torch.serving.engine import make_token_step
from repro_torch.strategy.line import FixedNodeStrategy

KERNEL = dict(atol=2e-4, rtol=2e-4)
F32 = dict(atol=1e-4, rtol=1e-4)
DECODE = dict(atol=1e-3, rtol=1e-3)


def _assert_bf16_ulp(got: torch.Tensor, want) -> None:
    """bf16 tensors within one bf16 ulp of the reference's: their bit
    patterns (same sign) are at most one apart."""
    g = got.view(torch.int16).numpy().astype(np.int32)
    w = np.asarray(want).view(np.int16).astype(np.int32)
    assert g.shape == w.shape
    assert ((g < 0) == (w < 0)).all() and (np.abs(g - w) <= 1).all(), \
        int(np.abs(g - w).max())


# --------------------------------------------------------------------------
# the ssd-chunk kernel's plain version
# --------------------------------------------------------------------------

def _softplus(x):
    return np.logaddexp(x, 0.0).astype(np.float32)


def _chunk_inputs(b, c, q, h, p, n, seed, *, model_decay=False):
    """xh, dt, da, bb, cc as numpy f32.  ``model_decay``: da = -e * dt,
    what the model's init (a_log = 1) gives, so that seg_i - seg_j above
    the diagonal is large and exp overflows there."""
    rng = np.random.default_rng(seed)
    xh = rng.normal(size=(b, c, q, h, p)).astype(np.float32)
    dt = _softplus(rng.normal(size=(b, c, q, h)))
    if model_decay:
        da = (-np.e * dt).astype(np.float32)
    else:
        da = -_softplus(rng.normal(size=(b, c, q, h)))
    bb = rng.normal(size=(b, c, q, h, n)).astype(np.float32)
    cc = rng.normal(size=(b, c, q, h, n)).astype(np.float32)
    return xh, dt, da, bb, cc


CHUNK_CASES = {
    # the JAX package's kernel-test shapes (b, c, q, h, p, n)
    "q32": ((1, 2, 32, 2, 32, 16), False),
    "q64_n128": ((2, 1, 64, 3, 64, 128), False),
    "q16_p128": ((1, 4, 16, 1, 128, 8), False),
    # the model's decay: the upper triangle of exp(seg_i - seg_j) is inf
    "overflow_q64": ((2, 1, 64, 2, 32, 16), True),
}


@pytest.mark.parametrize("case", sorted(CHUNK_CASES))
def test_ssd_chunk_plain_matches_jax(case):
    shape, model_decay = CHUNK_CASES[case]
    arrs = _chunk_inputs(*shape, seed=sorted(CHUNK_CASES).index(case),
                         model_decay=model_decay)
    y, st = ssd_chunk_plain(*(torch.from_numpy(a) for a in arrs))
    b, c, q, h, p, n = shape
    assert y.shape == (b, c, q, h, p) and st.shape == (b, c, h, p, n)
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    if model_decay:
        da = arrs[2][0, 0, :, 0].astype(np.float64)
        seg = np.cumsum(da)
        assert (seg[None, :] - seg[:, None]).max() > 88.8   # exp overflows
    j = [jnp.asarray(a) for a in arrs]
    yr, sr = ref.ssd_chunk_ref(*j)
    np.testing.assert_allclose(y.numpy(), np.asarray(yr), **KERNEL)
    np.testing.assert_allclose(st.numpy(), np.asarray(sr), **KERNEL)
    yk, sk = ops.ssd_chunk(*j, interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(yk), **KERNEL)
    np.testing.assert_allclose(st.numpy(), np.asarray(sk), **KERNEL)


# (shape, q_valid, model decay): the caller's zero tail in the last chunk
ZERO_TAIL_CASES = {
    "q32_one_row": ((1, 2, 32, 2, 32, 16), 1, False),
    "q64_ragged": ((2, 1, 64, 3, 64, 128), 37, True),
    "q64_full": ((1, 1, 64, 2, 32, 16), 64, True),
    "q16_three_chunks": ((1, 3, 16, 1, 128, 8), 9, False),
}


def _zero_tail(arrs, q_valid):
    """Rows q_valid.. of the last chunk zero in every input, as the
    model pads a prompt (x = B = C = dt = 0, hence da = 0)."""
    out = [a.copy() for a in arrs]
    for a in out:
        a[:, -1, q_valid:] = 0.0
    return out


@pytest.mark.parametrize("case", sorted(ZERO_TAIL_CASES))
def test_ssd_chunk_plain_zero_tail_matches_jax(case):
    """With ``q_valid``, the plain version equals the JAX reference and
    the Pallas kernel in interpret mode (which compute every row) on
    zero-tail inputs, and its y rows past q_valid are exactly 0."""
    shape, qv, model_decay = ZERO_TAIL_CASES[case]
    arrs = _zero_tail(_chunk_inputs(
        *shape, seed=10 + sorted(ZERO_TAIL_CASES).index(case),
        model_decay=model_decay), qv)
    y, st = ssd_chunk_plain(*(torch.from_numpy(a) for a in arrs),
                            q_valid=qv)
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    assert (y[:, -1, qv:] == 0).all()
    j = [jnp.asarray(a) for a in arrs]
    for yr, sr in (ref.ssd_chunk_ref(*j), ops.ssd_chunk(*j, interpret=True)):
        np.testing.assert_allclose(y.numpy(), np.asarray(yr), **KERNEL)
        np.testing.assert_allclose(st.numpy(), np.asarray(sr), **KERNEL)
    # and as the wrapper gives it on the CPU
    y2, st2 = ssd_chunk(*(torch.from_numpy(a) for a in arrs), q_valid=qv)
    torch.testing.assert_close(y2, y, rtol=0, atol=0)
    torch.testing.assert_close(st2, st, rtol=0, atol=0)


@pytest.mark.parametrize("qv", [0, -1, 33])
@pytest.mark.parametrize("fn", [ssd_chunk, ssd_chunk_plain],
                         ids=["wrapper", "plain"])
def test_ssd_chunk_refuses_q_valid_out_of_range(fn, qv):
    args = (torch.from_numpy(a) for a in _chunk_inputs(1, 1, 32, 2, 32, 16,
                                                       seed=3))
    with pytest.raises(ValueError, match="q_valid"):
        fn(*args, q_valid=qv)


@pytest.mark.parametrize("bad", ["xh_offset", "bb_row_stride"])
def test_ssd_chunk_wrapper_refuses_unaligned_rows(bad):
    """The kernel copies rows of xh, bb and cc in 16-byte pieces: the
    wrapper's `_check` raises on a base pointer off 16 bytes or a stride
    that is not a multiple of 4, and passes the model's layout (B/C a
    stride-0 broadcast over the heads)."""
    import importlib
    mod = importlib.import_module("repro_torch.kernels.ssd_chunk")
    xh, dt, da, bb, cc = (torch.from_numpy(a) for a in _chunk_inputs(
        1, 2, 32, 3, 32, 16, seed=9))
    bb, cc = bb[:, :, :, :1].expand_as(bb), cc[:, :, :, :1].expand_as(cc)
    mod._check(xh, dt, da, bb, cc)
    if bad == "xh_offset":
        xh = torch.zeros(xh.numel() + 1)[1:].view(xh.shape)
    else:
        wide = torch.zeros(*bb.shape[:3], 1, 18)
        bb = wide[..., :16].expand_as(cc)
        assert bb.stride(2) == 18
    with pytest.raises(ValueError, match="16 bytes"):
        mod._check(xh, dt, da, bb, cc)


def test_ssd_chunk_wrapper_takes_the_plain_version_on_cpu():
    """On CPU tensors the wrapper IS the plain version (stride-0 B/C
    included) and launches nothing."""
    xh, dt, da, bb, cc = (torch.from_numpy(a) for a in _chunk_inputs(
        1, 2, 32, 3, 32, 16, seed=9))
    bb, cc = bb[:, :, :, :1].expand_as(bb), cc[:, :, :, :1].expand_as(cc)
    assert bb.stride(3) == 0
    before = ssd_chunk.launches
    got = ssd_chunk(xh, dt, da, bb, cc)
    want = ssd_chunk_plain(xh, dt, da, bb.contiguous(), cc.contiguous())
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert ssd_chunk.launches == before


# --------------------------------------------------------------------------
# the SSM mixer
# --------------------------------------------------------------------------

SSM_CFG = SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=32, chunk=32)
D = 64


@pytest.fixture(scope="module")
def mixer():
    torch.set_num_threads(2)
    params = materialize(jssm.ssm_defs(SSM_CFG, D), jax.random.PRNGKey(4))
    return params, params_from_numpy(jax.tree.map(np.asarray, params))


@pytest.mark.parametrize("s", [2, 45, 96],
                         ids=["shorter_than_conv", "ragged", "three_chunks"])
@pytest.mark.parametrize("use_kernel", [False, True],
                         ids=["einsum", "kernel"])
def test_ssm_forward_matches_jax(mixer, s, use_kernel):
    """The port's ssm_forward (einsum path, or the kernel route, which
    runs the plain version on the CPU) against the JAX package's einsum
    path: S shorter than d_conv - 1, S not a multiple of the chunk, and
    several whole chunks."""
    params, tparams = mixer
    x = (np.random.default_rng(s).normal(size=(2, s, D)) * 0.3) \
        .astype(np.float32)
    yj, stj = jssm.ssm_forward(params, jnp.asarray(x), SSM_CFG)
    yt, stt = tssm.ssm_forward(tparams, torch.from_numpy(x), SSM_CFG,
                               use_kernel=use_kernel)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **F32)
    np.testing.assert_allclose(stt["ssm"].numpy(), np.asarray(stj["ssm"]),
                               **F32)
    assert stt["conv"].dtype == torch.bfloat16
    _assert_bf16_ulp(stt["conv"], stj["conv"])
    kc = SSM_CFG.d_conv - 1
    if s < kc:
        assert (stt["conv"][:, :kc - s] == 0).all()


@pytest.mark.parametrize("s", [2, 45, 64, 96])
def test_ssm_forward_passes_the_padding_as_q_valid(mixer, monkeypatch, s):
    """The kernel route hands the chunk ``q_valid = chunk - pad`` when it
    pads the prompt (None when it does not), and the result still
    matches the JAX package's."""
    params, tparams = mixer
    seen = []

    def spy(*args, q_valid=None):
        seen.append(q_valid)
        return ssd_chunk(*args, q_valid=q_valid)

    monkeypatch.setattr(tssm, "ssd_chunk", spy)
    x = (np.random.default_rng(s + 1).normal(size=(2, s, D)) * 0.3) \
        .astype(np.float32)
    yt, stt = tssm.ssm_forward(tparams, torch.from_numpy(x), SSM_CFG,
                               use_kernel=True)
    pad = (-s) % SSM_CFG.chunk
    assert seen == [SSM_CFG.chunk - pad if pad else None]
    yj, stj = jssm.ssm_forward(params, jnp.asarray(x), SSM_CFG)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **F32)
    np.testing.assert_allclose(stt["ssm"].numpy(), np.asarray(stj["ssm"]),
                               **F32)


def test_ssm_decode_matches_jax(mixer):
    """Three recurrent steps from a prefill's state: outputs within
    1e-3, the SSM state within 1e-5 of the reference's, the conv window
    within a bf16 ulp."""
    params, tparams = mixer
    rng = np.random.default_rng(11)
    x = (rng.normal(size=(3, 20, D)) * 0.3).astype(np.float32)
    _, stj = jssm.ssm_forward(params, jnp.asarray(x), SSM_CFG)
    # both packages step from the same (reference) state
    stt = {"conv": torch.from_numpy(np.asarray(stj["conv"], np.float32))
           .to(torch.bfloat16),
           "ssm": torch.from_numpy(np.array(stj["ssm"]))}
    for t in range(3):
        xt = (rng.normal(size=(3, 1, D)) * 0.3).astype(np.float32)
        yj, stj = jssm.ssm_decode(params, jnp.asarray(xt), stj, SSM_CFG)
        yt, stt = tssm.ssm_decode(tparams, torch.from_numpy(xt), stt,
                                  SSM_CFG)
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **DECODE)
        np.testing.assert_allclose(stt["ssm"].numpy(),
                                   np.asarray(stj["ssm"]), atol=1e-5,
                                   rtol=1e-5)
        _assert_bf16_ulp(stt["conv"], stj["conv"])


# --------------------------------------------------------------------------
# mamba2-130m (smoke): prefill, decode, Engine, Classifier
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def model():
    torch.set_num_threads(2)
    cfg = get_config("mamba2-130m", smoke=True)
    assert repr(t_get_config("mamba2-130m", smoke=True)) == repr(cfg)
    params = materialize(M.model_defs(cfg), jax.random.PRNGKey(0))
    return cfg, params, params_from_numpy(jax.tree.map(np.asarray, params))


def test_full_config_matches_the_reference():
    assert repr(t_get_config("mamba2-130m")) == \
        repr(get_config("mamba2-130m"))


def _check_state(tcaches, jcaches, decoded=False):
    for tc, jc in zip(tcaches, jcaches):
        assert set(tc) == set(jc) == {"ssm"}
        np.testing.assert_allclose(tc["ssm"]["ssm"].numpy(),
                                   np.asarray(jc["ssm"]["ssm"]),
                                   **(DECODE if decoded else F32))
        if decoded:
            np.testing.assert_allclose(
                tc["ssm"]["conv"].float().numpy(),
                np.asarray(jc["ssm"]["conv"], np.float32), atol=1e-2,
                rtol=1e-2)
        else:
            _assert_bf16_ulp(tc["ssm"]["conv"], jc["ssm"]["conv"])


@pytest.mark.parametrize("s", [12, 70], ids=["one_chunk", "three_chunks"])
@pytest.mark.parametrize("use_ssd_kernel", [False, True],
                         ids=["einsum", "kernel"])
def test_mamba_prefill_matches(model, s, use_ssd_kernel):
    cfg, params, tparams = model
    toks = np.random.default_rng(s).integers(0, cfg.vocab, (3, s))
    lj, cj, nlj, npj = M.prefill(params, cfg,
                                 {"tokens": jnp.asarray(toks, jnp.int32)},
                                 16)
    lt, ct, nlt, npt = TM.prefill(tparams, cfg,
                                  {"tokens": torch.from_numpy(toks)}, 16,
                                  use_ssd_kernel=use_ssd_kernel)
    assert nlt.shape == (3, cfg.n_ramps + 1)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **F32)
    np.testing.assert_allclose(nlt.numpy(), np.asarray(nlj), **F32)
    np.testing.assert_array_equal(npt.numpy(), np.asarray(npj))
    _check_state(ct, cj)
    for tc, js in zip(ct, M.cache_specs(cfg, 3, 16)):
        for name in ("conv", "ssm"):
            assert tuple(tc["ssm"][name].shape) == js["ssm"][name][0]


def test_mamba_decode_step_matches(model):
    """Greedy full-depth decode, 5 tokens: logits and node losses within
    1e-3, tokens equal, state as above."""
    cfg, params, tparams = model
    toks = np.random.default_rng(5).integers(0, cfg.vocab, (3, 40))
    lj, cj, _, pj = M.prefill(params, cfg,
                              {"tokens": jnp.asarray(toks, jnp.int32)}, 16)
    lt, ct, _, pt = TM.prefill(tparams, cfg,
                               {"tokens": torch.from_numpy(toks)}, 16)
    tok_j = jnp.argmax(lj, axis=-1).astype(jnp.int32)
    tok_t = torch.argmax(lt, dim=-1).to(torch.int32)
    with torch.no_grad():
        for _ in range(5):
            lj, cj, nj = M.decode_step(params, cfg, {"tokens": tok_j}, cj,
                                       pj)
            lt, ct, nt = TM.decode_step(tparams, cfg, {"tokens": tok_t}, ct,
                                        pt)
            np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **DECODE)
            np.testing.assert_allclose(nt.numpy(), np.asarray(nj), **DECODE)
            tok_j = jnp.argmax(lj, axis=-1).astype(jnp.int32)
            tok_t = torch.argmax(lt, dim=-1).to(torch.int32)
            np.testing.assert_array_equal(tok_t.numpy(), np.asarray(tok_j))
            pj, pt = pj + 1, pt + 1
    _check_state(ct, cj, decoded=True)


def _strategies(cfg, name):
    """The same strategy in both packages, from the same numpy traces."""
    rng = np.random.default_rng(6)
    n = cfg.n_ramps + 1
    losses = np.clip(rng.uniform(0.05, 0.95, (400, 1))
                     * np.linspace(1.0, 0.5, n)[None, :]
                     + rng.normal(scale=0.05, size=(400, n)), 1e-3,
                     1.0).astype(np.float32)
    costs = 0.5 * np.full((n,), 1.0 / n)
    return (jstrategy.make(name, jstrategy.Cascade.from_traces(
                losses, costs, k=8, lam=0.5)),
            tstrategy.make(name, tstrategy.Cascade.from_traces(
                losses, costs, k=8, lam=0.5)))


@pytest.mark.parametrize("use_ssd_kernel", [False, True],
                         ids=["einsum", "kernel"])
@pytest.mark.parametrize("name", ["recall_index", "always_last"])
def test_mamba_engine_generate_matches(model, name, use_ssd_kernel):
    cfg, params, tparams = model
    js, ts = _strategies(cfg, name)
    toks = np.random.default_rng(7).integers(0, cfg.vocab, (4, 12))
    jr = JEngine(params, cfg, js, 16, jit=False).generate(
        {"tokens": jnp.asarray(toks, jnp.int32)}, 5)
    with torch.no_grad():
        tr = TEngine(tparams, cfg, ts, 16,
                     use_ssd_kernel=use_ssd_kernel).generate(
            {"tokens": torch.from_numpy(toks)}, 5)
    np.testing.assert_array_equal(tr.tokens, jr.tokens)
    np.testing.assert_array_equal(tr.served_nodes, jr.served_nodes)
    assert (tr.segments_run_batch, tr.segments_run_policy,
            tr.segments_full) == (jr.segments_run_batch,
                                  jr.segments_run_policy, jr.segments_full)


@pytest.mark.parametrize("name", ["recall_index", "always_last"])
def test_mamba_classifier_matches(model, name):
    cfg, params, tparams = model
    js, ts = _strategies(cfg, name)
    toks = np.random.default_rng(8).integers(0, cfg.vocab, (5, 12))
    jr = JClassifier(params, cfg, js).classify(
        {"tokens": jnp.asarray(toks, jnp.int32)})
    with torch.no_grad():
        tr = TClassifier(tparams, cfg, ts).classify(
            {"tokens": torch.from_numpy(toks)})
    for key in ("labels", "served_node"):
        np.testing.assert_array_equal(tr[key], np.asarray(jr[key]))
    for key in ("segments_run_batch", "segments_run_policy",
                "segments_full"):
        assert tr[key] == jr[key], key


# --------------------------------------------------------------------------
# lane masking of SSM state (ring and paged) and the chunked-prefill gate
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kv", ["ring", "paged"])
def test_inactive_lanes_keep_their_ssm_state(model, kv):
    """Three lanes: lane 0 runs to the last node, lane 1 exits at node 0,
    lane 2 is unoccupied.  After one token the deeper segment's conv/SSM
    state of lanes 1 and 2, and every segment's state of lane 2, are bit
    for bit what they were; lane 0's changed everywhere."""
    cfg, _, tparams = model
    n = cfg.n_ramps + 1
    bank = (FixedNodeStrategy(n, n - 1), FixedNodeStrategy(n, 0))
    step = make_token_step(tparams, cfg, bank, carry_state=True,
                           paged=(kv == "paged"))
    rng = np.random.default_rng(12)
    if kv == "paged":
        specs = TM.paged_cache_specs(cfg, 3, 5, 4)
    else:
        specs = TM.cache_specs(cfg, 3, 16)
    caches = []
    for spec in specs:
        assert set(spec) == {"ssm"}
        caches.append({"ssm": {
            name: torch.from_numpy(rng.normal(size=shape).astype(np.float32))
            .to(dtype) for name, (shape, dtype) in spec["ssm"].items()}})
    before = [{k: t.clone() for k, t in c["ssm"].items()} for c in caches]
    tok = torch.tensor([3, 5, 7], dtype=torch.int32)
    pos = torch.tensor([4, 6, 0], dtype=torch.int32)
    occupied = torch.tensor([True, True, False])
    sid = torch.tensor([0, 1, 0], dtype=torch.int32)
    kvh = None
    if kv == "paged":
        from repro_torch.models.attention import PagedKV
        table = torch.tensor([[1, 2], [3, 4], [0, 0]], dtype=torch.int32)
        kvh = PagedKV(page_table=table, write_page=table[:, 1],
                      write_slot=pos % 4)
    states = tuple(s.init(3) for s in bank)
    with torch.no_grad():
        out = step(tok, caches, pos, occupied, sid, kvh, states)
    served = out[2]
    assert served.tolist() == [n - 1, 0, n - 1]
    for si, (c, b0) in enumerate(zip(caches, before)):
        for name, leaf in c["ssm"].items():
            old = b0[name]
            assert torch.equal(leaf[:, 2], old[:, 2]), (si, name)
            assert not torch.equal(leaf[:, 0], old[:, 0]), (si, name)
            if si > 0:          # lane 1 exited at node 0
                assert torch.equal(leaf[:, 1], old[:, 1]), (si, name)
            else:
                assert not torch.equal(leaf[:, 1], old[:, 1]), (si, name)


def test_chunked_prefill_refused_for_ssm(model):
    """Both packages refuse --prefill-chunk for an SSM model."""
    cfg, params, tparams = model
    n = cfg.n_ramps + 1
    kw = dict(n_lanes=2, cache_len=32, prompt_len=12, kv="paged",
              page_size=8, prefill_chunk=4)
    with pytest.raises(ValueError, match="chunked prefill"):
        jrt.EngineStepper(params, cfg, (jstrategy.make(
            "always_last", jstrategy.Cascade.uniform(n)),), **kw)
    with pytest.raises(ValueError, match="chunked prefill"):
        trt.EngineStepper(tparams, cfg, (FixedNodeStrategy(n, n - 1),),
                          **kw)
