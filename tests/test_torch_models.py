"""The port's early-exit decoder (repro_torch.models) against the JAX
package's, on the smoke config with weights carried over by the bridge.

Tolerances: f32 tensors that never pass through the bf16 KV pool agree
within atol = rtol = 1e-5; tensors downstream of the pool within 1e-3,
because the two frameworks' f32 K/V can round to bf16 values one ulp
apart.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import attention as A
from repro.models import model as M
from repro.models.param import materialize
from repro_torch.bridge import params_from_numpy
from repro_torch.models import attention as TA
from repro_torch.models import model as TM

F32 = dict(atol=1e-5, rtol=1e-5)
POOL = dict(atol=1e-3, rtol=1e-3)
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
    cfg, params, tparams = setup
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (4, 12))
    lj, _, nlj, npj = M.prefill(params, cfg,
                                {"tokens": jnp.asarray(toks, jnp.int32)},
                                cache_len=16)
    lt, nlt, npt = TM.prefill(tparams, cfg, {"tokens": torch.from_numpy(toks)})
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

    tcaches = [tmat(s) for s in TM.paged_cache_specs(cfg, n_pages, PS)]
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
    cfg, params, tparams = setup
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


def test_paged_cache_specs_match(setup):
    cfg, _, _ = setup
    jspecs = M.paged_cache_specs(cfg, 2, 9, PS)
    tspecs = TM.paged_cache_specs(cfg, 9, PS)
    for js, ts in zip(jspecs, tspecs):
        for name in ("k", "v", "pos"):
            assert ts["attn"][name][0] == js["attn"][name][0]
            assert str(ts["attn"][name][1]).split(".")[-1] == \
                jnp.dtype(js["attn"][name][1]).name
