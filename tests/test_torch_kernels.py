"""The port's kernels (repro_torch.kernels: paged decode, chunked
prefill, flash attention, Bellman backup, the exit decision
(ramp_exit: loss within atol = rtol = 1e-5, the JAX test's own
tolerance, bins, new x and stop equal); the ssd-chunk kernel's plain
version is held against the JAX package in test_torch_ssm) against the
JAX package:
their plain PyTorch versions — what a CPU tensor runs — are held against
`repro.kernels.ref` and against the Pallas kernels run in interpret
mode, on the same numpy inputs.

Tolerance: f32 outputs within atol = rtol = 1e-5 (the two frameworks sum
in different orders).  The bf16 pools are built from the same f32 numpy
arrays in both frameworks and must be bit-equal.

The CUDA kernels themselves run only on the card: `test_cuda_kernels_
match_plain`, `test_cuda_flash_and_bellman_match_plain`,
`test_cuda_bellman_solve_matches_chained_launches`,
`test_cuda_ssd_chunk_matches_plain` and `test_cuda_ramp_exit_matches_
plain` hold each against its plain version (and
`test_wrappers_refuse_autograd_on_the_card` requires every wrapper to
refuse an input that requires grad under autograd)
there (atol = rtol = 1e-4 for attention, whose f32 sums run in another
order; 1e-5 for the backup and the solve, whose n-node launch must also
equal n chained single launches bit for bit; 2e-4 for the SSD chunk, as
the JAX package's own kernel test) and skip on a machine without one.  The JAX package is imported by the fixture of the
tests that need it, so that test also runs where JAX is not installed
(``pytest -m cuda tests/test_torch_kernels.py``).
"""

import importlib
import types

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels import build
from repro_torch.kernels import (bellman_backup, bellman_backup_plain,
                                 bellman_solve, bellman_solve_plain,
                                 flash_attention, flash_attention_plain,
                                 paged_attention, paged_attention_plain,
                                 paged_prefill, paged_prefill_plain,
                                 ramp_exit, ramp_exit_plain, ssd_chunk,
                                 ssd_chunk_plain)

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def jx():
    """The JAX side: jax.numpy and the JAX package's kernels."""
    import jax.numpy as jnp

    from repro.kernels import ops, ref
    return types.SimpleNamespace(jnp=jnp, ops=ops, ref=ref)


def _bf16_pair(jnp, a: np.ndarray):
    """The same f32 numpy array as a bf16 JAX array and a bf16 tensor,
    checked bit-equal."""
    j = jnp.asarray(a).astype(jnp.bfloat16)
    t = torch.from_numpy(a).to(torch.bfloat16)
    np.testing.assert_array_equal(np.asarray(j).view(np.uint16),
                                  t.view(torch.int16).numpy().view(np.uint16))
    return j, t


def _pool(rng, *, hkv, hd, ps, starts, holes, stale_page):
    """Per-lane sequential page histories of ``starts[i]`` positions
    (page 0 is the garbage sink, all -1).  ``holes`` punches position
    -1 holes (early-exit writes) into lane 0's history; the tail of a
    partly filled page holds stale positions at and past the lane's
    length; ``stale_page`` appends one page of in-range positions that
    only garbage table padding points at."""
    n_pages = 1 + sum(-(-s // ps) for s in starts) + int(stale_page)
    k = (rng.normal(size=(n_pages, ps, hkv, hd)) * 0.5).astype(np.float32)
    v = (rng.normal(size=(n_pages, ps, hkv, hd)) * 0.5).astype(np.float32)
    pos = np.full((n_pages, ps), -1, np.int32)
    pages = []
    nxt = 1
    for s in starts:
        lane_pages = []
        for j in range(-(-s // ps)):
            lo = j * ps
            w = min(ps, s - lo)
            pos[nxt, :w] = np.arange(lo, lo + w)
            pos[nxt, w:] = np.arange(s, s + ps - w)
            lane_pages.append(nxt)
            nxt += 1
        pages.append(lane_pages)
    if holes and pages[0]:
        first = pages[0][0]
        pos[first, 1:ps:3] = -1
    if stale_page:
        pos[nxt] = np.arange(ps)
    return k, v, pos, pages, nxt if stale_page else 0


def _table(pages, maxp, pad):
    table = np.full((len(pages), maxp), pad, np.int32)
    for lane, lp in enumerate(pages):
        table[lane, :len(lp)] = lp
    return table


# --------------------------------------------------------------------------
# paged decode attention
# --------------------------------------------------------------------------

DECODE_CASES = {
    # name: (h, hkv, hd, ps, maxp, lens, q_pos override, window, holes,
    #        stale padding)
    "mha": (4, 4, 32, 8, 4, (20, 5, 9), None, None, False, False),
    "gqa": (4, 2, 64, 8, 4, (20, 5, 9), None, None, False, False),
    "window": (4, 2, 64, 8, 4, (30, 12, 3), None, 10, False, False),
    "holes": (4, 4, 32, 8, 4, (20, 5, 9), None, None, True, False),
    "stale_padding": (4, 2, 32, 8, 4, (9, 5, 3), None, None, False, True),
    "all_masked": (4, 2, 32, 8, 3, (0, 6, 0), (0, 5, -1), None, False,
                   False),
}


# cases at the edges of the kernel's staging and splits, each with its
# own seed (the cases above keep theirs): the card's split count for
# them is checked in `test_cuda_kernels_match_plain`
DECODE_EDGES = {
    # name: (seed, case as above)
    # lane 0: 300 visible keys, over 3 splits of 8 pages (128 keys, two
    # staged tiles each)
    "tiles_splits": (60, (4, 2, 32, 16, 24, (300, 70, 17), None, None,
                          False, False)),
    # lane 1's window (keys 100..199) runs across split 1's first key
    # (128), lane 0's (151..250) starts inside split 1
    "window_across_split": (61, (4, 2, 32, 16, 24, (251, 200, 5), None, 100,
                                 False, False)),
    # lane 0's window holds keys 251..300 only: split 0 is wholly masked;
    # lane 2 sees nothing at all
    "masked_split": (62, (4, 2, 32, 16, 24, (301, 9, 0), (300, 8, -1), 50,
                          False, False)),
    "g4_hd128": (63, (8, 2, 128, 8, 6, (40, 13, 25), None, 16, True,
                      False)),
    # phi-3-vision's G 1 at hd 96 (48 column pairs a head: the P.V
    # items split the keys over 96 of the 128 threads) and qwen3-14b's
    # odd group G 5 at hd 128, each with a window
    "g1_hd96": (64, (4, 4, 96, 8, 6, (40, 13, 25), None, 16, True, False)),
    "g5_hd128": (65, (10, 2, 128, 8, 6, (40, 13, 25), None, 16, True,
                      False)),
}
# cases whose lanes span more than one split on the card
DECODE_SPLIT = ("tiles_splits", "window_across_split", "masked_split")


def _decode_inputs(case):
    if case in DECODE_CASES:
        spec, seed = DECODE_CASES[case], sorted(DECODE_CASES).index(case)
    else:
        seed, spec = DECODE_EDGES[case]
    h, hkv, hd, ps, maxp, lens, qpos_over, window, holes, stale = spec
    rng = np.random.default_rng(seed)
    k, v, pos, pages, stale_id = _pool(rng, hkv=hkv, hd=hd, ps=ps,
                                       starts=lens, holes=holes,
                                       stale_page=stale)
    table = _table(pages, maxp, stale_id)
    q_pos = np.asarray([n - 1 for n in lens], np.int32)
    if qpos_over is not None:
        q_pos = np.asarray(qpos_over, np.int32)
    q = (rng.normal(size=(len(lens), h, hd)) * 0.5).astype(np.float32)
    return dict(q=q, k=k, v=v, pos=pos, table=table, q_pos=q_pos, hd=hd,
                ps=ps, maxp=maxp, hkv=hkv, window=window)


@pytest.mark.parametrize("case", sorted(DECODE_CASES) + sorted(DECODE_EDGES))
def test_paged_attention_plain_matches_jax(case, jx):
    jnp, ops, ref = jx.jnp, jx.ops, jx.ref
    d = _decode_inputs(case)
    scale = 1.0 / np.sqrt(d["hd"])
    kj, kt = _bf16_pair(jnp, d["k"])
    vj, vt = _bf16_pair(jnp, d["v"])
    out = paged_attention_plain(
        torch.from_numpy(d["q"]), kt, vt, torch.from_numpy(d["pos"]),
        torch.from_numpy(d["table"]), torch.from_numpy(d["q_pos"]),
        scale=scale, window=d["window"]).numpy()
    b, h, hd = d["q"].shape
    hkv = d["hkv"]
    n_used = jnp.minimum(jnp.asarray(d["q_pos"]) // d["ps"] + 1, d["maxp"])
    r = ref.paged_attention_ref(
        jnp.asarray(d["q"]).reshape(b, hkv, h // hkv, hd),
        kj.transpose(0, 2, 1, 3), vj.transpose(0, 2, 1, 3),
        jnp.asarray(d["pos"]), jnp.asarray(d["table"]),
        jnp.asarray(d["q_pos"]), n_used, scale=scale,
        window=d["window"]).reshape(b, h, hd)
    np.testing.assert_allclose(out, np.asarray(r), **TOL)
    pallas = ops.paged_attention(
        jnp.asarray(d["q"]), kj, vj, jnp.asarray(d["pos"]),
        jnp.asarray(d["table"]), jnp.asarray(d["q_pos"]), scale=scale,
        window=d["window"], interpret=True)
    np.testing.assert_allclose(out, np.asarray(pallas), **TOL)
    if case in ("all_masked", "masked_split"):
        # lanes with nothing attendable come back exactly zero
        np.testing.assert_array_equal(out[d["q_pos"] < 0], 0.0)
        assert np.isfinite(out).all()
    if case == "all_masked":
        np.testing.assert_array_equal(out[[0, 2]], 0.0)


# --------------------------------------------------------------------------
# chunked prefill
# --------------------------------------------------------------------------

PREFILL_CASES = {
    # name: (h, hkv, hd, ps, maxp, starts, widths, c, window, holes)
    "aligned_ragged": (4, 4, 32, 8, 4, (16, 8), (6, 3), 6, None, False),
    "gqa_mid_page": (4, 2, 64, 8, 4, (17, 3), (5, 5), 5, None, False),
    "idle_slot": (4, 2, 32, 8, 3, (12, 0, 0), (4, 0, 6), 6, None, False),
    "window_seam": (8, 4, 32, 8, 4, (20, 9), (6, 4), 6, 10, False),
    "holes": (4, 2, 32, 8, 4, (19, 7), (5, 2), 5, None, True),
}


# edge cases of the kernel's staging, row tiles and splits, each with
# its own seed (the cases above keep theirs)
PREFILL_EDGES = {
    # name: (seed, case as above)
    # lane 0: a 300-key history, 5 staged tiles over 2 splits
    "tiles_splits": (70, (4, 2, 32, 16, 24, (300, 70), (6, 6), 6, None,
                          False)),
    # rows at 250.. and 200.. with a window of 100: the edge falls across
    # split 1's first key (192)
    "window_across_split": (71, (4, 2, 32, 16, 24, (250, 200), (5, 5), 5,
                                 100, False)),
    # rows at 300..305 see 261.. only: split 0 is wholly masked
    "masked_split": (72, (4, 2, 32, 16, 24, (300, 40), (6, 3), 6, 40,
                          False)),
    # G 4 at hd 128: 36 rows (c, g), three 16-row tiles, with a window
    "g4_hd128": (73, (8, 2, 128, 8, 6, (21, 10), (9, 4), 9, 12, False)),
    # histories that end mid-page (37 of 48 slots, stale tail), holes
    "history_mid_page": (74, (4, 4, 64, 16, 4, (37, 16), (8, 8), 8, None,
                              True)),
    # a 70-row chunk: the in-flight keys span two staged tiles
    "long_chunk": (75, (2, 1, 32, 16, 8, (20, 0), (70, 33), 70, None,
                        False)),
    # phi-3-vision's G 1 at hd 96, and qwen3-14b's G 5 at hd 128: 45
    # rows (c, g) in three 16-row tiles, a tile's rows spanning chunk
    # positions, with a window
    "g1_hd96": (76, (4, 4, 96, 8, 6, (21, 10), (9, 4), 9, 12, False)),
    "g5_hd128": (77, (10, 2, 128, 8, 6, (21, 10), (9, 4), 9, 12, False)),
}
PREFILL_SPLIT = ("tiles_splits", "window_across_split", "masked_split")


def _prefill_inputs(case):
    if case in PREFILL_CASES:
        spec = PREFILL_CASES[case]
        seed = 10 + sorted(PREFILL_CASES).index(case)
    else:
        seed, spec = PREFILL_EDGES[case]
    h, hkv, hd, ps, maxp, starts, widths, c, window, holes = spec
    rng = np.random.default_rng(seed)
    k, v, pos, pages, _ = _pool(rng, hkv=hkv, hd=hd, ps=ps, starts=starts,
                                holes=holes, stale_page=False)
    table = _table(pages, maxp, 0)
    b = len(starts)
    q_pos = np.full((b, c), -1, np.int32)
    for lane, (s, w) in enumerate(zip(starts, widths)):
        q_pos[lane, :w] = np.arange(s, s + w)
    q = (rng.normal(size=(b, c, h, hd)) * 0.5).astype(np.float32)
    ck = (rng.normal(size=(b, c, hkv, hd)) * 0.5).astype(np.float32)
    cv = (rng.normal(size=(b, c, hkv, hd)) * 0.5).astype(np.float32)
    return dict(q=q, k=k, v=v, pos=pos, table=table, q_pos=q_pos,
                start=np.asarray(starts, np.int32), ck=ck, cv=cv, hd=hd,
                ps=ps, maxp=maxp, hkv=hkv, window=window)


@pytest.mark.parametrize("case", sorted(PREFILL_CASES) + sorted(PREFILL_EDGES))
def test_paged_prefill_plain_matches_jax(case, jx):
    jnp, ops, ref = jx.jnp, jx.ops, jx.ref
    d = _prefill_inputs(case)
    scale = 1.0 / np.sqrt(d["hd"])
    kj, kt = _bf16_pair(jnp, d["k"])
    vj, vt = _bf16_pair(jnp, d["v"])
    t = {n: torch.from_numpy(d[n]) for n in
         ("q", "pos", "table", "q_pos", "start", "ck", "cv")}
    out = paged_prefill_plain(t["q"], kt, vt, t["pos"], t["table"],
                              t["q_pos"], t["start"], t["ck"], t["cv"],
                              t["q_pos"], scale=scale,
                              window=d["window"]).numpy()
    j = {n: jnp.asarray(d[n]) for n in
         ("q", "pos", "table", "q_pos", "start", "ck", "cv")}
    b, c, h, hd = d["q"].shape
    hkv = d["hkv"]
    n_hist = jnp.clip(-(-j["start"] // d["ps"]), 0, d["maxp"])
    r = ref.paged_prefill_ref(
        j["q"].reshape(b, c, hkv, h // hkv, hd).transpose(0, 2, 1, 3, 4),
        j["q_pos"], kj.transpose(0, 2, 1, 3), vj.transpose(0, 2, 1, 3),
        j["pos"], j["table"], j["start"], n_hist,
        j["ck"].transpose(0, 2, 1, 3), j["cv"].transpose(0, 2, 1, 3),
        j["q_pos"], scale=scale, window=d["window"])
    r = np.asarray(r).transpose(0, 2, 1, 3, 4).reshape(b, c, h, hd)
    np.testing.assert_allclose(out, r, **TOL)
    pallas = ops.paged_prefill(j["q"], kj, vj, j["pos"], j["table"],
                               j["q_pos"], j["start"], j["ck"], j["cv"],
                               j["q_pos"], scale=scale, window=d["window"],
                               interpret=True)
    np.testing.assert_allclose(out, np.asarray(pallas), **TOL)
    pad = d["q_pos"] < 0
    if pad.any():
        # padded rows (ragged tails, idle slots) come back exactly zero
        np.testing.assert_array_equal(out[pad], 0.0)
        assert np.isfinite(out).all()


def test_wrappers_take_the_plain_version_on_cpu():
    """On CPU tensors the wrappers ARE the plain versions and launch
    nothing (their launch counters stay put)."""
    d = _decode_inputs("gqa")
    before = paged_attention.launches
    args = (torch.from_numpy(d["q"]),
            torch.from_numpy(d["k"]).to(torch.bfloat16),
            torch.from_numpy(d["v"]).to(torch.bfloat16),
            torch.from_numpy(d["pos"]), torch.from_numpy(d["table"]),
            torch.from_numpy(d["q_pos"]))
    torch.testing.assert_close(paged_attention(*args, scale=0.125),
                               paged_attention_plain(*args, scale=0.125),
                               rtol=0, atol=0)
    assert paged_attention.launches == before
    p = _prefill_inputs("idle_slot")
    before = paged_prefill.launches
    t = {n: torch.from_numpy(p[n]) for n in
         ("q", "pos", "table", "q_pos", "start", "ck", "cv")}
    kt = torch.from_numpy(p["k"]).to(torch.bfloat16)
    vt = torch.from_numpy(p["v"]).to(torch.bfloat16)
    pargs = (t["q"], kt, vt, t["pos"], t["table"], t["q_pos"], t["start"],
             t["ck"], t["cv"], t["q_pos"])
    torch.testing.assert_close(paged_prefill(*pargs, scale=0.125),
                               paged_prefill_plain(*pargs, scale=0.125),
                               rtol=0, atol=0)
    assert paged_prefill.launches == before


@pytest.mark.cuda
def test_cuda_kernels_match_plain():
    """Each CUDA kernel against its plain version on the card, on every
    decode and prefill case above (atol = rtol = 1e-4); the split cases
    do split on the card, and masked lanes and rows are exactly 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    dev = torch.device("cuda")
    _, pp = _paged_mods()
    for case in sorted(DECODE_CASES) + sorted(DECODE_EDGES):
        d = _decode_inputs(case)
        if case in DECODE_SPLIT:
            b = len(d["q_pos"])
            assert build.split_count(b * d["hkv"], d["maxp"], d["ps"],
                                     dev) > 1
        args = (torch.from_numpy(d["q"]).to(dev),
                torch.from_numpy(d["k"]).to(dev, torch.bfloat16),
                torch.from_numpy(d["v"]).to(dev, torch.bfloat16),
                torch.from_numpy(d["pos"]).to(dev),
                torch.from_numpy(d["table"]).to(dev),
                torch.from_numpy(d["q_pos"]).to(dev))
        n = paged_attention.launches
        got = paged_attention(*args, scale=0.125, window=d["window"])
        torch.cuda.synchronize()
        assert paged_attention.launches == n + 1
        want = paged_attention_plain(*args, scale=0.125,
                                     window=d["window"])
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
        assert (got[args[5] < 0] == 0).all()
    for case in sorted(PREFILL_CASES) + sorted(PREFILL_EDGES):
        p = _prefill_inputs(case)
        if case in PREFILL_SPLIT:
            b, c, h = p["q"].shape[:3]
            units = b * p["hkv"] * pp._row_tiles(c, h // p["hkv"])
            assert build.split_count(units, p["maxp"], p["ps"], dev,
                                     **pp._SPLIT) > 1
        t = {n: torch.from_numpy(p[n]).to(dev) for n in
             ("q", "pos", "table", "q_pos", "start", "ck", "cv")}
        pargs = (t["q"], torch.from_numpy(p["k"]).to(dev, torch.bfloat16),
                 torch.from_numpy(p["v"]).to(dev, torch.bfloat16),
                 t["pos"], t["table"], t["q_pos"], t["start"], t["ck"],
                 t["cv"], t["q_pos"])
        n = paged_prefill.launches
        got = paged_prefill(*pargs, scale=0.125, window=p["window"])
        torch.cuda.synchronize()
        assert paged_prefill.launches == n + 1
        want = paged_prefill_plain(*pargs, scale=0.125, window=p["window"])
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
        assert (got[t["q_pos"] < 0] == 0).all()


def _paged_mods():
    """The paged kernels' modules (the package attributes of these names
    are the wrappers)."""
    return (importlib.import_module("repro_torch.kernels.paged_attention"),
            importlib.import_module("repro_torch.kernels.paged_prefill"))


@pytest.mark.parametrize("bad", ["pool_offset", "pool_slot_stride"])
def test_paged_wrappers_refuse_unaligned_pool_rows(bad):
    """Both kernels copy pool rows in 16-byte pieces: their `_check`
    raises on a bf16 pool whose base is off 16 bytes or whose (page,
    slot, head) strides are not multiples of 8 elements, and passes the
    model's contiguous pool."""
    pa, pp = _paged_mods()
    d = _decode_inputs("gqa")
    p_, ps, hkv, hd = d["k"].shape
    args = [torch.from_numpy(d["q"]), torch.zeros(d["k"].shape,
                                                  dtype=torch.bfloat16),
            torch.zeros(d["v"].shape, dtype=torch.bfloat16),
            torch.from_numpy(d["pos"]), torch.from_numpy(d["table"]),
            torch.from_numpy(d["q_pos"])]
    pf = _prefill_inputs("gqa_mid_page")
    t = {n: torch.from_numpy(pf[n]) for n in
         ("q", "pos", "table", "q_pos", "start", "ck", "cv")}
    pool = torch.zeros(pf["k"].shape, dtype=torch.bfloat16)
    pargs = [t["q"], pool, pool, t["pos"], t["table"], t["q_pos"],
             t["start"], t["ck"], t["cv"], t["q_pos"]]
    pa._check(*args)
    pp._check(*pargs)
    for a, i in ((args, 1), (pargs, 2)):
        shape = a[i].shape
        if bad == "pool_offset":
            bad_pool = torch.zeros(a[i].numel() + 4,
                                   dtype=torch.bfloat16)[4:].view(shape)
            assert bad_pool.data_ptr() % 16 == 8
        else:
            bad_pool = torch.zeros((*shape[:-1], shape[-1] + 4),
                                   dtype=torch.bfloat16)[..., :shape[-1]]
            assert bad_pool.stride(2) % 8 == 4
        a[i] = bad_pool
    with pytest.raises(ValueError, match="16 bytes"):
        pa._check(*args)
    with pytest.raises(ValueError, match="16 bytes"):
        pp._check(*pargs)


@pytest.mark.parametrize("hd", [96, 80])
def test_paged_wrappers_take_the_head_dims_with_an_instance(hd):
    """Both kernels have instances at head_dim 32, 64, 96 and 128: their
    `_check` (run before every launch) passes hd 96 and raises on a
    head_dim with no instance, such as 80."""
    pa, pp = _paged_mods()
    i32 = dict(dtype=torch.int32)
    b, c, h, hkv, ps, maxp = 2, 5, 4, 4, 8, 3
    pool = torch.zeros(7, ps, hkv, hd, dtype=torch.bfloat16)
    pos = torch.zeros(7, ps, **i32)
    table = torch.zeros(b, maxp, **i32)
    rows = torch.zeros(b, c, **i32)
    args = (torch.zeros(b, h, hd), pool, pool, pos, table,
            torch.zeros(b, **i32))
    pargs = (torch.zeros(b, c, h, hd), pool, pool, pos, table, rows,
             torch.zeros(b, **i32), torch.zeros(b, c, hkv, hd),
             torch.zeros(b, c, hkv, hd), rows)
    assert (hd in pa.HEAD_DIMS) == (hd in pp.HEAD_DIMS) == (hd == 96)
    if hd == 96:
        pa._check(*args)
        pp._check(*pargs)
        return
    with pytest.raises(ValueError, match="hd 32/64/96/128"):
        pa._check(*args)
    with pytest.raises(ValueError, match="hd 32/64/96/128"):
        pp._check(*pargs)


@pytest.mark.parametrize("bad", ["q_offset", "ck_seq_stride"])
def test_paged_prefill_refuses_unaligned_f32_rows(bad):
    """The prefill kernel copies q, ck and cv rows in 16-byte pieces: its
    `_check` raises on a contiguous view off 16 bytes (the wrapper makes
    them contiguous first, so a row stride can only be off for a view
    passed to `_check` itself)."""
    _, pp = _paged_mods()
    pf = _prefill_inputs("gqa_mid_page")
    t = {n: torch.from_numpy(pf[n]) for n in
         ("q", "pos", "table", "q_pos", "start", "ck", "cv")}
    pool = torch.zeros(pf["k"].shape, dtype=torch.bfloat16)
    q, ck = t["q"], t["ck"]
    if bad == "q_offset":
        q = torch.zeros(q.numel() + 1)[1:].view(q.shape)
        assert q.data_ptr() % 16 == 4
    else:
        b, c, hkv, hd = ck.shape
        ck = torch.zeros((b, c, hkv * hd + 2))[:, :, :hkv * hd].view(
            b, c, hkv, hd)
        assert ck.stride(1) % 4 == 2
    with pytest.raises(ValueError, match="16 bytes"):
        pp._check(q, pool, pool, t["pos"], t["table"], t["q_pos"],
                  t["start"], ck, t["cv"], t["q_pos"])


@pytest.mark.parametrize("kernel", ["paged_attention", "paged_prefill"])
def test_paged_wrappers_refuse_grids_past_the_limits(kernel):
    """The grids' limits: decode takes Hkv <= 65535 kv heads (grid y);
    prefill B * Hkv * ceil(C * G / 16) < 2^31 blocks.  Stride-0 views
    give the shapes without the memory."""
    pa, pp = _paged_mods()
    i32 = dict(dtype=torch.int32)
    if kernel == "paged_attention":
        hkv, b = 65536, 1
        q = torch.zeros(1, 1, 32).expand(b, hkv, 32)
        pool = torch.zeros(1, 1, 1, 32, dtype=torch.bfloat16).expand(
            2, 8, hkv, 32)
        args = (q, pool, pool, torch.zeros(2, 8, **i32),
                torch.zeros(b, 1, **i32), torch.zeros(b, **i32))
        with pytest.raises(ValueError, match="65535"):
            pa._check(*args)
    else:
        b, c, hkv = 2 ** 16, 2 ** 16, 2 ** 4   # 2^36 rows, 16 a block
        q = torch.zeros(1, 1, 1, 32).expand(b, c, hkv, 32)
        pool = torch.zeros(1, 1, 1, 32, dtype=torch.bfloat16).expand(
            2, 8, hkv, 32)
        rows = torch.zeros(1, 1, **i32).expand(b, c)
        args = (q, pool, pool, torch.zeros(2, 8, **i32),
                torch.zeros(1, 1, **i32).expand(b, 1), rows,
                torch.zeros(1, **i32).expand(b), q, q, rows)
        with pytest.raises(ValueError, match="2\\^31"):
            pp._check(*args)


# --------------------------------------------------------------------------
# flash attention (whole-prompt prefill)
# --------------------------------------------------------------------------

FLASH_CASES = {
    # name: (b, s, h, hkv, hd, window)
    "causal_ragged": (2, 19, 4, 4, 32, None),
    "gqa": (2, 24, 4, 2, 64, None),
    "window": (1, 40, 4, 2, 32, 8),
    "gqa_window_tiles": (1, 150, 4, 1, 96, 48),   # several 64-row tiles
    "hd128": (1, 70, 2, 2, 128, None),
    # lengths at and around the 64-row tile, one per head dim
    "s1_hd32": (2, 1, 4, 2, 32, None),
    "s63_hd64": (1, 63, 4, 4, 64, None),
    "s65_hd96": (1, 65, 4, 2, 96, 20),
    "s129_hd128": (1, 129, 2, 1, 128, None),
}

# the card-only test's extra cases: every length of FLASH_CASES' tile
# edges at every head dim, GQA, half of them with a window
FLASH_EDGES = {f"s{s}_hd{hd}": (1, s, 4, 2, hd, 24 if (s + hd) % 2 else None)
               for s in (1, 63, 65, 129) for hd in (32, 64, 96, 128)}


def _flash_inputs(case):
    if case in FLASH_CASES:
        b, s, h, hkv, hd, window = FLASH_CASES[case]
        seed = 20 + sorted(FLASH_CASES).index(case)
    else:
        b, s, h, hkv, hd, window = FLASH_EDGES[case]
        seed = 40 + sorted(FLASH_EDGES).index(case)
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, s, h, hd)).astype(np.float32)
    k = rng.normal(size=(b, s, hkv, hd)).astype(np.float32)
    v = rng.normal(size=(b, s, hkv, hd)).astype(np.float32)
    return q, k, v, dict(scale=1.0 / np.sqrt(hd), window=window)


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_attention_plain_matches_jax(case, jx):
    jnp, ops, ref = jx.jnp, jx.ops, jx.ref
    q, k, v, kw = _flash_inputs(case)
    out = flash_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), **kw).numpy()
    assert out.shape == q.shape and np.isfinite(out).all()
    r = ref.flash_attention_ref(
        *(jnp.asarray(a).transpose(0, 2, 1, 3) for a in (q, k, v)), **kw)
    np.testing.assert_allclose(out, np.asarray(r).transpose(0, 2, 1, 3),
                               **TOL)
    pallas = ops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), block_q=64, block_kv=64,
                                 interpret=True, **kw)
    np.testing.assert_allclose(out, np.asarray(pallas), **TOL)


# --------------------------------------------------------------------------
# Bellman backup (line DP)
# --------------------------------------------------------------------------

def _bellman_inputs(k, seed):
    """A backup as the solve gives it: phi rows sorted along X, a
    row-stochastic transition and a min-index table from a sorted grid
    (mi_t[y, x] = X-index of min(xvals[x], grid[y]))."""
    rng = np.random.default_rng(seed)
    x = k + 2
    grid = np.sort(rng.uniform(0.01, 1.0, k)).astype(np.float32)
    xv = np.concatenate([[0.0], grid, [grid[-1] * 1e4 + 1e4]])
    mi = np.where(xv[:, None] <= grid[None, :], np.arange(x)[:, None],
                  np.arange(1, k + 1)[None, :])
    phi = np.sort(rng.uniform(0, 1, (k, x)), axis=1).astype(np.float32)
    trans = rng.dirichlet(np.ones(k), size=k).astype(np.float32)
    return phi, trans, np.float32(0.17), mi.T.astype(np.int32).copy()


@pytest.mark.parametrize("k", [8, 24])
def test_bellman_backup_plain_matches_jax(k, jx):
    jnp, ops, ref = jx.jnp, jx.ops, jx.ref
    phi, trans, cost, mi_t = _bellman_inputs(k, k)
    out = bellman_backup_plain(torch.from_numpy(phi),
                               torch.from_numpy(trans), float(cost),
                               torch.from_numpy(mi_t)).numpy()
    assert out.shape == (k, k + 2)
    j = [jnp.asarray(a) for a in (phi, trans, cost, mi_t)]
    np.testing.assert_allclose(out, np.asarray(ref.bellman_backup_ref(*j)),
                               **TOL)
    np.testing.assert_allclose(
        out, np.asarray(ops.bellman_backup(*j, interpret=True)), **TOL)


def _solve_inputs(n, k, seed):
    """A backward line solve as `solve_line` gives it: p0 and n - 1
    row-stochastic transitions, positive costs and a sorted grid (numpy),
    with the base phi, the (n, K, K) transitions (p0 on every row first),
    xvals and mi_t derived from them."""
    rng = np.random.default_rng(seed)
    grid = np.sort(rng.uniform(0.01, 1.0, k)).astype(np.float32)
    p0 = rng.dirichlet(np.ones(k)).astype(np.float32)
    trans = rng.dirichlet(np.ones(k), size=(n - 1, k)).astype(np.float32)
    costs = rng.uniform(0.01, 0.2, n).astype(np.float32)
    xv = np.concatenate([[0.0], grid, [grid[-1] * 1e4 + 1e4]]).astype(
        np.float32)
    mi = np.where(xv[:, None] <= grid[None, :], np.arange(k + 2)[:, None],
                  np.arange(1, k + 1)[None, :])
    full = np.concatenate([np.tile(p0, (1, k, 1)), trans], axis=0)
    solve = (np.tile(xv, (k, 1)), full, costs, xv,
             mi.T.astype(np.int32).copy())
    return (p0, trans, costs, grid), solve


def _chained(backup, base, trans_full, costs, xvals, mi_t):
    """The solve as n single backups, each followed by its minimum."""
    conts, phis = [], [base]
    for i in reversed(range(trans_full.shape[0])):
        conts.append(backup(phis[-1], trans_full[i], costs[i:i + 1], mi_t))
        phis.append(torch.minimum(xvals[None, :], conts[-1]))
    return torch.stack(conts[::-1]), torch.stack(phis[::-1])


@pytest.mark.parametrize("n", [1, 6])
@pytest.mark.parametrize("k", [8, 24])
def test_bellman_solve_plain_matches_jax(k, n, jx):
    """The solve's plain version against the JAX package's
    ``solve_line(use_kernel=True)`` (the Pallas backup in interpret mode,
    inside its `lax.scan`) and against n chained plain backups and
    minimums: cont and phi within 1e-5."""
    from repro.core import line_dp as jline
    from repro.core.markov import MarkovChain
    from repro.core.support import Support

    (p0, trans, costs, grid), arrs = _solve_inputs(n, k, 7 * k + n)
    args = [torch.from_numpy(a) for a in arrs]
    cont, phi = bellman_solve_plain(*args)
    assert cont.shape == (n, k, k + 2) and phi.shape == (n + 1, k, k + 2)
    jnp = jx.jnp
    jt = jline.solve_line(
        MarkovChain(p0=jnp.asarray(p0), trans=jnp.asarray(trans)),
        jnp.asarray(costs),
        Support(grid=jnp.asarray(grid),
                edges=jnp.asarray((grid[1:] + grid[:-1]) / 2)),
        use_kernel=True)
    np.testing.assert_allclose(cont.numpy(), np.asarray(jt.cont), **TOL)
    np.testing.assert_allclose(phi.numpy(), np.asarray(jt.phi), **TOL)
    for got, want in zip((cont, phi), _chained(bellman_backup_plain, *args)):
        torch.testing.assert_close(got, want, **TOL)


def test_new_wrappers_take_the_plain_version_on_cpu():
    """On CPU tensors the flash and Bellman wrappers (the single backup
    and the whole solve) ARE the plain versions and launch nothing."""
    q, k, v, kw = _flash_inputs("gqa")
    args = [torch.from_numpy(a) for a in (q, k, v)]
    before = flash_attention.launches
    torch.testing.assert_close(flash_attention(*args, **kw),
                               flash_attention_plain(*args, **kw),
                               rtol=0, atol=0)
    assert flash_attention.launches == before
    phi, trans, cost, mi_t = _bellman_inputs(8, 3)
    bargs = (torch.from_numpy(phi), torch.from_numpy(trans), float(cost),
             torch.from_numpy(mi_t))
    before = bellman_backup.launches
    torch.testing.assert_close(bellman_backup(*bargs),
                               bellman_backup_plain(*bargs), rtol=0, atol=0)
    sargs = [torch.from_numpy(a) for a in _solve_inputs(6, 8, 3)[1]]
    for got, want in zip(bellman_solve(*sargs), bellman_solve_plain(*sargs)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert bellman_backup.launches == before


def _flash_mod():
    """The module (the package attribute of that name is the wrapper)."""
    return importlib.import_module("repro_torch.kernels.flash_attention")


@pytest.mark.parametrize("bad", ["q_offset", "k_seq_stride", "v_head_stride"])
def test_flash_wrapper_refuses_unaligned_rows(bad):
    """The kernel copies rows in 16-byte pieces: `_check` (what the
    wrapper runs before a launch) raises on a base pointer off 16 bytes
    or a (batch, seq, head) stride that is not a multiple of 4, and
    passes the aligned tensors and strides of length-1 axes."""
    b, s, h, hd = 2, 8, 4, 32
    q, k, v = (torch.zeros((b, s, h, hd)) for _ in range(3))
    mod = _flash_mod()
    mod._check(q, k, v)
    # a batch of one: its batch stride is never used
    one = [torch.as_strided(torch.zeros(s * h * hd), (1, s, h, hd),
                            (3, h * hd, hd, 1)) for _ in range(3)]
    mod._check(*one)
    if bad == "q_offset":
        q = torch.zeros(b * s * h * hd + 1)[1:].view(b, s, h, hd)
        assert q.data_ptr() % 16 == 4
    elif bad == "k_seq_stride":
        k = torch.zeros((b, s, h * hd + 2))[:, :, :h * hd].view(
            b, s, h, hd)
        assert k.stride(1) % 4 == 2
    else:
        v = torch.zeros((b, s, h, hd + 1))[..., :hd]
        assert v.stride(2) == hd + 1
    with pytest.raises(ValueError, match="16 bytes"):
        mod._check(q, k, v)


@pytest.mark.cuda
def test_cuda_bellman_solve_matches_chained_launches():
    """The n-node solve kernel on the card, at K in {8, 24, 64} and n in
    {1, 6, 13}: one launch a solve; cont and phi EQUAL (bit for bit) to
    n chained single-backup launches of the same kernel and their
    minimums (each output sums y in ascending order in one FMA chain,
    whatever n), and within atol = rtol = 1e-5 of the plain solve."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    dev = torch.device("cuda")
    for k in (8, 24, 64):
        for n in (1, 6, 13):
            args = [torch.from_numpy(a).to(dev)
                    for a in _solve_inputs(n, k, 7 * k + n)[1]]
            before = bellman_backup.launches
            got = bellman_solve(*args)
            torch.cuda.synchronize()
            assert bellman_backup.launches == before + 1
            chained = _chained(bellman_backup, *args)
            assert bellman_backup.launches == before + 1 + n
            for g, c, w in zip(got, chained, bellman_solve_plain(*args)):
                assert torch.equal(g, c), (k, n)
                torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
def test_cuda_flash_and_bellman_match_plain():
    """The flash kernel against its plain version on every case above
    and at S in {1, 63, 65, 129} for each head dim (atol = rtol = 1e-4),
    and the Bellman kernel at K = 8, 24 and 64 (atol = rtol = 1e-5), on
    the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    dev = torch.device("cuda")
    for case in sorted(FLASH_CASES) + sorted(FLASH_EDGES):
        q, k, v, kw = _flash_inputs(case)
        args = [torch.from_numpy(a).to(dev) for a in (q, k, v)]
        n = flash_attention.launches
        got = flash_attention(*args, **kw)
        torch.cuda.synchronize()
        assert flash_attention.launches == n + 1
        want = flash_attention_plain(*args, **kw)
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    for kk in (8, 24, 64):
        phi, trans, cost, mi_t = _bellman_inputs(kk, kk)
        bargs = (torch.from_numpy(phi).to(dev),
                 torch.from_numpy(trans).to(dev),
                 torch.tensor(cost, device=dev),
                 torch.from_numpy(mi_t).to(dev))
        n = bellman_backup.launches
        got = bellman_backup(*bargs)
        torch.cuda.synchronize()
        assert bellman_backup.launches == n + 1
        torch.testing.assert_close(got, bellman_backup_plain(*bargs),
                                   atol=1e-5, rtol=1e-5)


# --------------------------------------------------------------------------
# SSD chunk (Mamba2 prefill)
# --------------------------------------------------------------------------

def _ssd_inputs(b, c, q, h, p, n, seed, dev, q_valid=None):
    """Inputs drawn as the model makes them: dt = softplus(.), da = -e *
    dt (a_log = 1), so exp(seg_i - seg_j) overflows above the diagonal;
    B and C broadcast over the heads with stride 0 (one group).  With
    ``q_valid``, the rows of the last chunk from it on are zero in every
    input, as the model pads them."""
    rng = np.random.default_rng(seed)
    dt = np.logaddexp(rng.normal(size=(b, c, q, h)), 0.0)
    arrs = dict(xh=rng.normal(size=(b, c, q, h, p)), dt=dt, da=-np.e * dt,
                bb=rng.normal(size=(b, c, q, 1, n)),
                cc=rng.normal(size=(b, c, q, 1, n)))
    if q_valid is not None:
        for a in arrs.values():
            a[:, -1, q_valid:] = 0.0
    t = {k: torch.from_numpy(v.astype(np.float32)).to(dev)
         for k, v in arrs.items()}
    shape = (b, c, q, h, n)
    return (t["xh"], t["dt"], t["da"], t["bb"].expand(shape),
            t["cc"].expand(shape))


@pytest.mark.cuda
def test_cuda_ssd_chunk_matches_plain():
    """The SSD-chunk kernel against its plain version on the card, at a
    small shape (Q 32, N 16, P 32, two chunks) and at a ring admission's
    (one 256-row chunk, 24 heads, P 64, N 128), atol = rtol = 2e-4;
    every output finite."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    dev = torch.device("cuda")
    cases = [((2, 2, 32, 3, 32, 16), None), ((1, 1, 256, 24, 64, 128), None)]
    # the caller's zero tail: q_valid rows of the last chunk computed
    cases += [((1, 1, 256, 24, 64, 128), qv) for qv in (1, 37, 64, 200, 256)]
    cases += [((2, 4, 256, 24, 64, 128), 37), ((2, 3, 32, 4, 32, 16), 5)]
    for shape, qv in cases:
        args = _ssd_inputs(*shape, seed=shape[2] + (qv or 0), dev=dev,
                           q_valid=qv)
        n = ssd_chunk.launches
        got = ssd_chunk(*args, q_valid=qv)
        torch.cuda.synchronize()
        assert ssd_chunk.launches == n + 1
        want = ssd_chunk_plain(*args, q_valid=qv)
        for g, w in zip(got, want):
            assert torch.isfinite(g).all()
            torch.testing.assert_close(g, w, atol=2e-4, rtol=2e-4)
        if qv is not None:
            assert (got[0][:, -1, qv:] == 0).all()


@pytest.mark.cuda
def test_cuda_kernels_at_hymba_shapes():
    """The three kernels of hymba-1.5b's serve path at its widths, on the
    card: ssd_chunk at d_state 16 and 50 heads of 64 (its calibration's
    64 valid rows of a 256-row chunk, an admission's 32, a full chunk,
    two chunks with a ragged last one), atol = rtol = 2e-4, rows past
    q_valid exactly 0; flash at 25 heads on 5 kv heads of 64 with the
    1024-token window, past the window (S 1100) and inside it (S 200),
    and paged decode at the same widths over 16-token pages with
    histories of 1100-1300 positions (the window cuts every lane),
    atol = rtol = 1e-4; one launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    dev = torch.device("cuda")
    for shape, qv in (((1, 1, 256, 50, 64, 16), 64),
                      ((1, 1, 256, 50, 64, 16), 32),
                      ((2, 1, 256, 50, 64, 16), None),
                      ((2, 2, 256, 50, 64, 16), 37)):
        args = _ssd_inputs(*shape, seed=shape[0] + (qv or 0), dev=dev,
                           q_valid=qv)
        n = ssd_chunk.launches
        got = ssd_chunk(*args, q_valid=qv)
        torch.cuda.synchronize()
        assert ssd_chunk.launches == n + 1
        for g, w in zip(got, ssd_chunk_plain(*args, q_valid=qv)):
            assert torch.isfinite(g).all()
            torch.testing.assert_close(g, w, atol=2e-4, rtol=2e-4)
        if qv is not None:
            assert (got[0][:, -1, qv:] == 0).all()
    rng = np.random.default_rng(23)
    for b, s in ((1, 1100), (2, 200)):
        q, k, v = (torch.from_numpy(rng.normal(size=(b, s, h, 64)).astype(
            np.float32)).to(dev) for h in (25, 5, 5))
        n = flash_attention.launches
        got = flash_attention(q, k, v, scale=0.125, window=1024)
        torch.cuda.synchronize()
        assert flash_attention.launches == n + 1
        torch.testing.assert_close(
            got, flash_attention_plain(q, k, v, scale=0.125, window=1024),
            atol=1e-4, rtol=1e-4)
    lens = (1100, 1300, 1025, 1201)
    k, v, pos, pages, _ = _pool(rng, hkv=5, hd=64, ps=16, starts=lens,
                                holes=True, stale_page=False)
    table = _table(pages, 82, 0)
    args = (torch.from_numpy((rng.normal(size=(4, 25, 64)) * 0.5).astype(
                np.float32)).to(dev),
            torch.from_numpy(k).to(dev, torch.bfloat16),
            torch.from_numpy(v).to(dev, torch.bfloat16),
            torch.from_numpy(pos).to(dev), torch.from_numpy(table).to(dev),
            torch.tensor([n - 1 for n in lens], dtype=torch.int32,
                         device=dev))
    n = paged_attention.launches
    got = paged_attention(*args, scale=0.125, window=1024)
    torch.cuda.synchronize()
    assert paged_attention.launches == n + 1
    torch.testing.assert_close(
        got, paged_attention_plain(*args, scale=0.125, window=1024),
        atol=1e-4, rtol=1e-4)


# --------------------------------------------------------------------------
# ramp exit (the fused exit decision)
# --------------------------------------------------------------------------

# the JAX test's three shapes, then the paper-ee-100m readout's, one
# lane of it, and a row shorter than one split's 16-byte words
EXIT_SHAPES = [(4, 1000, 16), (8, 4096, 32), (3, 2048, 64), (8, 50257, 24),
               (1, 50257, 24), (2, 7, 8)]


def _exit_inputs(b, v, k):
    """The JAX test's draws: logits ~ N(0, 2), sorted edges in (0, 1), a
    0/1 int32 stop table, lane state over its whole range."""
    rng = np.random.default_rng(b * v)
    return (rng.normal(0, 2, (b, v)).astype(np.float32),
            np.sort(rng.uniform(0, 1, k - 1)).astype(np.float32),
            rng.integers(0, 2, (k, k + 2)).astype(np.int32),
            rng.integers(0, k, b).astype(np.int32),
            rng.integers(0, k + 2, b).astype(np.int32))


def _exit_equal(got, want):
    np.testing.assert_allclose(np.asarray(got[0]), np.asarray(want[0]),
                               **TOL)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize("b,v,k", EXIT_SHAPES)
@pytest.mark.parametrize("against", ["ref", "interpret"])
def test_ramp_exit_plain_matches_reference(jx, b, v, k, against):
    """The plain version (what a CPU tensor runs) against
    ``repro.kernels.ref.ramp_exit_ref`` and against the Pallas kernel in
    interpret mode (``ops.ramp_exit``, which pads V and B), lam 0.6."""
    arrs = _exit_inputs(b, v, k)
    j = [jx.jnp.asarray(a) for a in arrs]
    if against == "ref":
        want = jx.ref.ramp_exit_ref(*j, 0.6)
    else:
        want = jx.ops.ramp_exit(*j, lam=0.6, interpret=True)
    before = ramp_exit.launches
    got = ramp_exit(*(torch.from_numpy(a) for a in arrs), lam=0.6)
    assert ramp_exit.launches == before         # CPU: the plain version
    _exit_equal([t.numpy() for t in got], want)
    assert got[3].dtype == torch.bool


def test_ramp_exit_takes_the_line_dp_bool_table_and_row_views():
    """A bool table (as `LineTables.stop` holds it) decides as its 0/1
    integer copy does, a row view of a wider tensor as its contiguous
    copy, and s_bin does not enter the decision."""
    logits, edges, table, s_bin, x_idx = (torch.from_numpy(a) for a in
                                          _exit_inputs(8, 4096, 32))
    want = ramp_exit_plain(logits, edges, table, s_bin, x_idx, lam=0.6)
    wide = torch.zeros((8, 4096 + 5))
    wide[:, 2:2 + 4096] = logits
    got = ramp_exit(wide[:, 2:2 + 4096], edges, table.bool(), s_bin + 1,
                    x_idx, lam=0.6)
    _exit_equal([t.numpy() for t in got], [t.numpy() for t in want])


@pytest.mark.cuda
def test_cuda_ramp_exit_matches_plain():
    """The exit-decision kernel against its plain version on the card at
    every shape above and at 512 lanes of the readout, with an int32 and
    a bool table, f32 and bf16 logits, and as row views of a wider
    tensor starting at elements 1, 2 and 3 (rows off 16 bytes: scalar
    head and tail): loss within atol = rtol = 1e-5, and bin, new x and
    stop equal to the plain decision recomputed from the kernel's own
    loss.  (2, 7) is split over 2 blocks, fewer elements than their
    16-byte words hold."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    from repro_torch.kernels.ramp_exit import exit_splits

    dev = torch.device("cuda")
    assert exit_splits(2, 7, torch.float32, dev) == 2
    cases = [(shape, torch.float32, 0) for shape in EXIT_SHAPES]
    cases += [((512, 50257, 24), torch.float32, 0)]
    cases += [(shape, dt, off) for shape in ((8, 50257, 24), (2, 7, 8))
              for dt in (torch.float32, torch.bfloat16) for off in (1, 2, 3)]
    for shape, dt, off in cases:
        logits, edges, table, s_bin, x_idx = (
            torch.from_numpy(a).to(dev) for a in _exit_inputs(*shape))
        if off:
            wide = torch.zeros((shape[0], shape[1] + 5), dtype=dt,
                               device=dev)
            wide[:, off:off + shape[1]] = logits
            logits = wide[:, off:off + shape[1]]
        else:
            logits = logits.to(dt)
        for tab in (table, table.bool()):
            n = ramp_exit.launches
            got = ramp_exit(logits, edges, tab, s_bin, x_idx, lam=0.6)
            torch.cuda.synchronize()
            assert ramp_exit.launches == n + 1
            want = ramp_exit_plain(logits, edges, tab, s_bin, x_idx,
                                   lam=0.6)
            torch.testing.assert_close(got[0], want[0], **TOL)
            b = torch.searchsorted(edges, got[0]).to(torch.int32)
            nx = torch.minimum(x_idx, b + 1)
            assert torch.equal(got[1], b) and torch.equal(got[2], nx)
            assert torch.equal(got[3], tab[b.long(), nx.long()] > 0)


@pytest.mark.cuda
def test_wrappers_refuse_autograd_on_the_card():
    """On CUDA tensors each kernel wrapper raises when an input requires
    grad under autograd, before it builds or launches anything."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    dev = torch.device("cuda")

    def g(*shape):
        return torch.zeros(shape, device=dev, requires_grad=True)

    z = torch.zeros((), device=dev)
    k = kernels
    calls = {
        "flash_attention": lambda: k.flash_attention(
            g(1, 4, 2, 32), g(1, 4, 2, 32), g(1, 4, 2, 32), scale=1.0),
        "paged_attention": lambda: k.paged_attention(
            g(1, 2, 32), g(2, 4, 2, 32), g(2, 4, 2, 32), z, z, z, scale=1.),
        "paged_prefill": lambda: k.paged_prefill(
            g(1, 4, 2, 32), g(2, 4, 2, 32), g(2, 4, 2, 32), z, z, z, z,
            g(1, 4, 2, 32), g(1, 4, 2, 32), z, scale=1.0),
        "ssd_chunk": lambda: k.ssd_chunk(
            g(1, 1, 4, 2, 8), g(1, 1, 4, 2), g(1, 1, 4, 2),
            g(1, 1, 4, 2, 4), g(1, 1, 4, 2, 4)),
        "ramp_exit": lambda: k.ramp_exit(g(2, 16), g(5), z, z, z, lam=1.0),
        "bellman_backup": lambda: k.bellman_backup(g(4, 3), g(4, 4), g(1),
                                                   z),
        "bellman_solve": lambda: k.bellman_solve(g(4, 3), g(2, 4, 4), g(2),
                                                 None, z),
    }
    for name, call in calls.items():
        with pytest.raises(NotImplementedError, match="no backward"):
            call()
