"""Attention mixers: GQA (with qk-norm and sliding windows) and MLA
(DeepSeek-V2 multi-head latent attention).  Each has the full-sequence
path (whole-prompt prefill) and the one-token decode against a lane's
ring cache or against the paged KV pool; GQA also has the prefill chunk
against the same pool (MLA admits by whole-prompt prefill only, as in
the JAX package).

Ring layout: GQA ``k, v: (B, C, Hkv, hd)`` bf16, MLA ``c_kv: (B, C,
kv_lora)`` and ``k_rope: (B, C, rope_dim)`` bf16, and ``pos: (B, C)``
i32 per lane, position p stored at slot ``p % C`` (-1 = empty slot).  Decode
writes the new token's slot in place (a scatter along the slot dim,
`sharding.ctx.scatter_rows_`, which a DTensor ring writes shard by
shard); the engine puts back the slots of lanes that were not active
(``_mask_lane_writes``).

Paged layout (serving.kvpool): the same leaves with the lane axis
replaced by a global page pool, ``k, v: (P, page, Hkv, hd)`` (MLA
``c_kv``, ``k_rope``: ``(P, page, ...)``) bf16 and ``pos: (P, page)``
i32, plus a per-lane `PagedKV`
handle carrying the page table and this token's (page, slot) write
target.  Page 0 is the reserved garbage sink: lanes masked out by
``write_mask`` (early-exited or unoccupied) write their K/V there with
position -1, so those bytes are never attended; unused page-table
entries also point at page 0.

Pool writes are IN PLACE (``index_put_``), where the JAX package
returns a new pool from ``.at[...].set``.  Several lanes may write the
same (page, slot) only on the garbage page 0, and every such write
stores position -1, so the order in which duplicates land never
matters.

``paged_kernel(True)`` routes the GQA paged decode and the prefill chunk
through the CUDA kernels of `repro_torch.kernels`; off, they take the
page-table gather plus `_sdpa`, as the JAX package's default does.  MLA
attends in its latent space (the absorbed-matmul decode) over the page
gather either way, and never through the flash kernel: the kernels
compute GQA attention only, and the MLA paths return before the
switches are read, as in the JAX package.

int8 caches (`models.quant.cache_int8`): K/V (MLA: ``c_kv`` and
``k_rope``) are int8 beside bf16 scales ``k_s, v_s: (.., Hkv)`` (MLA
``c_kv_s, k_rope_s``: one a position).  Each path picks its int8
branch from the cache's own leaves; an int8 pool always takes the page
gather, whatever `paged_kernel` says, because the kernels read bf16
pools (the JAX package's rule).

Long prompts: a whole-prompt prefill of ``S >= 16384`` tokens (``S`` a
multiple of 2048) without flash never forms the (S, S) scores; it runs
2048-query chunks, each against the keys it can see (`attention_impl`
"banded", the default) or against all of them ("chunked").
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import (flash_attention, paged_attention,
                                 paged_prefill)
from repro_torch.models.common import (causal_mask, rms_norm, rope,
                                       rope_cos_sin)
from repro_torch.models.config import AttnConfig
from repro_torch.models.param import ParamDef
from repro_torch.models.quant import (dequantize_rows, int8_enabled,
                                      quantize_rows)
from repro_torch.sharding.ctx import (dtensor_mesh, kv_heads,
                                     scatter_rows_, sdpa_sharded,
                                     split_heads)

__all__ = ["attn_defs", "attn_forward", "attn_decode",
           "attn_prefill_chunk", "init_cache_defs", "PagedKV",
           "PrefillChunk", "paged_kernel", "attention_impl"]

# must agree with serving.kvpool.alloc.GARBAGE_PAGE (a literal, so the
# model layer never imports the serving layer)
_GARBAGE_PAGE = 0


class PagedKV(NamedTuple):
    """Per-token device view of a lane's paged-KV state (the host-side
    planner is serving.kvpool.KVPool)."""

    page_table: torch.Tensor   # (B, lane_pages) i32, garbage-page padded
    write_page: torch.Tensor   # (B,) i32 page receiving this token's KV
    write_slot: torch.Tensor   # (B,) i32 slot within that page


class PrefillChunk(NamedTuple):
    """Per-step device view of the prefill chunks co-scheduled with
    decode: up to C prompt tokens per admitting lane, planned host-side
    by the scheduler's chunk planner.  Idle lanes and ragged tails are
    padded: position -1 rows are inert, garbage-page destinations
    swallow their writes."""

    tok: torch.Tensor          # (B, C) i32 chunk tokens (0 for padding)
    pos: torch.Tensor          # (B, C) i32 absolute positions (-1 = pad)
    dest_page: torch.Tensor    # (B, C) i32 pool page per token
    dest_slot: torch.Tensor    # (B, C) i32 slot within the page
    start: torch.Tensor        # (B,) i32 chunk-start position
    last_idx: torch.Tensor     # (B,) i32 row of the chunk's last token
    emit: torch.Tensor         # (B,) bool final chunk: emit first token
    active: torch.Tensor       # (B,) bool lanes prefilling this step


def attn_defs(cfg: AttnConfig, d_model: int) -> dict:
    if cfg.mla is not None:
        m = cfg.mla
        h = cfg.n_heads
        defs = {
            "wq": ParamDef((d_model, h * (m.qk_nope_head_dim
                                          + m.qk_rope_head_dim)),
                           ("embed", "heads")),
            "w_dkv": ParamDef((d_model, m.kv_lora_rank + m.qk_rope_head_dim),
                              ("embed", None)),
            "kv_norm": ParamDef((m.kv_lora_rank,), (None,), init="ones"),
            "w_uk": ParamDef((m.kv_lora_rank, h * m.qk_nope_head_dim),
                             (None, "heads")),
            "w_uv": ParamDef((m.kv_lora_rank, h * m.v_head_dim),
                             (None, "heads")),
            "wo": ParamDef((h * m.v_head_dim, d_model), ("heads", "embed")),
        }
        if m.q_lora_rank:
            defs["w_dq"] = ParamDef((d_model, m.q_lora_rank), ("embed", None))
            defs["q_norm"] = ParamDef((m.q_lora_rank,), (None,), init="ones")
            defs["wq"] = ParamDef(
                (m.q_lora_rank, h * (m.qk_nope_head_dim + m.qk_rope_head_dim)),
                (None, "heads"))
        return defs
    defs = {
        "wq": ParamDef((d_model, cfg.n_heads * cfg.head_dim),
                       ("embed", "heads")),
        "wk": ParamDef((d_model, cfg.n_kv_heads * cfg.head_dim),
                       ("embed", "kv_heads")),
        "wv": ParamDef((d_model, cfg.n_kv_heads * cfg.head_dim),
                       ("embed", "kv_heads")),
        "wo": ParamDef((cfg.n_heads * cfg.head_dim, d_model),
                       ("heads", "embed")),
    }
    if cfg.qk_norm:
        defs["q_norm"] = ParamDef((cfg.head_dim,), (None,), init="ones")
        defs["k_norm"] = ParamDef((cfg.head_dim,), (None,), init="ones")
    return defs


def init_cache_defs(cfg: AttnConfig, batch: int, cache_len: int) -> dict:
    """(shape, dtype) spec of one layer's KV cache: bf16 K/V (MLA: the
    bf16 latent ``c_kv`` and the shared rope key ``k_rope``), i32 pos.
    Under `cache_int8` the K/V (latent) leaves are int8, with bf16
    scales ``k_s``/``v_s`` (B, C, Hkv) (MLA: ``c_kv_s``/``k_rope_s``
    (B, C))."""
    i8 = int8_enabled()
    kv_dt = torch.int8 if i8 else torch.bfloat16
    if cfg.mla is not None:
        m = cfg.mla
        out = {
            "c_kv": ((batch, cache_len, m.kv_lora_rank), kv_dt),
            "k_rope": ((batch, cache_len, m.qk_rope_head_dim), kv_dt),
            "pos": ((batch, cache_len), torch.int32),
        }
        if i8:
            out["c_kv_s"] = ((batch, cache_len), torch.bfloat16)
            out["k_rope_s"] = ((batch, cache_len), torch.bfloat16)
        return out
    out = {
        "k": ((batch, cache_len, cfg.n_kv_heads, cfg.head_dim), kv_dt),
        "v": ((batch, cache_len, cfg.n_kv_heads, cfg.head_dim), kv_dt),
        "pos": ((batch, cache_len), torch.int32),
    }
    if i8:
        out["k_s"] = ((batch, cache_len, cfg.n_kv_heads), torch.bfloat16)
        out["v_s"] = ((batch, cache_len, cfg.n_kv_heads), torch.bfloat16)
    return out


def _put(buf: torch.Tensor, idx, rows: torch.Tensor) -> None:
    """``buf[idx] = rows`` in place.  ``idx`` is a (page, slot) pair on
    the paged pool, or the ring slot of each row, (B,): row b goes to
    ``buf[b, idx[b]]`` (`sharding.ctx.scatter_rows_`)."""
    if isinstance(idx, tuple):
        buf.index_put_(idx, rows)
    else:
        scatter_rows_(buf, idx, rows)


def _write_kv(cache: dict, idx, k: torch.Tensor, v: torch.Tensor) -> None:
    """Write new K/V rows at ``idx`` (see `_put`) in place: cast to the
    cache's bf16, or, in an int8 cache, quantized beside their scales."""
    if "k_s" in cache:
        for name, x in (("k", k), ("v", v)):
            xq, xs = quantize_rows(x)
            _put(cache[name], idx, xq)
            _put(cache[name + "_s"], idx, xs)
        return
    _put(cache["k"], idx, k.to(cache["k"].dtype))
    _put(cache["v"], idx, v.to(cache["v"].dtype))


def _read_kv(cache: dict, name: str, dtype, index=None) -> torch.Tensor:
    """Leaf ``name`` of the cache (rows ``index`` of it, if given) in
    ``dtype``: an int8 leaf dequantized with its scales."""
    x = cache[name] if index is None else cache[name][index]
    if name + "_s" in cache:
        s = cache[name + "_s"] if index is None \
            else cache[name + "_s"][index]
        return dequantize_rows(x, s, dtype)
    return x.to(dtype)


def _scale(cfg: AttnConfig) -> float:
    return cfg.softmax_scale or 1.0 / math.sqrt(cfg.head_dim)


def _qk_norm(p, q, k, cfg: AttnConfig, eps):
    if cfg.qk_norm:
        q = rms_norm({"scale": p["q_norm"]}, q, eps)
        k = rms_norm({"scale": p["k_norm"]}, k, eps)
    return q, k


_CHUNK_THRESHOLD = 16_384  # chunk the queries of prompts this long
_Q_CHUNK = 2_048
_CAUSAL_GROUPS = 4         # causal banding: groups of chunks a key prefix

# Long-prompt attention: "banded" (the default) reads each query chunk's
# visible keys only; "chunked" reads all keys for every chunk.  Read at
# call time.
_ATTN_IMPL = contextvars.ContextVar("repro_torch_attn_impl",
                                    default="banded")


@contextlib.contextmanager
def attention_impl(name: str):
    """Run long-prompt attention "banded" or "chunked"."""
    if name not in ("chunked", "banded"):
        raise ValueError(f"attention_impl: {name!r} is not chunked or "
                         "banded")
    tok = _ATTN_IMPL.set(name)
    try:
        yield
    finally:
        _ATTN_IMPL.reset(tok)


def _long_prompt(s: int) -> bool:
    return s >= _CHUNK_THRESHOLD and s % _Q_CHUNK == 0


def _sdpa_chunked(q, k, v, q_pos, kv_pos, window, scale):
    """Query-chunked attention that never forms the (S, S) scores: one
    `_sdpa` a 2048-query chunk against all keys (or, under
    ``attention_impl("banded")``, `_sdpa_banded`).  q (B,S,H,hd); k, v
    (B,T,Hkv,*); S a multiple of the chunk."""
    if _ATTN_IMPL.get() == "banded":
        return _sdpa_banded(q, k, v, q_pos, kv_pos, window, scale)
    s = q.shape[1]
    if s % _Q_CHUNK:
        raise ValueError(f"_sdpa_chunked: S {s} is not a multiple of "
                         f"{_Q_CHUNK}")
    outs = []
    for lo in range(0, s, _Q_CHUNK):
        p_i = q_pos[:, lo:lo + _Q_CHUNK]
        outs.append(_sdpa(q[:, lo:lo + _Q_CHUNK], k, v,
                          causal_mask(p_i, kv_pos, window), scale))
    return torch.cat(outs, dim=1)


def _sdpa_banded(q, k, v, q_pos, kv_pos, window, scale):
    """Banded chunked attention: each query chunk reads only the keys it
    can see.

    * windowed: a band of the window rounded up to whole chunks plus one
      chunk, ending at the chunk's end; K/V are padded in front by
      ``band - chunk`` rows at position -1, so every band has one size;
    * causal: the chunks in `_CAUSAL_GROUPS` groups, group g's chunks
      against the key prefix that ends with the group.

    Assumes the prefill layout (q_pos == kv_pos, contiguous)."""
    s = q.shape[1]
    qc = _Q_CHUNK
    nc = s // qc
    if window is not None:
        band = min(((window + qc - 1) // qc + 1) * qc, s)
        pad = band - qc
        kp = F.pad(k, (0, 0, 0, 0, pad, 0))
        vp = F.pad(v, (0, 0, 0, 0, pad, 0))
        pad_pos = F.pad(kv_pos, (pad, 0), value=-1)
        outs = []
        for i in range(nc):
            lo = i * qc                  # the band ends at the chunk's end
            p_i = q_pos[:, lo:lo + qc]
            kp_i = pad_pos[:, lo:lo + band]
            mask = causal_mask(p_i, kp_i, window) & (kp_i >= 0)[:, None, :]
            outs.append(_sdpa(q[:, lo:lo + qc], kp[:, lo:lo + band],
                              vp[:, lo:lo + band], mask, scale))
        return torch.cat(outs, dim=1)
    groups = min(_CAUSAL_GROUPS, nc)
    if nc % groups:
        raise ValueError(f"_sdpa_banded: {nc} chunks do not split into "
                         f"{groups} groups")
    per = nc // groups
    outs = []
    for g in range(groups):
        hi = (g + 1) * per * qc
        k_g, v_g, kp_g = k[:, :hi], v[:, :hi], kv_pos[:, :hi]
        for lo in range(g * per * qc, hi, qc):
            p_i = q_pos[:, lo:lo + qc]
            outs.append(_sdpa(q[:, lo:lo + qc], k_g, v_g,
                              causal_mask(p_i, kp_g, None), scale))
    return torch.cat(outs, dim=1)


def _scores(q, k, mask, scale):
    """`_sdpa`'s masked f32 scores (B, Hkv, G, S, T)."""
    b, s, h, hd = q.shape
    hkv = k.shape[2]
    q = q.reshape(b, s, hkv, h // hkv, hd)
    logits = torch.einsum("bskgd,btkd->bkgst", q, k).float() * scale
    if mask.dim() == 2:
        mask = mask[None]
    return logits.masked_fill(~mask[:, None, None, :, :], -1e30)


def _mix(w, v):
    """`_sdpa`'s weighted values: w (B, Hkv, G, S, T) -> (B, S, H, vd)."""
    b, hkv, g, s, _ = w.shape
    out = torch.einsum("bkgst,btkd->bskgd", w, v)
    return out.reshape(b, s, hkv * g, v.shape[-1])


def _sdpa(q, k, v, mask, scale):
    """Plain einsum + softmax attention.  q (B,S,H,hd), k (B,T,Hkv,hd),
    v (B,T,Hkv,vd) with H = G*Hkv; mask (B,S,T) or (S,T).  DTensors go
    through `sdpa_sharded`, which runs `_scores` and `_mix` shard by
    shard."""
    if dtensor_mesh(q) is not None:
        return sdpa_sharded(q, k, v, mask, scale, _scores, _mix)
    w = torch.softmax(_scores(q, k, mask, scale), dim=-1).to(v.dtype)
    return _mix(w, v)


def attn_forward(p: dict, x: torch.Tensor, positions: torch.Tensor,
                 cfg: AttnConfig, eps: float = 1e-5,
                 use_flash: bool = False):
    """Full causal self-attention (prefill).  Returns (y, {"k", "v"}).

    ``use_flash`` runs the attention through the flash-attention kernel
    (plain PyTorch on CPU tensors); off, through `_sdpa`, or, for a long
    prompt, `_sdpa_chunked`.  The prefill positions are ``0..S-1`` on
    every row, the kernel's contract.  MLA returns (y, {"c_kv",
    "k_rope"}) from `_mla_forward`, flash or not."""
    if cfg.mla is not None:
        return _mla_forward(p, x, positions, cfg, eps)
    b, s, _ = x.shape
    q = split_heads(x @ p["wq"], cfg.n_heads, cfg.head_dim)
    k = split_heads(x @ p["wk"], cfg.n_kv_heads, cfg.head_dim, True)
    v = split_heads(x @ p["wv"], cfg.n_kv_heads, cfg.head_dim, True)
    q, k = _qk_norm(p, q, k, cfg, eps)
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    q = rope(q, cos, sin)
    k = rope(k, cos, sin)
    if use_flash:
        out = flash_attention(q, k, v, scale=_scale(cfg), causal=True,
                              window=cfg.window)
    elif _long_prompt(s):
        out = _sdpa_chunked(q, k, v, positions, positions, cfg.window,
                            _scale(cfg))
    else:
        mask = causal_mask(positions, positions, cfg.window)
        out = _sdpa(q, k, v, mask, _scale(cfg))
    y = out.reshape(b, s, -1) @ p["wo"]
    return y, {"k": kv_heads(k, cfg.n_kv_heads),
               "v": kv_heads(v, cfg.n_kv_heads)}


# Paged attention implementation: the page-table gather + _sdpa (off,
# the default) or the CUDA kernels of repro_torch.kernels (on).  Read at
# call time.
_PAGED_KERNEL = contextvars.ContextVar("repro_torch_paged_kernel",
                                       default=False)


@contextlib.contextmanager
def paged_kernel(on: bool = True):
    """Send paged decode and prefill chunks through the kernels' wrappers
    (``on``) or through the page gather + `_sdpa` (off), the reference
    model's own non-kernel path.  The gather is kept apart from the
    kernels' plain versions on purpose: it computes the same contract a
    second, independent way, so it witnesses the kernels on the card."""
    tok = _PAGED_KERNEL.set(on)
    try:
        yield
    finally:
        _PAGED_KERNEL.reset(tok)


def _gqa_qkv_decode(p: dict, x: torch.Tensor, pos: torch.Tensor,
                    cfg: AttnConfig, eps: float):
    """The new token's q/k/v (+ qk-norm + rope).  x (B,1,D) -> q/k/v
    (B,1,H*,hd)."""
    q = split_heads(x @ p["wq"], cfg.n_heads, cfg.head_dim)
    k = split_heads(x @ p["wk"], cfg.n_kv_heads, cfg.head_dim, True)
    v = split_heads(x @ p["wv"], cfg.n_kv_heads, cfg.head_dim, True)
    q, k = _qk_norm(p, q, k, cfg, eps)
    cos, sin = rope_cos_sin(pos[:, None], cfg.head_dim, cfg.rope_theta)
    return (rope(q, cos, sin), kv_heads(rope(k, cos, sin), cfg.n_kv_heads),
            kv_heads(v, cfg.n_kv_heads))


def _gather_pages(cache: dict, table: torch.Tensor, dtype):
    """(k, v, pos) of every page in ``table`` (B, maxp), flattened to
    (B, maxp*ps, ...); an int8 pool's pages dequantized after the
    gather (never the whole pool)."""
    b, maxp = table.shape
    ps = cache["k"].shape[1]
    t = table.long()
    k = _read_kv(cache, "k", dtype, t).reshape(b, maxp * ps,
                                                *cache["k"].shape[2:])
    v = _read_kv(cache, "v", dtype, t).reshape(b, maxp * ps,
                                                *cache["v"].shape[2:])
    return k, v, cache["pos"][t].reshape(b, maxp * ps)


def _paged_kernel_takes(cache: dict) -> bool:
    """Whether this paged call goes through the kernels: the switch is
    on and the pool is bf16 (an int8 pool takes the gather, as in the
    JAX package: the kernels read bf16 pages)."""
    return _PAGED_KERNEL.get() and "k_s" not in cache


def _gqa_decode_paged(p, x, cache, pos, cfg: AttnConfig, eps,
                      paged: PagedKV, write_mask):
    """One-token GQA decode against the paged pool: write the new
    token's K/V into the lane's (page, slot) target, in place, then
    attend over the lane's pages."""
    q, k, v = _gqa_qkv_decode(p, x, pos, cfg, eps)
    wp = paged.write_page.long()
    pw = pos.to(torch.int32)
    if write_mask is not None:
        wp = torch.where(write_mask, wp, _GARBAGE_PAGE)
        pw = torch.where(write_mask, pw, -1)
    ws = paged.write_slot.long()
    _write_kv(cache, (wp, ws), k[:, 0], v[:, 0])
    cache["pos"].index_put_((wp, ws), pw)

    table = paged.page_table
    scale = _scale(cfg)
    if _paged_kernel_takes(cache):
        out = paged_attention(q[:, 0], cache["k"], cache["v"], cache["pos"],
                              table, pos.to(torch.int32), scale=scale,
                              window=cfg.window)[:, None]     # (B,1,H,hd)
    else:
        k_full, v_full, pos_full = _gather_pages(cache, table, q.dtype)
        mask = causal_mask(pos[:, None], pos_full, cfg.window)
        mask &= (pos_full >= 0)[:, None, :]
        out = _sdpa(q, k_full, v_full, mask, scale)
    return out.reshape(x.shape[0], 1, -1) @ p["wo"], cache


def attn_prefill_chunk(p: dict, x: torch.Tensor, cache: dict,
                       cfg: AttnConfig, eps: float, table: torch.Tensor,
                       chunk: PrefillChunk):
    """One prefill CHUNK against the paged pool: compute the chunk's
    q/k/v, write K/V into the per-token (page, slot) targets (in place),
    then attend over the lane's page-table history plus the chunk's own
    in-flight keys, causally.

    The in-flight keys are the ACTIVATION-dtype k/v (not the bf16 pool
    round-trip), and history reads are clipped to ``kpos <
    chunk.start`` so the chunk's own just-written positions are attended
    exactly once.  x (B, C, D); table (B, maxp) i32; returns
    (y (B, C, D), cache).  GQA only: MLA admits by whole-prompt prefill.
    """
    if cfg.mla is not None:
        raise NotImplementedError(
            "chunked prefill supports GQA attention only; MLA segments "
            "must admit through the whole-prompt prefill path")
    b, c, _ = x.shape
    rpos = torch.clamp(chunk.pos, min=0)       # rope of pad rows: masked
    q = split_heads(x @ p["wq"], cfg.n_heads, cfg.head_dim)
    k = split_heads(x @ p["wk"], cfg.n_kv_heads, cfg.head_dim, True)
    v = split_heads(x @ p["wv"], cfg.n_kv_heads, cfg.head_dim, True)
    q, k = _qk_norm(p, q, k, cfg, eps)
    cos, sin = rope_cos_sin(rpos, cfg.head_dim, cfg.rope_theta)
    q = rope(q, cos, sin)
    k = rope(k, cos, sin)

    # prefix-cache hits / pad rows / inactive lanes go to the garbage
    # sink with stored position -1
    live = chunk.active[:, None] & (chunk.pos >= 0) \
        & (chunk.dest_page != _GARBAGE_PAGE)
    dp = torch.where(live, chunk.dest_page, _GARBAGE_PAGE).long()
    pw = torch.where(live, chunk.pos, -1).to(torch.int32)
    ds = chunk.dest_slot.long()
    _write_kv(cache, (dp, ds), k, v)
    cache["pos"].index_put_((dp, ds), pw)

    scale = _scale(cfg)
    if _paged_kernel_takes(cache):
        out = paged_prefill(q, cache["k"], cache["v"], cache["pos"], table,
                            chunk.pos, chunk.start, k, v, chunk.pos,
                            scale=scale, window=cfg.window)
    else:
        k_hist, v_hist, pos_hist = _gather_pages(cache, table, q.dtype)
        hist_ok = (pos_hist >= 0) & (pos_hist < chunk.start[:, None])
        k_all = torch.cat([k_hist, k], dim=1)
        v_all = torch.cat([v_hist, v], dim=1)
        pos_all = torch.cat([pos_hist, chunk.pos], dim=1)
        ok_all = torch.cat([hist_ok, chunk.pos >= 0], dim=1)
        mask = causal_mask(chunk.pos, pos_all, cfg.window) \
            & ok_all[:, None, :]
        out = _sdpa(q, k_all, v_all, mask, scale)
    return out.reshape(b, c, -1) @ p["wo"], cache


def attn_decode(p: dict, x: torch.Tensor, cache: dict, pos: torch.Tensor,
                cfg: AttnConfig, eps: float = 1e-5,
                paged: PagedKV | None = None, write_mask=None):
    """One-token decode against the ring cache, or — when a `PagedKV`
    handle is given — against the paged KV pool.  Either is updated in
    place.

    Args:
      x: (B, 1, D) current token activations.
      cache: ring {"k","v": (B,C,Hkv,hd), "pos": (B,C)} or paged pool
        {"k","v": (P,page,Hkv,hd), "pos": (P,page)}.
      pos: (B,) absolute position of the new token.
      paged: page table + this token's write target (paged mode only).
      write_mask: (B,) lanes whose write should land (paged mode; masked
        lanes are redirected to the garbage page — ring callers mask via
        the engine's `_mask_lane_writes` instead).

    Returns (y, cache).  MLA takes `_mla_decode` on either cache.
    """
    if cfg.mla is not None:
        return _mla_decode(p, x, cache, pos, cfg, eps, paged, write_mask)
    if paged is not None:
        return _gqa_decode_paged(p, x, cache, pos, cfg, eps, paged,
                                 write_mask)
    b = x.shape[0]
    c = cache["k"].shape[1]
    q, k, v = _gqa_qkv_decode(p, x, pos, cfg, eps)
    slot = (pos % c).long()                                  # ring write
    _write_kv(cache, slot, k[:, 0], v[:, 0])
    _put(cache["pos"], slot, pos.to(torch.int32))
    new_pos = cache["pos"]
    mask = causal_mask(pos[:, None], new_pos, cfg.window)   # (B,1,C)
    mask &= (new_pos >= 0)[:, None, :]
    out = _sdpa(q, _read_kv(cache, "k", q.dtype), _read_kv(cache, "v",
                                                           q.dtype),
                mask, _scale(cfg))
    return out.reshape(b, 1, -1) @ p["wo"], cache


# --------------------------------------------------------------------------
# MLA (DeepSeek-V2)
# --------------------------------------------------------------------------

def _mla_scale(cfg: AttnConfig) -> float:
    m = cfg.mla
    return cfg.softmax_scale or 1.0 / math.sqrt(m.qk_nope_head_dim
                                                + m.qk_rope_head_dim)


def _mla_q(p, x, cfg: AttnConfig, eps):
    """(q_nope, q_rope) of x (..., D), each (..., H, *)."""
    m = cfg.mla
    if m.q_lora_rank:
        q = rms_norm({"scale": p["q_norm"]}, x @ p["w_dq"], eps) @ p["wq"]
    else:
        q = x @ p["wq"]
    q = q.reshape(*x.shape[:-1], cfg.n_heads,
                  m.qk_nope_head_dim + m.qk_rope_head_dim)
    return q[..., :m.qk_nope_head_dim], q[..., m.qk_nope_head_dim:]


def _mla_latent(p, x, positions, cfg: AttnConfig, eps):
    """The new tokens' normed latent ``c_kv`` (..., lora) and roped shared
    key ``k_rope`` (..., rope), with the cos/sin of ``positions``."""
    m = cfg.mla
    dkv = x @ p["w_dkv"]
    c_kv = rms_norm({"scale": p["kv_norm"]}, dkv[..., :m.kv_lora_rank], eps)
    cos, sin = rope_cos_sin(positions, m.qk_rope_head_dim, cfg.rope_theta)
    k_rope = rope(dkv[..., m.kv_lora_rank:][..., None, :], cos, sin)
    return c_kv, k_rope[..., 0, :], cos, sin


def _mla_forward(p, x, positions, cfg: AttnConfig, eps):
    """Full causal MLA (prefill): keys and values expanded from the
    latent per head.  Returns (y, {"c_kv", "k_rope"})."""
    m = cfg.mla
    b, s, _ = x.shape
    h = cfg.n_heads
    q_nope, q_rope = _mla_q(p, x, cfg, eps)
    c_kv, k_rope, cos, sin = _mla_latent(p, x, positions, cfg, eps)
    q_rope = rope(q_rope, cos, sin)
    k_nope = (c_kv @ p["w_uk"]).reshape(b, s, h, m.qk_nope_head_dim)
    v = (c_kv @ p["w_uv"]).reshape(b, s, h, m.v_head_dim)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        b, s, h, m.qk_rope_head_dim)], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    if _long_prompt(s):
        out = _sdpa_chunked(q, k, v, positions, positions, cfg.window,
                            _mla_scale(cfg))
    else:
        mask = causal_mask(positions, positions, cfg.window)
        out = _sdpa(q, k, v, mask, _mla_scale(cfg))
    return out.reshape(b, s, -1) @ p["wo"], {"c_kv": c_kv, "k_rope": k_rope}


def _mla_decode(p, x, cache, pos, cfg: AttnConfig, eps,
                paged: PagedKV | None = None, write_mask=None):
    """Absorbed-matmul MLA decode: attention runs in the compressed
    kv_lora space, so the cache stays (B, C, lora + rope) on the ring or
    (P, page, lora + rope) in the pool.  The new token's latent is
    written in place first (on the pool, masked lanes go to the garbage
    page at position -1); the paged pool is then read back per lane
    through the page-table gather.  An int8 latent is quantized as it
    is written and dequantized to bf16 as it is read (after the gather,
    on the pool)."""
    m = cfg.mla
    b = x.shape[0]
    h = cfg.n_heads
    q_nope, q_rope = _mla_q(p, x, cfg, eps)                  # (B,1,H,*)
    c_new, k_rope_new, cos, sin = _mla_latent(p, x, pos[:, None], cfg, eps)
    q_rope = rope(q_rope, cos, sin)

    if paged is not None:
        wa = paged.write_page.long()
        pw = pos.to(torch.int32)
        if write_mask is not None:
            wa = torch.where(write_mask, wa, _GARBAGE_PAGE)
            pw = torch.where(write_mask, pw, -1)
        idx = (wa, paged.write_slot.long())
    else:
        idx = (pos % cache["c_kv"].shape[1]).long()         # ring write
        pw = pos.to(torch.int32)
    for name, new in (("c_kv", c_new[:, 0]), ("k_rope", k_rope_new[:, 0])):
        if name + "_s" in cache:
            nq, ns = quantize_rows(new)
            _put(cache[name], idx, nq)
            _put(cache[name + "_s"], idx, ns)
        else:
            _put(cache[name], idx, new.to(cache[name].dtype))
    _put(cache["pos"], idx, pw)
    # int8 leaves read back as bf16 (dequantize_rows' default), as the
    # JAX package reads them; bf16 leaves as they are
    dt = torch.bfloat16 if "c_kv_s" in cache else cache["c_kv"].dtype
    if paged is not None:
        t = paged.page_table.long()
        c = t.shape[1] * cache["c_kv"].shape[1]
        ckv = _read_kv(cache, "c_kv", dt, t).reshape(b, c, -1)
        krope = _read_kv(cache, "k_rope", dt, t).reshape(b, c, -1)
        kpos = cache["pos"][t].reshape(b, c)
    else:
        ckv = _read_kv(cache, "c_kv", dt)
        krope = _read_kv(cache, "k_rope", dt)
        kpos = cache["pos"]

    # absorb W_uk into q: q_c[b,h,r] = sum_n q_nope[b,h,n] W_uk[r, h, n]
    w_uk = p["w_uk"].reshape(m.kv_lora_rank, h, m.qk_nope_head_dim)
    q_c = torch.einsum("bhn,rhn->bhr", q_nope[:, 0], w_uk)
    scores = torch.einsum("bhr,btr->bht", q_c, ckv.to(q_c.dtype))
    scores = scores + torch.einsum("bhe,bte->bht", q_rope[:, 0],
                                   krope.to(q_rope.dtype))
    mask = causal_mask(pos[:, None], kpos, cfg.window)[:, 0]  # (B, C)
    mask &= kpos >= 0
    logits = (scores.float() * _mla_scale(cfg)).masked_fill(
        ~mask[:, None, :], -1e30)
    w = torch.softmax(logits, dim=-1).to(x.dtype)
    ctx_c = torch.einsum("bht,btr->bhr", w, ckv.to(w.dtype))  # (B,H,lora)
    w_uv = p["w_uv"].reshape(m.kv_lora_rank, h, m.v_head_dim)
    out = torch.einsum("bhr,rhv->bhv", ctx_c, w_uv)
    return out.reshape(b, 1, h * m.v_head_dim) @ p["wo"], cache
