"""Pre-norm residual blocks: an attention mixer (GQA or MLA) with a
dense or MoE MLP, an SSD (Mamba2) mixer with no MLP, or Hymba's hybrid
mixer (attention and SSD heads side by side on the same normed input,
each branch RMS-normed, the two averaged) with a dense MLP; plus
ring-cache construction after a whole-prompt prefill."""

from __future__ import annotations

import torch

from repro_torch.models import attention, mlp as mlp_lib, moe as moe_lib, \
    ssm as ssm_lib
from repro_torch.models.common import rms_norm, rms_norm_def
from repro_torch.models.config import BlockConfig
from repro_torch.models.quant import int8_enabled, quantize_rows
from repro_torch.sharding.ctx import reduce_partial, scatter_rows_

__all__ = ["block_defs", "block_forward", "block_decode",
           "block_prefill_chunk", "cache_defs", "build_ring_cache"]


def block_defs(cfg: BlockConfig, d_model: int) -> dict:
    defs: dict = {"norm1": rms_norm_def(d_model)}
    if cfg.mixer in ("attn", "hybrid"):
        defs["attn"] = attention.attn_defs(cfg.attn, d_model)
    if cfg.mixer in ("ssm", "hybrid"):
        defs["ssm"] = ssm_lib.ssm_defs(cfg.ssm, d_model)
    if cfg.mixer == "hybrid":
        # Hymba: an output norm a branch, the two averaged
        defs["attn_out_norm"] = rms_norm_def(d_model)
        defs["ssm_out_norm"] = rms_norm_def(d_model)
    if cfg.mlp == "dense":
        defs["norm2"] = rms_norm_def(d_model)
        defs["mlp"] = mlp_lib.mlp_defs(d_model, cfg.d_ff, cfg.act)
    elif cfg.mlp == "moe":
        defs["norm2"] = rms_norm_def(d_model)
        defs["moe"] = moe_lib.moe_defs(cfg.moe, d_model, cfg.act)
    return defs


def cache_defs(cfg: BlockConfig, d_model: int, batch: int,
               cache_len: int) -> dict:
    """(shape, dtype) spec tree for one block's decode cache: the KV
    cache of an attention block, the conv/SSM state of an SSM block,
    both for a hybrid block."""
    out: dict = {}
    if cfg.mixer in ("attn", "hybrid"):
        out["attn"] = attention.init_cache_defs(cfg.attn, batch, cache_len)
    if cfg.mixer in ("ssm", "hybrid"):
        out["ssm"] = ssm_lib.ssm_state_defs(cfg.ssm, d_model, batch)
    return out


def _fuse(p, ya, ys, eps):
    """The hybrid mixer's output: each branch RMS-normed, then averaged."""
    return 0.5 * (rms_norm(p["attn_out_norm"], ya, eps)
                  + rms_norm(p["ssm_out_norm"], ys, eps))


def _mlp(p, x, cfg: BlockConfig, eps, with_aux=False):
    """x plus the block's MLP (dense, MoE or none) of the normed x, and
    the MoE aux losses (empty unless ``with_aux`` and an MoE MLP)."""
    if cfg.mlp == "none":
        return x, {}
    xn = rms_norm(p["norm2"], x, eps)
    if cfg.mlp == "moe":
        y, aux = moe_lib.moe_forward(p["moe"], xn, cfg.moe, cfg.act,
                                     with_aux)
        return x + reduce_partial(y), aux
    return x + reduce_partial(mlp_lib.mlp_forward(p["mlp"], xn,
                                                  cfg.act)), {}


def block_forward(p: dict, x: torch.Tensor, positions: torch.Tensor,
                  cfg: BlockConfig, eps: float = 1e-5,
                  use_flash: bool = False, use_ssd_kernel: bool = False):
    """Full-sequence pass (prefill, training).  Returns (y, cache_entry,
    aux) with cache_entry ``{"attn_kv": {"k", "v"}}`` (MLA: ``{"c_kv",
    "k_rope"}``), ``{"ssm": {"conv", "ssm"}}`` or, hybrid, both, and aux
    the MoE aux losses (empty for a dense block); ``use_flash`` runs GQA
    attention through the flash-attention kernel, ``use_ssd_kernel``
    the SSD chunks through the ssd-chunk kernel."""
    xn = rms_norm(p["norm1"], x, eps)
    entry = {}
    if cfg.mixer in ("attn", "hybrid"):
        ya, entry["attn_kv"] = attention.attn_forward(
            p["attn"], xn, positions, cfg.attn, eps, use_flash)
        ya = reduce_partial(ya)
    if cfg.mixer in ("ssm", "hybrid"):
        ys, entry["ssm"] = ssm_lib.ssm_forward(p["ssm"], xn, cfg.ssm, eps,
                                               use_ssd_kernel)
        ys = reduce_partial(ys)
    mix = (_fuse(p, ya, ys, eps) if cfg.mixer == "hybrid"
           else ya if cfg.mixer == "attn" else ys)
    x, aux = _mlp(p, x + mix, cfg, eps, with_aux=True)
    return x, entry, aux


def block_decode(p: dict, x: torch.Tensor, cache: dict, pos: torch.Tensor,
                 cfg: BlockConfig, eps: float = 1e-5, paged=None,
                 write_mask=None):
    """One-token step, the cache updated in place.  x (B,1,D); returns
    (y, cache).

    Attention: against the ring cache or, with ``paged``, the paged pool
    (``write_mask`` redirects masked lanes' writes to the garbage page;
    on the ring the engine puts inactive lanes' slots back).  SSM: the
    new conv/SSM state is written into the lane-indexed state; with
    ``write_mask`` only the masked-in lanes' rows change, the others
    keep their bits (``torch.where`` into the cache).  Hybrid: both, on
    the same normed input."""
    xn = rms_norm(p["norm1"], x, eps)
    if cfg.mixer in ("attn", "hybrid"):
        ya, cache["attn"] = attention.attn_decode(
            p["attn"], xn, cache["attn"], pos, cfg.attn, eps, paged=paged,
            write_mask=write_mask)
        ya = reduce_partial(ya)
    if cfg.mixer in ("ssm", "hybrid"):
        state = cache["ssm"]
        ys, new = ssm_lib.ssm_decode(p["ssm"], xn, state, cfg.ssm, eps)
        ys = reduce_partial(ys)
        for name, leaf in state.items():
            upd = new[name].to(leaf.dtype)
            if write_mask is not None:
                keep = write_mask.reshape((-1,) + (1,) * (leaf.dim() - 1))
                upd = torch.where(keep, upd, leaf)
            leaf.copy_(upd)
    mix = (_fuse(p, ya, ys, eps) if cfg.mixer == "hybrid"
           else ya if cfg.mixer == "attn" else ys)
    return _mlp(p, x + mix, cfg, eps)[0], cache


def block_prefill_chunk(p: dict, x: torch.Tensor, cache: dict,
                        cfg: BlockConfig, eps: float, table: torch.Tensor,
                        chunk) -> tuple[torch.Tensor, dict]:
    """One prefill CHUNK through a block against the paged pool
    (updated in place).  x (B, C, D); returns (y, cache).  Only
    attention mixers are chunkable: SSM state is sequential over the
    whole prompt, so SSM models admit by whole-prompt prefill."""
    if cfg.mixer != "attn":
        raise NotImplementedError(
            f"chunked prefill supports attention blocks only, not "
            f"{cfg.mixer!r}")
    mix, cache["attn"] = attention.attn_prefill_chunk(
        p["attn"], rms_norm(p["norm1"], x, eps), cache["attn"], cfg.attn,
        eps, table, chunk)
    return _mlp(p, x + reduce_partial(mix), cfg, eps)[0], cache


def build_ring_cache(cache_entry: dict, positions: torch.Tensor,
                     cache_len: int) -> dict:
    """Convert prefill outputs into the fixed-size decode cache.

    Attention: takes the last ``cache_len`` positions and scatters them
    at slot ``pos % cache_len`` — for full prefixes this is the identity
    layout, for windowed attention (a prompt longer than the ring) it
    reproduces the steady-state ring.  K/V are stored in bf16, empty
    slots at position -1; under `cache_int8` the bf16 rows are then
    quantized, their scales beside them (``k_s``, ``v_s``; MLA
    ``c_kv_s``, ``k_rope_s``).  SSM state passes through."""
    out: dict = {}
    if "attn_kv" in cache_entry:
        kv = cache_entry["attn_kv"]
        pos_tail = positions[:, -cache_len:]
        slots = (pos_tail % cache_len).long()                # (B, C')
        b = pos_tail.shape[0]

        def scatter(src):
            # buf[b, slots[b, i]] = tail[b, i]
            tail = reduce_partial(src[:, -cache_len:]).to(torch.bfloat16)
            buf = tail.new_zeros((b, cache_len) + tail.shape[2:])
            return scatter_rows_(buf, slots, tail)

        entry = {name: scatter(t) for name, t in kv.items()}
        if int8_enabled():
            for name in list(entry):
                entry[name], entry[name + "_s"] = quantize_rows(entry[name])
        entry["pos"] = scatter_rows_(
            positions.new_full((b, cache_len), -1, dtype=torch.int32),
            slots, pos_tail.to(torch.int32))
        out["attn"] = entry
    if "ssm" in cache_entry:
        out["ssm"] = cache_entry["ssm"]
    return out
