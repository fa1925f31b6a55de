"""Pre-norm residual blocks: an attention mixer with a dense MLP, plus
ring-cache construction after a whole-prompt prefill."""

from __future__ import annotations

import torch

from repro_torch.models import attention, mlp as mlp_lib
from repro_torch.models.common import rms_norm, rms_norm_def
from repro_torch.models.config import BlockConfig

__all__ = ["block_defs", "block_forward", "block_decode",
           "block_prefill_chunk", "cache_defs", "build_ring_cache"]


def _check(cfg: BlockConfig) -> None:
    if cfg.mixer != "attn" or cfg.mlp != "dense":
        raise NotImplementedError(
            f"the port has attention blocks with a dense MLP only, not "
            f"mixer {cfg.mixer!r} / mlp {cfg.mlp!r}")


def block_defs(cfg: BlockConfig, d_model: int) -> dict:
    _check(cfg)
    return {"norm1": rms_norm_def(d_model),
            "attn": attention.attn_defs(cfg.attn, d_model),
            "norm2": rms_norm_def(d_model),
            "mlp": mlp_lib.mlp_defs(d_model, cfg.d_ff, cfg.act)}


def cache_defs(cfg: BlockConfig, d_model: int, batch: int,
               cache_len: int) -> dict:
    """(shape, dtype) spec tree for one block's KV cache."""
    _check(cfg)
    return {"attn": attention.init_cache_defs(cfg.attn, batch, cache_len)}


def _mlp(p, x, cfg: BlockConfig, eps):
    return x + mlp_lib.mlp_forward(p["mlp"], rms_norm(p["norm2"], x, eps),
                                   cfg.act)


def block_forward(p: dict, x: torch.Tensor, positions: torch.Tensor,
                  cfg: BlockConfig, eps: float = 1e-5,
                  use_flash: bool = False):
    """Full-sequence pass (prefill).  Returns (y, cache_entry) with
    cache_entry ``{"attn_kv": {"k", "v"}}``; ``use_flash`` runs the
    attention through the flash-attention kernel."""
    mix, kv = attention.attn_forward(p["attn"], rms_norm(p["norm1"], x, eps),
                                     positions, cfg.attn, eps, use_flash)
    return _mlp(p, x + mix, cfg, eps), {"attn_kv": kv}


def block_decode(p: dict, x: torch.Tensor, cache: dict, pos: torch.Tensor,
                 cfg: BlockConfig, eps: float = 1e-5, paged=None,
                 write_mask=None):
    """One-token step against the ring cache or, with ``paged``, the
    paged pool (either updated in place).  x (B,1,D); returns (y,
    cache)."""
    mix, cache["attn"] = attention.attn_decode(
        p["attn"], rms_norm(p["norm1"], x, eps), cache["attn"], pos,
        cfg.attn, eps, paged=paged, write_mask=write_mask)
    return _mlp(p, x + mix, cfg, eps), cache


def block_prefill_chunk(p: dict, x: torch.Tensor, cache: dict,
                        cfg: BlockConfig, eps: float, table: torch.Tensor,
                        chunk) -> tuple[torch.Tensor, dict]:
    """One prefill CHUNK through a block against the paged pool
    (updated in place).  x (B, C, D); returns (y, cache)."""
    mix, cache["attn"] = attention.attn_prefill_chunk(
        p["attn"], rms_norm(p["norm1"], x, eps), cache["attn"], cfg.attn,
        eps, table, chunk)
    return _mlp(p, x + mix, cfg, eps), cache


def build_ring_cache(cache_entry: dict, positions: torch.Tensor,
                     cache_len: int) -> dict:
    """Convert prefill outputs into the fixed-size ring decode cache.

    Takes the last ``cache_len`` positions and scatters them at slot
    ``pos % cache_len`` — for full prefixes this is the identity layout,
    for windowed attention (a prompt longer than the ring) it reproduces
    the steady-state ring.  K/V are stored in bf16, empty slots at
    position -1."""
    kv = cache_entry["attn_kv"]
    pos_tail = positions[:, -cache_len:]
    slots = (pos_tail % cache_len).long()                    # (B, C')
    b = pos_tail.shape[0]
    bidx = torch.arange(b, device=positions.device)[:, None]

    def scatter(src):
        tail = src[:, -cache_len:]
        buf = torch.zeros((b, cache_len) + tail.shape[2:],
                          dtype=torch.bfloat16, device=src.device)
        buf[bidx, slots] = tail.to(torch.bfloat16)
        return buf

    entry = {name: scatter(t) for name, t in kv.items()}
    pos_buf = torch.full((b, cache_len), -1, dtype=torch.int32,
                         device=positions.device)
    pos_buf[bidx, slots] = pos_tail.to(torch.int32)
    entry["pos"] = pos_buf
    return {"attn": entry}
