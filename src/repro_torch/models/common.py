"""Shared low-level layers: RMSNorm, RoPE, embeddings, masks."""

from __future__ import annotations

import torch

from repro_torch.models.param import ParamDef

__all__ = ["rms_norm", "rms_norm_def", "rope", "rope_cos_sin",
           "causal_mask", "embed_def"]


def rms_norm_def(dim: int, axis: str = "embed") -> dict:
    return {"scale": ParamDef((dim,), (axis,), init="ones")}


def rms_norm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(dt)


def embed_def(vocab: int, d_model: int) -> dict:
    return {"table": ParamDef((vocab, d_model), ("vocab", "embed"),
                              init="embed", scale=0.02)}


def rope_cos_sin(positions: torch.Tensor, head_dim: int,
                 theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """positions (...,) -> cos/sin of shape (..., head_dim//2)."""
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32,
                        device=positions.device) / half
    # theta made on the device by a fill: a tensor built from a host
    # value would be a blocking host-to-device copy on every call
    freqs = 1.0 / torch.pow(torch.full((), theta, dtype=torch.float32,
                                       device=positions.device), exps)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def rope(x: torch.Tensor, cos: torch.Tensor,
         sin: torch.Tensor) -> torch.Tensor:
    """Rotary embedding in the half-split layout (not interleaved).
    x: (..., seq, heads, head_dim); cos/sin: (..., seq, head_dim//2),
    broadcast over the heads axis."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :]
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c],
                     dim=-1).to(x.dtype)


def causal_mask(q_pos: torch.Tensor, kv_pos: torch.Tensor,
                window: int | None = None) -> torch.Tensor:
    """Boolean (..., q, kv) mask: True = attend.

    q_pos (..., q), kv_pos (..., kv) are absolute positions; a sliding
    window additionally requires kv_pos > q_pos - window.
    """
    m = kv_pos[..., None, :] <= q_pos[..., :, None]
    if window is not None:
        m &= kv_pos[..., None, :] > (q_pos[..., :, None] - window)
    return m
