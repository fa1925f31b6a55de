"""Helpers shared by the architecture configs."""

from __future__ import annotations

from repro_torch.models.config import (AttnConfig, BlockConfig, ModelConfig,
                                 Segment)

__all__ = ["dense_decoder", "split_segments"]


def split_segments(n_layers: int, n_segments: int) -> list[int]:
    """Split n_layers into n_segments near-equal scanned stacks."""
    base, rem = divmod(n_layers, n_segments)
    return [base + (1 if i >= n_segments - rem else 0)
            for i in range(n_segments)]


def dense_decoder(name: str, *, n_layers: int, d_model: int, n_heads: int,
                  n_kv_heads: int, head_dim: int, d_ff: int, vocab: int,
                  n_segments: int = 6, qk_norm: bool = False,
                  window: int | None = None, act: str = "swiglu",
                  rope_theta: float = 10_000.0, tie: bool = True,
                  input_mode: str = "tokens", image_tokens: int = 0,
                  ) -> ModelConfig:
    """Standard dense GQA decoder with EE ramps at segment boundaries."""
    attn = AttnConfig(n_heads=n_heads, n_kv_heads=n_kv_heads,
                      head_dim=head_dim, qk_norm=qk_norm, window=window,
                      rope_theta=rope_theta)
    block = BlockConfig(mixer="attn", attn=attn, mlp="dense", d_ff=d_ff,
                        act=act)
    sizes = split_segments(n_layers, n_segments)
    segments = tuple(
        Segment(block=block, n_layers=s, ramp=(i < len(sizes) - 1))
        for i, s in enumerate(sizes))
    return ModelConfig(name=name, d_model=d_model, vocab=vocab,
                       segments=segments, tie_embeddings=tie,
                       input_mode=input_mode, image_tokens=image_tokens)
