"""Model configuration dataclasses covering every assigned architecture
family (dense GQA, MLA+MoE, GShard-style MoE, Mamba2 SSD, Hymba hybrid,
audio/VLM backbones) plus early-exit ramp placement.

A model is a sequence of ``Segment``s.  Each segment is a scanned stack of
identical blocks optionally followed by an early-exit ramp — segment
boundaries ARE the T-Tamer nodes (DESIGN.md §2), so the serving engine can
execute segment-by-segment and consult the if-stop table between segments.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

__all__ = ["MLAConfig", "AttnConfig", "SSMConfig", "MoEConfig",
           "BlockConfig", "Segment", "ModelConfig"]


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2)."""
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    q_lora_rank: int | None = None   # V2-Lite projects q directly


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    n_heads: int
    n_kv_heads: int
    head_dim: int
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    window: int | None = None        # sliding-window size (None = full)
    mla: MLAConfig | None = None
    softmax_scale: float | None = None

    @property
    def q_dim(self) -> int:
        if self.mla:
            return self.n_heads * (self.mla.qk_nope_head_dim
                                   + self.mla.qk_rope_head_dim)
        return self.n_heads * self.head_dim


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD) mixer."""
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 256

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared: int = 0
    d_ff_shared: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    router_z_weight: float = 1e-3


@dataclasses.dataclass(frozen=True)
class BlockConfig:
    """One transformer/SSM/hybrid block."""
    mixer: Literal["attn", "ssm", "hybrid"]
    attn: AttnConfig | None = None
    ssm: SSMConfig | None = None
    mlp: Literal["dense", "moe", "none"] = "dense"
    d_ff: int = 0                    # dense MLP hidden size
    moe: MoEConfig | None = None
    act: Literal["swiglu", "gelu"] = "swiglu"


@dataclasses.dataclass(frozen=True)
class Segment:
    """A scanned stack of `n_layers` identical blocks; if `ramp`, an
    early-exit ramp head is attached after the stack (a T-Tamer node)."""
    block: BlockConfig
    n_layers: int
    ramp: bool = True


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    d_model: int
    vocab: int
    segments: tuple[Segment, ...]
    norm_eps: float = 1e-5
    tie_embeddings: bool = True
    input_mode: Literal["tokens", "embeds", "multimodal"] = "tokens"
    image_tokens: int = 0            # VLM: #patch embeddings per sample
    max_seq: int = 32_768
    # Long-context variant: when set, overrides every attention window for
    # the `long_500k` shape (DESIGN.md §4 sliding-window carve-out).
    long_context_window: int | None = 8_192

    @property
    def n_layers(self) -> int:
        return sum(s.n_layers for s in self.segments)

    @property
    def n_ramps(self) -> int:
        """Number of T-Tamer nodes (final head counts as the last node)."""
        return sum(1 for s in self.segments if s.ramp)

    @property
    def is_subquadratic(self) -> bool:
        """True if every mixer is O(seq) at decode: SSM or windowed attn."""
        for s in self.segments:
            b = s.block
            if b.mixer == "attn" and b.attn.window is None:
                return False
            if b.mixer == "hybrid" and b.attn.window is None:
                return False
        return True

    def with_window(self, window: int) -> "ModelConfig":
        """Sliding-window override used for the long_500k decode shape."""
        segs = []
        for s in self.segments:
            b = s.block
            if b.mixer in ("attn", "hybrid") and b.attn is not None:
                w = min(window, b.attn.window) if b.attn.window else window
                b = dataclasses.replace(b, attn=dataclasses.replace(
                    b.attn, window=w))
            segs.append(dataclasses.replace(s, block=b))
        return dataclasses.replace(self, segments=tuple(segs),
                                   name=self.name + f"-sw{window}")
