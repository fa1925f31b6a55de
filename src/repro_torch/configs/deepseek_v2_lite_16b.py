"""deepseek-v2-lite-16b [moe] — 27L d_model=2048, 16H MLA (kv_lora=512),
2 shared + 64 routed experts top-6, vocab=102400.  [arXiv:2405.04434]

Following the DeepSeek-V2-Lite spec the pool entry names: first layer is a
dense MLP (d_ff=10944); remaining 26 layers are MoE with 64 routed top-6 +
2 shared experts of d_ff_expert=1408 ("160 routed" in the pool line is
full-V2; the Lite model card says 64 — see DESIGN.md §4).
"""

from __future__ import annotations

from repro_torch.models.config import (AttnConfig, BlockConfig, MLAConfig,
                                       ModelConfig, MoEConfig, Segment)

ARCH_ID = "deepseek-v2-lite-16b"


def _attn(nope=128, rope=64, v=128, lora=512, heads=16):
    return AttnConfig(
        n_heads=heads, n_kv_heads=heads, head_dim=nope + rope,
        mla=MLAConfig(kv_lora_rank=lora, qk_nope_head_dim=nope,
                      qk_rope_head_dim=rope, v_head_dim=v))


def full_config() -> ModelConfig:
    attn = _attn()
    dense0 = BlockConfig(mixer="attn", attn=attn, mlp="dense", d_ff=10944)
    moe = MoEConfig(num_experts=64, top_k=6, d_ff_expert=1408,
                    num_shared=2, d_ff_shared=2816)
    moe_block = BlockConfig(mixer="attn", attn=attn, mlp="moe", moe=moe)
    # 1 dense layer + 26 MoE layers; ramps every ~5 MoE layers -> 6 nodes.
    moe_sizes = [5, 5, 5, 5, 6]
    segments = [Segment(block=dense0, n_layers=1, ramp=False)]
    segments += [Segment(block=moe_block, n_layers=s,
                         ramp=(i < len(moe_sizes) - 1))
                 for i, s in enumerate(moe_sizes)]
    return ModelConfig(name=ARCH_ID, d_model=2048, vocab=102_400,
                       segments=tuple(segments), tie_embeddings=False)


def smoke_config() -> ModelConfig:
    attn = _attn(nope=32, rope=16, v=32, lora=64, heads=4)
    # cf=4 -> provably drop-free at smoke scale (decode/prefill parity
    # tests need determinism; the full config keeps the production 1.25)
    moe = MoEConfig(num_experts=4, top_k=2, d_ff_expert=128,
                    num_shared=1, d_ff_shared=128, capacity_factor=4.0)
    block = BlockConfig(mixer="attn", attn=attn, mlp="moe", moe=moe)
    segments = (Segment(block=block, n_layers=1, ramp=True),
                Segment(block=block, n_layers=1, ramp=False))
    return ModelConfig(name=ARCH_ID + "-smoke", d_model=128, vocab=512,
                       segments=segments, tie_embeddings=False)
