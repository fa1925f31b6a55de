"""phi3.5-moe-42b-a6.6b [moe] — 32L d_model=4096, 32H GQA kv=8,
16 experts top-2 with d_ff_expert=6400, vocab=32064.
[hf:microsoft/Phi-3.5-MoE-instruct]"""

from repro_torch.models.config import (AttnConfig, BlockConfig, ModelConfig,
                                       MoEConfig, Segment)

ARCH_ID = "phi3.5-moe-42b-a6.6b"


def full_config() -> ModelConfig:
    attn = AttnConfig(n_heads=32, n_kv_heads=8, head_dim=128)
    moe = MoEConfig(num_experts=16, top_k=2, d_ff_expert=6400)
    block = BlockConfig(mixer="attn", attn=attn, mlp="moe", moe=moe)
    sizes = [4, 4, 4, 4, 4, 4, 4, 4]
    segments = tuple(
        Segment(block=block, n_layers=s, ramp=(i < len(sizes) - 1))
        for i, s in enumerate(sizes))
    return ModelConfig(name=ARCH_ID, d_model=4096, vocab=32_064,
                       segments=segments, tie_embeddings=False)


def smoke_config() -> ModelConfig:
    attn = AttnConfig(n_heads=4, n_kv_heads=2, head_dim=32)
    # cf=4 -> drop-free at smoke scale (decode/prefill parity tests)
    moe = MoEConfig(num_experts=4, top_k=2, d_ff_expert=128,
                    capacity_factor=4.0)
    block = BlockConfig(mixer="attn", attn=attn, mlp="moe", moe=moe)
    segments = (Segment(block=block, n_layers=1, ramp=True),
                Segment(block=block, n_layers=1, ramp=False))
    return ModelConfig(name=ARCH_ID + "-smoke", d_model=128, vocab=512,
                       segments=segments, tie_embeddings=False)
