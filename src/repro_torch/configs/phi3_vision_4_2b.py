"""phi-3-vision-4.2b [vlm] — 32L d_model=3072, 32H (kv=32), d_ff=8192,
vocab=32064; phi3-mini backbone + CLIP vision.
[hf:microsoft/Phi-3-vision-128k-instruct]

Frontend carve-out (DESIGN.md §4): the CLIP/SigLIP vision encoder and
projector are not modelled — the decoder takes pre-projected patch
embeddings (B, image_tokens, d_model) as ``batch["image_embeds"]``,
concatenated before the text tokens.
"""

from repro_torch.configs.common import dense_decoder
from repro_torch.models.config import ModelConfig

ARCH_ID = "phi-3-vision-4.2b"


def full_config() -> ModelConfig:
    return dense_decoder(
        ARCH_ID, n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32,
        head_dim=96, d_ff=8192, vocab=32_064, n_segments=8, tie=False,
        input_mode="multimodal", image_tokens=256)


def smoke_config() -> ModelConfig:
    return dense_decoder(
        ARCH_ID + "-smoke", n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
        head_dim=32, d_ff=256, vocab=512, n_segments=2, tie=False,
        input_mode="multimodal", image_tokens=8)
