"""musicgen-large [audio] — 48L d_model=2048, 32H (kv=32), d_ff=8192,
vocab=2048 (EnCodec codebook), decoder-only over audio tokens.
[arXiv:2306.05284]

Frontend carve-out (DESIGN.md §4): the EnCodec/mel conv stack is not
modelled — the decoder takes precomputed frame embeddings (B, S,
d_model) as ``batch["embeds"]``.
"""

from repro_torch.configs.common import dense_decoder
from repro_torch.models.config import ModelConfig

ARCH_ID = "musicgen-large"


def full_config() -> ModelConfig:
    return dense_decoder(
        ARCH_ID, n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32,
        head_dim=64, d_ff=8192, vocab=2048, n_segments=6, act="gelu",
        tie=True, input_mode="embeds")


def smoke_config() -> ModelConfig:
    return dense_decoder(
        ARCH_ID + "-smoke", n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
        head_dim=32, d_ff=256, vocab=256, n_segments=2, act="gelu",
        input_mode="embeds")
