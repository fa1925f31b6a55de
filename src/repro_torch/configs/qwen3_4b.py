"""qwen3-4b [dense] — 36L d_model=2560, 32H GQA kv=8, d_ff=9728,
vocab=151936, qk_norm.  [hf:Qwen/Qwen3-8B family; head_dim=128]"""

from repro_torch.configs.common import dense_decoder
from repro_torch.models.config import ModelConfig

ARCH_ID = "qwen3-4b"


def full_config() -> ModelConfig:
    return dense_decoder(
        ARCH_ID, n_layers=36, d_model=2560, n_heads=32, n_kv_heads=8,
        head_dim=128, d_ff=9728, vocab=151_936, n_segments=6, qk_norm=True,
        rope_theta=1_000_000.0, tie=True)


def smoke_config() -> ModelConfig:
    return dense_decoder(
        ARCH_ID + "-smoke", n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
        head_dim=32, d_ff=256, vocab=512, n_segments=2, qk_norm=True)
