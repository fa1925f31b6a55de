"""qwen3-14b [dense] — 40L d_model=5120, 40H GQA kv=8, d_ff=17408,
vocab=151936, qk_norm.  [hf:Qwen/Qwen3-8B family; head_dim=128]"""

from repro_torch.configs.common import dense_decoder
from repro_torch.models.config import ModelConfig

ARCH_ID = "qwen3-14b"


def full_config() -> ModelConfig:
    return dense_decoder(
        ARCH_ID, n_layers=40, d_model=5120, n_heads=40, n_kv_heads=8,
        head_dim=128, d_ff=17_408, vocab=151_936, n_segments=5,
        qk_norm=True, rope_theta=1_000_000.0, tie=False)


def smoke_config() -> ModelConfig:
    return dense_decoder(
        ARCH_ID + "-smoke", n_layers=2, d_model=160, n_heads=5, n_kv_heads=1,
        head_dim=32, d_ff=320, vocab=512, n_segments=2, qk_norm=True,
        tie=False)
