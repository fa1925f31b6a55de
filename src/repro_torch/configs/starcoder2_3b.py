"""starcoder2-3b [dense] — 30L d_model=3072, 24H GQA kv=2, d_ff=12288,
vocab=49152, RoPE + native sliding window 4096.  [arXiv:2402.19173]"""

from repro_torch.configs.common import dense_decoder
from repro_torch.models.config import ModelConfig

ARCH_ID = "starcoder2-3b"


def full_config() -> ModelConfig:
    return dense_decoder(
        ARCH_ID, n_layers=30, d_model=3072, n_heads=24, n_kv_heads=2,
        head_dim=128, d_ff=12_288, vocab=49_152, n_segments=6,
        window=4096, act="gelu", rope_theta=1_000_000.0, tie=True)


def smoke_config() -> ModelConfig:
    return dense_decoder(
        ARCH_ID + "-smoke", n_layers=2, d_model=128, n_heads=4, n_kv_heads=1,
        head_dim=32, d_ff=256, vocab=512, n_segments=2, window=64,
        act="gelu")
