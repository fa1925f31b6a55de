"""granite-3-2b [dense] — 40L d_model=2048, 32H GQA kv=8, d_ff=8192,
vocab=49155.  [hf:ibm-granite/granite-3.0-2b-base]"""

from repro_torch.configs.common import dense_decoder
from repro_torch.models.config import ModelConfig

ARCH_ID = "granite-3-2b"


def full_config() -> ModelConfig:
    return dense_decoder(
        ARCH_ID, n_layers=40, d_model=2048, n_heads=32, n_kv_heads=8,
        head_dim=64, d_ff=8192, vocab=49_155, n_segments=5, tie=True)


def smoke_config() -> ModelConfig:
    return dense_decoder(
        ARCH_ID + "-smoke", n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
        head_dim=32, d_ff=256, vocab=512, n_segments=2)
