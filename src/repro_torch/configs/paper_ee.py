"""Paper-native early-exit workload config: a ~100M GPT-2-small-scale dense
decoder with a ramp after every pair of layers — the analogue of the
paper's BERT-base / GPT-2 EE backbones (§6, Figs. 5) used by the
end-to-end training example and the Pareto benchmarks."""

from repro_torch.configs.common import dense_decoder
from repro_torch.models.config import ModelConfig

ARCH_ID = "paper-ee-100m"


def full_config() -> ModelConfig:
    # 12L, d_model 768, 12 heads -> ~100M params @ vocab 50257, ramps
    # every 2 layers => 6 T-Tamer nodes (5 ramps + final).
    return dense_decoder(
        ARCH_ID, n_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
        head_dim=64, d_ff=3072, vocab=50_257, n_segments=6, act="gelu",
        tie=True)


def smoke_config() -> ModelConfig:
    return dense_decoder(
        ARCH_ID + "-smoke", n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
        head_dim=32, d_ff=256, vocab=512, n_segments=2, act="gelu")
