"""mamba2-130m [ssm] — 24L d_model=768, attention-free SSD blocks,
ssm_state=128, vocab=50280.  [arXiv:2405.21060]

Attention-free: the decode state is O(1) in sequence length (a conv
window and an SSM state per lane and layer), so there is no KV cache to
page and prompts are admitted by whole-prompt prefill only.
"""

from repro_torch.models.config import (BlockConfig, ModelConfig, Segment,
                                       SSMConfig)

ARCH_ID = "mamba2-130m"


def full_config() -> ModelConfig:
    ssm = SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64,
                    n_groups=1, chunk=256)
    block = BlockConfig(mixer="ssm", ssm=ssm, mlp="none")
    sizes = [4, 4, 4, 4, 4, 4]
    segments = tuple(
        Segment(block=block, n_layers=s, ramp=(i < len(sizes) - 1))
        for i, s in enumerate(sizes))
    return ModelConfig(name=ARCH_ID, d_model=768, vocab=50_280,
                       segments=segments, tie_embeddings=True,
                       long_context_window=None)


def smoke_config() -> ModelConfig:
    ssm = SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=32,
                    n_groups=1, chunk=32)
    block = BlockConfig(mixer="ssm", ssm=ssm, mlp="none")
    segments = (Segment(block=block, n_layers=1, ramp=True),
                Segment(block=block, n_layers=1, ramp=False))
    return ModelConfig(name=ARCH_ID + "-smoke", d_model=128, vocab=512,
                       segments=segments, tie_embeddings=True,
                       long_context_window=None)
