"""hymba-1.5b [hybrid] — 32L d_model=1600, 25H GQA kv=5 (head_dim=64) in
parallel with Mamba heads (ssm_state=16), d_ff=5504, vocab=32001.
[arXiv:2411.13676]

As in the JAX package: Hymba's per-head fusion of the attention and SSM
outputs is a per-branch RMSNorm and their average, and every layer uses
sliding-window attention (window 1024) where Hymba keeps 3 global
layers.  Windowed attention beside an SSM is sub-quadratic, so the
`long_500k` shape runs natively.  Prompts are admitted by whole-prompt
prefill only (the SSM state is sequential over the prompt).
"""

from repro_torch.models.config import (AttnConfig, BlockConfig, ModelConfig,
                                       Segment, SSMConfig)

ARCH_ID = "hymba-1.5b"


def full_config() -> ModelConfig:
    attn = AttnConfig(n_heads=25, n_kv_heads=5, head_dim=64, window=1024)
    ssm = SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=64,
                    n_groups=1, chunk=256)
    block = BlockConfig(mixer="hybrid", attn=attn, ssm=ssm, mlp="dense",
                        d_ff=5504)
    sizes = [4, 4, 4, 4, 4, 4, 4, 4]
    segments = tuple(
        Segment(block=block, n_layers=s, ramp=(i < len(sizes) - 1))
        for i, s in enumerate(sizes))
    return ModelConfig(name=ARCH_ID, d_model=1600, vocab=32_001,
                       segments=segments, tie_embeddings=True)


def smoke_config() -> ModelConfig:
    attn = AttnConfig(n_heads=4, n_kv_heads=2, head_dim=32, window=32)
    ssm = SSMConfig(d_state=8, d_conv=4, expand=2, head_dim=32,
                    n_groups=1, chunk=32)
    block = BlockConfig(mixer="hybrid", attn=attn, ssm=ssm, mlp="dense",
                        d_ff=256)
    segments = (Segment(block=block, n_layers=1, ramp=True),
                Segment(block=block, n_layers=1, ramp=False))
    return ModelConfig(name=ARCH_ID + "-smoke", d_model=128, vocab=512,
                       segments=segments, tie_embeddings=True)
