"""Architecture registry of the port: the paper's own early-exit
workload, the SSM family's full-width model, the dense decoders (tied:
granite-3-2b, qwen3-4b, starcoder2-3b; untied: qwen3-14b), the embeds-
and multimodal-input decoders (musicgen-large, phi-3-vision-4.2b) and
the MoE models (phi3.5-moe-42b-a6.6b; deepseek-v2-lite-16b with MLA)
and the hybrid attention + SSD model (hymba-1.5b), selectable via
``--arch``.  ``ASSIGNED`` lists every architecture but the paper's own,
in the JAX package's order."""

from __future__ import annotations

from repro_torch.configs import (deepseek_v2_lite_16b, granite_3_2b,
                                 hymba_1_5b, mamba2_130m, musicgen_large,
                                 paper_ee, phi3_5_moe_42b, phi3_vision_4_2b,
                                 qwen3_4b, qwen3_14b, starcoder2_3b)

_MODULES = (
    deepseek_v2_lite_16b, qwen3_4b, qwen3_14b, mamba2_130m, hymba_1_5b,
    phi3_5_moe_42b, granite_3_2b, musicgen_large, starcoder2_3b,
    phi3_vision_4_2b, paper_ee,
)

REGISTRY = {m.ARCH_ID: m for m in _MODULES}
ASSIGNED = [m.ARCH_ID for m in _MODULES if m is not paper_ee]


def get_config(arch: str, smoke: bool = False):
    if arch not in REGISTRY:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(REGISTRY)}")
    mod = REGISTRY[arch]
    return mod.smoke_config() if smoke else mod.full_config()
