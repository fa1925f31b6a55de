"""Architecture registry of the port: the paper's own early-exit
workload, the SSM family's full-width model and the dense tied-embedding
decoders (granite-3-2b, qwen3-4b, starcoder2-3b), selectable via
``--arch``."""

from __future__ import annotations

from repro_torch.configs import (granite_3_2b, mamba2_130m, paper_ee,
                                 qwen3_4b, starcoder2_3b)

REGISTRY = {m.ARCH_ID: m for m in (paper_ee, mamba2_130m, granite_3_2b,
                                   qwen3_4b, starcoder2_3b)}


def get_config(arch: str, smoke: bool = False):
    if arch not in REGISTRY:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(REGISTRY)}")
    mod = REGISTRY[arch]
    return mod.smoke_config() if smoke else mod.full_config()
