"""Architecture registry of the port: the paper's own early-exit
workload and the SSM family's full-width model, selectable via
``--arch``."""

from __future__ import annotations

from repro_torch.configs import mamba2_130m, paper_ee

REGISTRY = {paper_ee.ARCH_ID: paper_ee, mamba2_130m.ARCH_ID: mamba2_130m}


def get_config(arch: str, smoke: bool = False):
    if arch not in REGISTRY:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(REGISTRY)}")
    mod = REGISTRY[arch]
    return mod.smoke_config() if smoke else mod.full_config()
