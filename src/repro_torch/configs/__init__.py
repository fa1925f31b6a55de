"""Architecture registry of the port: the paper's own early-exit
workload, selectable via ``--arch``."""

from __future__ import annotations

from repro_torch.configs import paper_ee

REGISTRY = {paper_ee.ARCH_ID: paper_ee}


def get_config(arch: str, smoke: bool = False):
    if arch not in REGISTRY:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(REGISTRY)}")
    mod = REGISTRY[arch]
    return mod.smoke_config() if smoke else mod.full_config()
