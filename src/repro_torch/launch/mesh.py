"""Production and local device meshes (the JAX package's
``launch/mesh.py``), as `torch.distributed` DeviceMeshes.

Functions, not module-level constants: importing this module touches no
process group and no device.  A mesh covers the first ranks of the
world that is running; it needs that world set up first —
``torch.distributed.run`` for a real one (NCCL on the card, gloo on the
CPU), or the ``fake`` backend of `repro_torch.launch.dryrun` for the
512 ranks of the production meshes (the counterpart of the JAX
package's ``--xla_force_host_platform_device_count=512``).
"""

from __future__ import annotations

import math

import torch

__all__ = ["make_production_mesh", "make_local_mesh"]


def _mesh(shape, axes):
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    n = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have < n:
        raise RuntimeError(
            f"mesh {shape} needs {n} ranks, found {have} — run it under "
            f"`python -m torch.distributed.run --nproc-per-node {n}`, or "
            f"import repro_torch.launch.dryrun first for its 512-rank fake "
            f"world")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.arange(n).reshape(shape),
                      mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, layout: str = "2d"):
    """16x16 = 256 devices a pod; 2 pods = 512.

    Axes: "data" shards the batch, "model" shards tensor/expert dims,
    "pod" (multi-pod only) is an outer data axis whose collectives cross
    the inter-pod links.

    layout="gqa" factorizes the model axis 16 -> ("model"=8, "model2"=2)
    so GQA geometries with 8 kv heads shard cleanly: attention uses
    "model" only, while MLP/vocab dims span both factors.
    """
    if layout == "gqa":
        shape = (2, 16, 8, 2) if multi_pod else (16, 8, 2)
        axes = (("pod", "data", "model", "model2") if multi_pod
                else ("data", "model", "model2"))
    else:
        shape = (2, 16, 16) if multi_pod else (16, 16)
        axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes)


def make_local_mesh(data: int = 1, model: int = 1):
    """Small mesh over the first ``data * model`` ranks of the world."""
    return _mesh((data, model), ("data", "model"))
