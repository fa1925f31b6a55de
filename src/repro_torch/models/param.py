"""Parameter definitions: one source of truth for shapes and init.

Modules declare a nested dict of ``ParamDef``s; ``materialize`` turns it
into tensors drawn from an explicit ``torch.Generator``.  The layout is
the JAX package's: layers are stacked per segment, so
``params["segments"][si]["blocks"]["attn"]["wq"]`` is ``(L, D, H*hd)``.
"""

from __future__ import annotations

import dataclasses
import math

import torch

__all__ = ["ParamDef", "materialize", "tree_map"]


@dataclasses.dataclass(frozen=True)
class ParamDef:
    """Declarative parameter: shape + logical axes + init recipe."""

    shape: tuple[int, ...]
    axes: tuple[str | None, ...]
    init: str = "fan_in"          # fan_in | zeros | ones | normal | embed
    scale: float = 1.0
    fan_axis: int = 0             # axis treated as fan-in for scaling

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} / axes {self.axes} mismatch")


def tree_map(fn, tree):
    """Apply ``fn`` to every leaf of a nested dict/list/tuple tree."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def _init_leaf(d: ParamDef, generator: torch.Generator) -> torch.Tensor:
    if d.init == "zeros":
        return torch.zeros(d.shape)
    if d.init == "ones":
        return torch.ones(d.shape)
    gdev = generator.device
    if d.init in ("normal", "embed"):
        std = d.scale
    elif d.init == "fan_in":
        fan = d.shape[d.fan_axis] if d.shape else 1
        std = d.scale / math.sqrt(max(fan, 1))
    else:
        raise ValueError(f"unknown init {d.init}")
    return std * torch.randn(d.shape, generator=generator, device=gdev)


def materialize(defs, generator: torch.Generator, device,
                dtype=torch.float32):
    """Instantiate a ParamDef tree into tensors on ``device``.  Draws
    come from ``generator`` (which may live on the CPU or the card) in
    the tree's own order, so one seed gives one set of weights."""
    return tree_map(
        lambda d: _init_leaf(d, generator).to(device=device, dtype=dtype),
        defs)
