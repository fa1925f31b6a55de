"""Parameter definitions: one source of truth for shapes and init.

Modules declare a nested dict of ``ParamDef``s; ``materialize`` turns it
into tensors drawn from an explicit ``torch.Generator``, ``abstract``
into tensors on the meta device (shapes and dtypes, no storage), and
``logical_specs`` into the tree of logical-axis tuples.  The layout is
the JAX package's: layers are stacked per segment, so
``params["segments"][si]["blocks"]["attn"]["wq"]`` is ``(L, D, H*hd)``.
"""

from __future__ import annotations

import dataclasses
import math

import torch

__all__ = ["ParamDef", "materialize", "abstract", "logical_specs",
           "count_params", "tree_map", "tree_leaves", "check_params"]


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


def tree_leaves(tree) -> list:
    """The leaves of a nested dict/list/tuple tree, dict keys in sorted
    order (the JAX package's ``jax.tree.leaves`` order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


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


def abstract(defs, dtype=torch.bfloat16):
    """The ParamDef tree as tensors on the meta device: every shape and
    ``dtype``, no storage allocated anywhere."""
    return tree_map(lambda d: torch.empty(d.shape, dtype=dtype,
                                          device="meta"), defs)


def logical_specs(defs):
    """Tree of logical-axis tuples, the same structure as the params."""
    return tree_map(lambda d: d.axes, defs)


def count_params(defs) -> int:
    """Number of parameters the ParamDef tree declares."""
    return sum(math.prod(d.shape) for d in tree_leaves(defs))


def check_params(defs, params, dtype=torch.float32, path: str = "") -> None:
    """Raise ValueError, naming the leaf, unless ``params`` has the keys
    of the ParamDef tree ``defs`` and each leaf its shape and
    ``dtype``."""
    if isinstance(defs, ParamDef):
        if not isinstance(params, torch.Tensor):
            raise ValueError(f"parameter {path}: expected a tensor, got "
                             f"{type(params).__name__}")
        if tuple(params.shape) != defs.shape or params.dtype != dtype:
            raise ValueError(
                f"parameter {path}: {tuple(params.shape)} {params.dtype}, "
                f"the model wants {defs.shape} {dtype}")
        return
    if isinstance(defs, dict):
        if not isinstance(params, dict) or set(params) != set(defs):
            got = sorted(params) if isinstance(params, dict) else params
            raise ValueError(f"parameters at {path or '/'}: keys {got}, "
                             f"the model wants {sorted(defs)}")
        for k in defs:
            check_params(defs[k], params[k], dtype, f"{path}/{k}")
        return
    if not isinstance(params, (list, tuple)) or len(params) != len(defs):
        raise ValueError(f"parameters at {path}: the model wants a list "
                         f"of {len(defs)}")
    for i, (d, p) in enumerate(zip(defs, params)):
        check_params(d, p, dtype, f"{path}/#{i}")
