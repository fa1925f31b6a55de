"""Logical-axis -> mesh-axis sharding rules (the JAX package's
``sharding/rules.py``).

Weights and activations declare *logical* axes ("batch", "heads", "mlp",
"experts", "vocab", ...); a RuleSet lowers them to a spec `P` for a
concrete mesh, gating every assignment on divisibility (a dim that does
not divide falls back to replication, e.g. granite's vocab=49155 on a
16-way model axis).  `placements_for` turns a spec into the DTensor
placements of a `DeviceMesh`, one a mesh dimension.

The BASELINE rules are Megatron-style tensor parallelism on the "model"
axis plus (pod, data) batch parallelism; other rule sets are built with
``RuleSet.override``.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping

__all__ = ["P", "RuleSet", "BASELINE_RULES", "FSDP_TRAIN_RULES",
           "GQA_RULES", "axis_sizes", "spec_for", "placements_for",
           "sharding_tree"]


class P(tuple):
    """A partition spec: one entry a tensor dim, each ``None``
    (replicated), one mesh-axis name or a tuple of them; equal, entry for
    entry, to ``tuple()`` of the JAX package's ``PartitionSpec``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class RuleSet:
    """Mapping logical axis -> tuple of mesh axes (in sharding order)."""
    rules: dict

    def override(self, **kw) -> "RuleSet":
        r = dict(self.rules)
        for k, v in kw.items():
            r[k] = tuple(v) if v else ()
        return RuleSet(rules=r)

    def mesh_axes(self, logical: str | None) -> tuple[str, ...]:
        if logical is None:
            return ()
        return tuple(self.rules.get(logical, ()))


BASELINE_RULES = RuleSet(rules={
    # data parallelism
    "batch": ("pod", "data"),
    # tensor parallelism (Megatron layout)
    "heads": ("model",),
    "kv_heads": ("model",),
    "mlp": ("model",),
    "experts": ("model",),
    "vocab": ("model",),
    "conv_dim": ("model",),
    # KV-cache sequence dim: sharded over "model" when kv-head sharding
    # isn't divisible (context-parallel decode; see launch/shapes.py)
    "kv_len": ("model",),
    # replicated by default
    "embed": (),
    "layers": (),
    "seq": (),
})

# Training shards weights 2-D: tensor-parallel on "model" AND fsdp-style on
# "data" along the embed (fan-in) dim, for the f32 master weights and the
# AdamW moments.
FSDP_TRAIN_RULES = BASELINE_RULES.override(embed=("data",))

# GQA-factorized mesh rules (mesh layout "gqa": model=8 x model2=2).
# Attention dims shard on the kv-aligned 8-way factor only; everything
# wide (FFN hidden, experts, vocab) spans both factors (16-way).
GQA_RULES = BASELINE_RULES.override(
    heads=("model",), kv_heads=("model",),
    mlp=("model", "model2"), experts=("model", "model2"),
    vocab=("model", "model2"), conv_dim=("model", "model2"))


def axis_sizes(mesh) -> Mapping:
    """Axis name -> size of a mesh: ``mesh.shape`` where it is already
    that mapping (the JAX package's meshes, test stand-ins), else a
    `DeviceMesh`'s ``mesh_dim_names`` beside its ``shape``."""
    shape = mesh.shape
    if isinstance(shape, Mapping):
        return shape
    return dict(zip(mesh.mesh_dim_names, shape))


def _axis_size(sizes: Mapping, names: tuple[str, ...]) -> int:
    size = 1
    for n in names:
        if n in sizes:
            size *= sizes[n]
    return size


def spec_for(mesh, rules: RuleSet, shape: tuple[int, ...],
             axes: tuple[str | None, ...]) -> P:
    """Partition spec for one array, with divisibility gating."""
    sizes = axis_sizes(mesh)
    entries = []
    used: set[str] = set()
    for dim, logical in zip(shape, axes):
        names = tuple(n for n in rules.mesh_axes(logical)
                      if n in sizes and n not in used)
        if names and dim % _axis_size(sizes, names) == 0:
            entries.append(names if len(names) > 1 else names[0])
            used.update(names)
        else:
            entries.append(None)
    while entries and entries[-1] is None:
        entries.pop()
    return P(*entries)


def placements_for(mesh, spec, ndim: int) -> tuple:
    """The DTensor placements of ``spec`` on the `DeviceMesh` ``mesh``:
    one a mesh dim, ``Shard(d)`` where tensor dim d names that mesh axis
    and ``Replicate()`` elsewhere.  A dim sharded over several axes, such
    as ``("pod", "data")``, is ``Shard(d)`` on each of them, in mesh
    order."""
    from torch.distributed.tensor import Replicate, Shard

    if len(spec) > ndim:
        raise ValueError(f"spec {spec} has more entries than the tensor's "
                         f"{ndim} dims")
    dim_of: dict[str, int] = {}
    for d, entry in enumerate(spec):
        for name in ((entry,) if isinstance(entry, str) else entry or ()):
            if name not in mesh.mesh_dim_names:
                raise ValueError(f"spec {spec} names axis {name!r}, not "
                                 f"in the mesh {mesh.mesh_dim_names}")
            dim_of[name] = d
    return tuple(Shard(dim_of[n]) if n in dim_of else Replicate()
                 for n in mesh.mesh_dim_names)


def sharding_tree(mesh, rules: RuleSet, defs):
    """The tree of specs for a ParamDef tree."""
    from repro_torch.models.param import tree_map

    return tree_map(lambda d: spec_for(mesh, rules, d.shape, d.axes), defs)
