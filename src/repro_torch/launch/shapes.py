"""The assigned input shapes, the long-context window override and the
decode cache length of a shape.

Shapes:
  train_4k     seq=4096    global_batch=256   -> a training step
  prefill_32k  seq=32768   global_batch=32    -> a serving prefill
  decode_32k   seq=32768   global_batch=128   -> one decode token against
                                                 a KV cache of seq_len
  long_500k    seq=524288  global_batch=1     -> decode; needs a
               sub-quadratic mixer — SSM, hybrid and windowed models run
               natively, full-attention models take their sliding-window
               variant (``cfg.with_window``).

`input_specs` and `cache_specs_sharded` give every model input and
decode cache of a shape as a `TensorSpec`: shape, dtype and the
partition spec the sharding rules give it on a mesh (the JAX package's
``ShapeDtypeStruct`` with a ``NamedSharding``).  Nothing here allocates.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.sharding.rules import P, RuleSet, axis_sizes, spec_for

__all__ = ["SHAPES", "ShapeSpec", "TensorSpec", "resolve_config",
           "cache_len_for", "batch_axes", "input_specs",
           "cache_specs_sharded"]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str               # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def resolve_config(cfg: ModelConfig, shape: ShapeSpec) -> ModelConfig:
    """``cfg`` with its long-context sliding window where the shape needs
    one (``long_500k`` on a model that is not sub-quadratic)."""
    if shape.name == "long_500k" and not cfg.is_subquadratic:
        if not cfg.long_context_window:
            raise ValueError(f"{cfg.name}: full attention cannot serve "
                             "500k decode")
        return cfg.with_window(cfg.long_context_window)
    return cfg


def _min_window(cfg: ModelConfig) -> int | None:
    """The widest attention window of the model (None: no window)."""
    ws = [s.block.attn.window for s in cfg.segments
          if s.block.mixer in ("attn", "hybrid") and s.block.attn
          and s.block.attn.window]
    return max(ws) if ws else None


def cache_len_for(cfg: ModelConfig, shape: ShapeSpec) -> int:
    """Decode ring length: the sequence, capped at the model's window."""
    w = _min_window(cfg)
    return min(shape.seq_len, w) if w else shape.seq_len


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """An abstract tensor: global shape, dtype and partition spec."""
    shape: tuple
    dtype: torch.dtype
    spec: P


def batch_axes(mesh, rules: RuleSet, batch: int) -> P:
    """Mesh axes used for the batch dim (divisibility-gated)."""
    return spec_for(mesh, rules, (batch,), ("batch",))


def _batch_spec(mesh, rules, batch, extra_dims) -> P:
    bspec = batch_axes(mesh, rules, batch)
    entry = bspec[0] if len(bspec) else None
    return P(*((entry,) + (None,) * extra_dims))


_CACHE_AXES = {
    # key -> axes chooser given (shape tuple, model-axis size)
    "k": lambda s, m: ("layers", "batch", None, "kv_heads", None)
    if s[3] % m == 0 else ("layers", "batch", "kv_len", None, None),
    "v": lambda s, m: ("layers", "batch", None, "kv_heads", None)
    if s[3] % m == 0 else ("layers", "batch", "kv_len", None, None),
    "pos": lambda s, m: ("layers", "batch", None),
    "c_kv": lambda s, m: ("layers", "batch", "kv_len", None)
    if s[2] % m == 0 else ("layers", "batch", None, None),
    "k_rope": lambda s, m: ("layers", "batch", "kv_len", None)
    if s[2] % m == 0 else ("layers", "batch", None, None),
    "k_s": lambda s, m: ("layers", "batch", None, "kv_heads")
    if s[3] % m == 0 else ("layers", "batch", "kv_len", None),
    "v_s": lambda s, m: ("layers", "batch", None, "kv_heads")
    if s[3] % m == 0 else ("layers", "batch", "kv_len", None),
    "c_kv_s": lambda s, m: ("layers", "batch", "kv_len")
    if s[2] % m == 0 else ("layers", "batch", None),
    "k_rope_s": lambda s, m: ("layers", "batch", "kv_len")
    if s[2] % m == 0 else ("layers", "batch", None),
    "conv": lambda s, m: ("layers", "batch", None, "conv_dim"),
    "ssm": lambda s, m: ("layers", "batch", None, None, None),
}


def cache_specs_sharded(cfg: ModelConfig, shape: ShapeSpec, mesh,
                        rules: RuleSet) -> list:
    """The decode caches of a shape, one `TensorSpec` a leaf, per
    segment (the tree `models.model.cache_specs` gives)."""
    cache_len = cache_len_for(cfg, shape)
    specs = M.cache_specs(cfg, shape.global_batch, cache_len)
    model_size = axis_sizes(mesh).get("model", 1)

    def walk(node, key=None):
        if isinstance(node, tuple) and len(node) == 2 \
                and isinstance(node[0], tuple):
            shp, dt = node
            axes = _CACHE_AXES[key](shp, model_size)
            return TensorSpec(shp, dt, spec_for(mesh, rules, shp, axes))
        return {k: walk(v, k) for k, v in node.items()}

    return [walk(seg) for seg in specs]


def input_specs(cfg: ModelConfig, shape: ShapeSpec, mesh,
                rules: RuleSet) -> dict:
    """`TensorSpec` stand-ins for every model input of this shape."""
    b, s = shape.global_batch, shape.seq_len
    i32, bf16 = torch.int32, torch.bfloat16
    out: dict = {}
    if shape.kind in ("train", "prefill"):
        if cfg.input_mode == "tokens":
            out["tokens"] = TensorSpec((b, s), i32,
                                       _batch_spec(mesh, rules, b, 1))
        elif cfg.input_mode == "embeds":
            out["embeds"] = TensorSpec((b, s, cfg.d_model), bf16,
                                       _batch_spec(mesh, rules, b, 2))
        else:  # multimodal: stubbed patch embeddings + text tokens
            n_img = cfg.image_tokens
            out["tokens"] = TensorSpec((b, s - n_img), i32,
                                       _batch_spec(mesh, rules, b, 1))
            out["image_embeds"] = TensorSpec(
                (b, n_img, cfg.d_model), bf16,
                _batch_spec(mesh, rules, b, 2))
        if shape.kind == "train":
            out["labels"] = TensorSpec((b, s), i32,
                                       _batch_spec(mesh, rules, b, 1))
    else:  # decode: ONE new token against a full cache
        if cfg.input_mode in ("tokens", "multimodal"):
            out["tokens"] = TensorSpec((b,), i32,
                                       _batch_spec(mesh, rules, b, 0))
        else:
            out["embeds"] = TensorSpec((b, cfg.d_model), bf16,
                                       _batch_spec(mesh, rules, b, 1))
    return out
