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

The sharded input and cache specs of the JAX package's module (and its
``batch_axes``) need the sharding rules of a device mesh and are not
here.
"""

from __future__ import annotations

import dataclasses

from repro_torch.models.config import ModelConfig

__all__ = ["SHAPES", "ShapeSpec", "resolve_config", "cache_len_for"]


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
