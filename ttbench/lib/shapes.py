"""A dense configuration file's numbers, in the form the counts and the
reference read them."""

from __future__ import annotations

import dataclasses

__all__ = ["Dense", "dense", "split_segments"]


def split_segments(n_layers: int, n_segments: int) -> list[int]:
    """Layers a segment, the later segments one longer where the split
    is uneven (the program's ``configs.common.split_segments``)."""
    base, rem = divmod(n_layers, n_segments)
    return [base + (1 if i >= n_segments - rem else 0)
            for i in range(n_segments)]


@dataclasses.dataclass(frozen=True)
class Dense:
    d: int
    vocab: int
    heads: int
    kv_heads: int
    head_dim: int
    d_ff: int
    act: str                  # "gelu" (tanh form) or "swiglu"
    seg_layers: tuple         # layers of each segment; a ramp after all
    rope_theta: float         # but the last
    eps: float
    tied: bool

    @property
    def n_layers(self) -> int:
        return sum(self.seg_layers)

    @property
    def n_nodes(self) -> int:
        return len(self.seg_layers)


_ACTS = {"gelu_pytorch_tanh": "gelu", "gelu_new": "gelu", "gelu": "gelu",
         "silu": "swiglu"}


def dense(cfg: dict) -> Dense:
    """The numbers of a ``"family": "dense"`` configuration file (keys of
    a Hugging Face ``config.json`` plus ``n_segments``)."""
    return Dense(
        d=cfg["hidden_size"], vocab=cfg["vocab_size"],
        heads=cfg["num_attention_heads"],
        kv_heads=cfg["num_key_value_heads"], head_dim=cfg["head_dim"],
        d_ff=cfg["intermediate_size"], act=_ACTS[cfg["hidden_act"]],
        seg_layers=tuple(split_segments(cfg["num_hidden_layers"],
                                        cfg["n_segments"])),
        rope_theta=float(cfg["rope_theta"]), eps=float(cfg["rms_norm_eps"]),
        tied=bool(cfg["tie_word_embeddings"]))
