"""Useful model FLOPs, from a configuration's numbers alone.

The convention is the program's ``launch/flops.py`` (copied here, so a
change to the program cannot change the count): 2 * N * D for inference,
N the matmul parameters a token touches (the unembedding counted, the
embedding lookup not) and D the tokens; attention adds 2 * (qk + av) =
4 * heads * head_dim a (token, visible key) pair and layer; a readout
(ramp or head) is 2 * d * vocab.
"""

from __future__ import annotations

from ttbench.lib.shapes import Dense

__all__ = ["layer_params", "active_matmul_params", "model_flops",
           "prompt_flops", "probe_flops"]


def layer_params(m: Dense) -> int:
    """Matmul parameters of one layer: wq, wo, wk, wv and the MLP."""
    n = m.d * m.heads * m.head_dim * 2 + m.d * m.kv_heads * m.head_dim * 2
    return n + (3 if m.act == "swiglu" else 2) * m.d * m.d_ff


def active_matmul_params(m: Dense) -> int:
    return layer_params(m) * m.n_layers + m.d * m.vocab


def _attn(m: Dense, tokens: float, ctx: float) -> float:
    return 2.0 * tokens * ctx * m.heads * 2 * m.head_dim


def model_flops(m: Dense, *, kind: str, global_batch: int,
                seq_len: int) -> float:
    """The program's ``launch.flops.model_flops`` for a dense decoder."""
    n_act = active_matmul_params(m)
    if kind == "train":
        tokens, base = global_batch * seq_len, 6.0
        ctx, mult = seq_len / 2, 3.0
    elif kind == "prefill":
        tokens, base = global_batch * seq_len, 2.0
        ctx, mult = seq_len / 2, 1.0
    elif kind == "decode":
        tokens, base = global_batch, 2.0
        ctx, mult = seq_len, 1.0
    else:
        raise ValueError(kind)
    attn = mult * _attn(m, tokens, ctx) * m.n_layers
    ramp_tokens = tokens if kind == "train" else global_batch
    ramps = (6.0 if kind == "train" else 2.0) * (m.n_nodes - 1) \
        * m.d * m.vocab * ramp_tokens
    return base * n_act * tokens + attn + ramps


def prompt_flops(m: Dense, start: int, width: int, last: bool) -> float:
    """A prompt's rows ``[start, start + width)`` through every layer,
    each row attending to the keys up to itself, and the head's readout
    of the last row when the chunk ends the prompt."""
    # sum over rows p of (p + 1) keys
    keys = width * start + width * (width + 1) / 2
    per_layer = 2.0 * layer_params(m) * width + 4.0 * m.heads \
        * m.head_dim * keys
    return per_layer * m.n_layers + (2.0 * m.d * m.vocab if last else 0.0)


def probe_flops(m: Dense, probes: int, ctx: float) -> float:
    """``probes`` lane-segments of a decode step: each runs a segment's
    layers for one token against ``ctx`` keys and its readout.  Every
    segment of a dense configuration has the layers of the first, up to
    one (`split_segments`); the count takes the mean."""
    layers = m.n_layers / m.n_nodes
    per = layers * (2.0 * layer_params(m) + 4.0 * m.heads * m.head_dim
                    * ctx) + 2.0 * m.d * m.vocab
    return probes * per
