"""Analytic model FLOPs of one step of a shape.

Convention (the JAX package's): 6 * N * D for training and 2 * N_active
* D for inference, where N(_active) counts the matmul parameters a token
touches (MoE: the shared and the top_k routed experts; the embedding
lookup left out, the unembedding counted) and D the tokens processed.
The attention term, 2 * tokens * context * heads * (qk + av width) a
layer, is added on its own, with context capped at the window; MLA's
decode counts its absorbed latent widths.  The ramps' readouts count on
every token in training and on the last one when serving.
"""

from __future__ import annotations

from repro_torch.models import model as M
from repro_torch.models.config import BlockConfig, ModelConfig
from repro_torch.models.param import count_params

__all__ = ["active_matmul_params", "model_flops", "total_params"]


def _block_active_params(b: BlockConfig, d: int) -> int:
    n = 0
    if b.mixer in ("attn", "hybrid"):
        a = b.attn
        if a.mla:
            m = a.mla
            qd = a.n_heads * (m.qk_nope_head_dim + m.qk_rope_head_dim)
            n += d * qd if not m.q_lora_rank else (
                d * m.q_lora_rank + m.q_lora_rank * qd)
            n += d * (m.kv_lora_rank + m.qk_rope_head_dim)
            n += m.kv_lora_rank * a.n_heads * (m.qk_nope_head_dim
                                               + m.v_head_dim)
            n += a.n_heads * m.v_head_dim * d
        else:
            n += d * a.n_heads * a.head_dim * 2            # wq, wo
            n += d * a.n_kv_heads * a.head_dim * 2         # wk, wv
    if b.mixer in ("ssm", "hybrid"):
        s = b.ssm
        di = s.d_inner(d)
        gn = s.n_groups * s.d_state
        n += d * (2 * di + 2 * gn + s.n_heads(d))          # in_proj
        n += di * d                                        # out_proj
    if b.mlp == "dense":
        mult = 3 if b.act == "swiglu" else 2
        n += mult * d * b.d_ff
    elif b.mlp == "moe":
        mo = b.moe
        mult = 3 if b.act == "swiglu" else 2
        n += mo.top_k * mult * d * mo.d_ff_expert          # routed (active)
        if mo.num_shared:
            ff = mo.d_ff_shared or mo.num_shared * mo.d_ff_expert
            n += mult * d * ff
        n += d * mo.num_experts                            # router
    return n


def active_matmul_params(cfg: ModelConfig) -> int:
    """Matmul parameters one token touches, the unembedding included."""
    n = sum(_block_active_params(s.block, cfg.d_model) * s.n_layers
            for s in cfg.segments)
    return n + cfg.d_model * cfg.vocab                     # unembed


def total_params(cfg: ModelConfig) -> int:
    return count_params(M.model_defs(cfg))


def _attn_flops_per_layer(b: BlockConfig, tokens: int, ctx: float,
                          absorbed: bool = False) -> float:
    """2 * (qk + av) = 4 * tokens * ctx * h * hd for GQA; MLA's absorbed
    decode pays 2 * (lora + rope) for the scores and 2 * lora for the
    context a (token, position) and head."""
    if b.mixer not in ("attn", "hybrid"):
        return 0.0
    a = b.attn
    eff_ctx = min(ctx, a.window) if a.window else ctx
    if a.mla:
        m = a.mla
        if absorbed:
            hd = 2 * m.kv_lora_rank + m.qk_rope_head_dim
        else:
            hd = m.qk_nope_head_dim + m.qk_rope_head_dim + m.v_head_dim
    else:
        hd = 2 * a.head_dim
    return 2.0 * tokens * eff_ctx * a.n_heads * hd


def model_flops(cfg: ModelConfig, *, kind: str, global_batch: int,
                seq_len: int) -> float:
    """Analytic useful FLOPs of one step of ``kind`` ("train", "prefill"
    or "decode": one new token a sequence against ``seq_len`` of
    context)."""
    n_act = active_matmul_params(cfg)
    if kind == "train":
        tokens = global_batch * seq_len
        base = 6.0 * n_act * tokens
        ctx = seq_len / 2  # average causal context
        mult = 3.0         # forward + backward
    elif kind == "prefill":
        tokens = global_batch * seq_len
        base = 2.0 * n_act * tokens
        ctx = seq_len / 2
        mult = 1.0
    elif kind == "decode":
        tokens = global_batch
        base = 2.0 * n_act * tokens
        ctx = seq_len
        mult = 1.0
    else:
        raise ValueError(kind)
    attn = mult * sum(
        _attn_flops_per_layer(s.block, tokens, ctx,
                              absorbed=(kind == "decode"))
        * s.n_layers for s in cfg.segments)
    ramp_tokens = tokens if kind == "train" else global_batch
    ramps = (6.0 if kind == "train" else 2.0) \
        * cfg.n_ramps * cfg.d_model * cfg.vocab * ramp_tokens
    return base + attn + ramps
