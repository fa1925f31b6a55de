"""Dense early-exit decoders: the program's configuration from the
file's numbers, the benchmark's weights, the plain reference and the
useful-FLOP counts."""

from __future__ import annotations

from ttbench.lib.flops import probe_flops, prompt_flops
from ttbench.lib.shapes import dense as shapes
from ttbench.reference.dense import Model, make_weights

__all__ = ["shapes", "make_weights", "program_config", "Model",
           "prompt_flops", "probe_flops"]


def program_config(cfg: dict):
    """The program's ``ModelConfig`` of a dense configuration file,
    through the program's own builder."""
    from repro_torch.configs.common import dense_decoder
    m = shapes(cfg)
    if cfg.get("attention_multiplier", m.head_dim ** -0.5) != \
            m.head_dim ** -0.5:
        raise ValueError(f"{cfg['name']}: the program's attention scales "
                         "by 1/sqrt(head_dim) only")
    if m.eps != 1e-5:
        raise ValueError(f"{cfg['name']}: the program's RMSNorm eps is "
                         "1e-5")
    for key in ("embedding_multiplier", "residual_multiplier",
                "logits_scaling"):
        if cfg.get(key, 1.0) != 1.0:
            raise ValueError(f"{cfg['name']}: the program has no {key}")
    return dense_decoder(
        cfg["name"], n_layers=m.n_layers, d_model=m.d, n_heads=m.heads,
        n_kv_heads=m.kv_heads, head_dim=m.head_dim, d_ff=m.d_ff,
        vocab=m.vocab, n_segments=m.n_nodes, act=m.act,
        rope_theta=m.rope_theta, tie=m.tied)
