"""Model assembly: segments of stacked blocks with early-exit ramps.

Public API (functions over a nested-dict params tree):
  * ``model_defs(cfg)``            — ParamDef tree.
  * ``ramp_readout(...)``          — per-node norm, tied unembedding and
                                     the loss proxy 1 - max softmax.
  * ``prefill(...)``               — full pass over whole prompts: last
                                     logits + per-node losses (the
                                     calibration pass).
  * ``decode_segment(...)``        — one segment for one token against
                                     the paged pool (the serving
                                     engine's unit of work).
  * ``prefill_chunk_segment(...)`` — one segment for one prefill chunk.
  * ``paged_cache_specs(...)``     — the paged pool's (shape, dtype)
                                     spec tree.

Layers are stacked per segment as in the JAX package; a Python loop
over the stack takes the place of its ``lax.scan``.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import blocks
from repro_torch.models.common import embed_def, rms_norm, rms_norm_def
from repro_torch.models.config import ModelConfig
from repro_torch.models.param import tree_map

__all__ = ["model_defs", "prefill", "decode_segment",
           "prefill_chunk_segment", "paged_cache_specs", "unembed",
           "ramp_readout", "layer"]


def _stack_defs(defs, n: int):
    return tree_map(
        lambda d: dataclasses.replace(d, shape=(n,) + d.shape,
                                      axes=("layers",) + d.axes,
                                      fan_axis=d.fan_axis + 1), defs)


def model_defs(cfg: ModelConfig) -> dict:
    if cfg.input_mode != "tokens" or not cfg.tie_embeddings:
        raise NotImplementedError("the port serves token-input models "
                                  "with tied embeddings")
    defs: dict = {"embed": embed_def(cfg.vocab, cfg.d_model)}
    segs = []
    for seg in cfg.segments:
        sd: dict = {"blocks": _stack_defs(
            blocks.block_defs(seg.block, cfg.d_model), seg.n_layers)}
        if seg.ramp:
            sd["ramp"] = {"norm": rms_norm_def(cfg.d_model)}
        segs.append(sd)
    defs["segments"] = segs
    defs["final_norm"] = rms_norm_def(cfg.d_model)
    return defs


def layer(tree, li: int):
    """Layer ``li`` of a layer-stacked tree (views: writes go through)."""
    return tree_map(lambda a: a[li], tree)


def unembed(params: dict, h: torch.Tensor) -> torch.Tensor:
    return h @ params["embed"]["table"].T.to(h.dtype)


def ramp_readout(params, cfg: ModelConfig, h: torch.Tensor,
                 segment: int | None = None):
    """The shared ramp / final-head readout: per-node RMSNorm, tied
    unembedding, and the T-Tamer loss proxy ``ell = 1 - max softmax``.

    ``h`` is the raw residual-stream hidden at the readout point,
    ``(..., D)``; ``segment`` selects that segment's ramp norm (``None``
    -> the final head norm).  Returns ``(logits (..., V), ell (...))``.
    """
    if segment is None:
        norm = params["final_norm"]
    else:
        norm = params["segments"][segment]["ramp"]["norm"]
    logits = unembed(params, rms_norm(norm, h, cfg.norm_eps))
    p = torch.softmax(logits.float(), dim=-1)
    return logits, 1.0 - p.amax(dim=-1)


def prefill(params, cfg: ModelConfig, batch: dict):
    """Full pass over whole prompts: returns (last_logits (B,V),
    node_losses (B, n_nodes), next_pos (B,)).  n_nodes = ramps + final
    (the final head is the last node).  The ring KV caches the JAX
    package also builds here are not part of the port."""
    tokens = batch["tokens"]
    x = params["embed"]["table"][tokens.long()]
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device).expand(b, s)
    node_losses = []
    for si, seg in enumerate(cfg.segments):
        p_seg = params["segments"][si]["blocks"]
        for li in range(seg.n_layers):
            x = blocks.block_forward(layer(p_seg, li), x, positions,
                                     seg.block, cfg.norm_eps)
        if seg.ramp:
            node_losses.append(
                ramp_readout(params, cfg, x[:, -1, :], segment=si)[1])
    logits, final_loss = ramp_readout(params, cfg, x[:, -1, :])
    node_losses.append(final_loss)
    return logits, torch.stack(node_losses, dim=1), positions[:, -1] + 1


def decode_segment(params, cfg: ModelConfig, si: int, x: torch.Tensor,
                   cache_seg, pos: torch.Tensor, paged=None,
                   write_mask=None):
    """Run segment ``si`` for one token against the paged pool (written
    in place).  x (B,1,D) -> (x', cache_seg, readout) where readout is
    None for ramp-less segments and otherwise the `ramp_readout` pair
    (logits (B,V), loss proxy (B,))."""
    seg = cfg.segments[si]
    p_seg = params["segments"][si]["blocks"]
    for li in range(seg.n_layers):
        x, _ = blocks.block_decode(layer(p_seg, li), x, layer(cache_seg, li),
                                   pos, seg.block, cfg.norm_eps,
                                   paged=paged, write_mask=write_mask)
    readout = None
    if seg.ramp:
        readout = ramp_readout(params, cfg, x[:, 0, :], segment=si)
    return x, cache_seg, readout


def prefill_chunk_segment(params, cfg: ModelConfig, si: int,
                          x: torch.Tensor, cache_seg, table: torch.Tensor,
                          chunk):
    """Run segment ``si`` for one PREFILL CHUNK against the paged pool
    (written in place).  x (B, C, D) -> (x', cache_seg).  Chunks run
    full depth, so there is no ramp readout here."""
    seg = cfg.segments[si]
    p_seg = params["segments"][si]["blocks"]
    for li in range(seg.n_layers):
        x, _ = blocks.block_prefill_chunk(layer(p_seg, li), x,
                                          layer(cache_seg, li), seg.block,
                                          cfg.norm_eps, table, chunk)
    return x, cache_seg


def paged_cache_specs(cfg: ModelConfig, n_pages: int,
                      page_size: int) -> list:
    """(shape, dtype) spec tree of the paged pool, per segment and
    stacked over its layers: ``k, v (L, P, page_size, Hkv, hd)``,
    ``pos (L, P, page_size)``."""
    def stack(spec, n):
        if isinstance(spec, dict):
            return {k: stack(v, n) for k, v in spec.items()}
        shape, dtype = spec
        return (n,) + shape, dtype

    return [stack(blocks.cache_defs(seg.block, cfg.d_model, n_pages,
                                    page_size), seg.n_layers)
            for seg in cfg.segments]
