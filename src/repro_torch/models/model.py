"""Model assembly: segments of stacked blocks with early-exit ramps.

Public API (functions over a nested-dict params tree):
  * ``model_defs(cfg)``            — ParamDef tree.
  * ``forward_train(...)``         — full pass with the early-exit
                                     multi-ramp loss (the training
                                     step's objective).
  * ``ramp_readout(...)``          — per-node norm, unembedding (tied
                                     or not) and the loss proxy 1 - max
                                     softmax.
  * ``prefill(...)``               — full pass over whole prompts: last
                                     logits, ring KV caches or SSM
                                     state, per-node losses
                                     (calibration and every
                                     stop-the-world admission).
  * ``decode_step(...)``           — one full-depth token on the ring
                                     caches / SSM state.
  * ``decode_segment(...)``        — one segment for one token against
                                     the ring caches or the paged pool
                                     (the serving engine's unit of
                                     work).
  * ``prefill_chunk_segment(...)`` — one segment for one prefill chunk.
  * ``cache_specs(...)``           — the decode caches' (shape,
                                     dtype) spec tree.
  * ``paged_cache_specs(...)``     — the paged pool's (shape, dtype)
                                     spec tree, SSM state per lane.

Layers are stacked per segment as in the JAX package; a Python loop
over the stack takes the place of its ``lax.scan``, so decode always
runs unrolled (the JAX package's ``decode_unroll`` switch has nothing
to switch here).
"""

from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import blocks
from repro_torch.models.common import embed_def, rms_norm, rms_norm_def
from repro_torch.models.config import ModelConfig
from repro_torch.models.param import ParamDef, tree_leaves, tree_map
from repro_torch.sharding.ctx import (constrain_batch, embed_rows,
                                     max_softmax, reduce_partial)

__all__ = ["model_defs", "forward_train", "prefill", "decode_step",
           "decode_segment", "prefill_chunk_segment", "cache_specs",
           "paged_cache_specs", "unembed", "ramp_readout",
           "readout_logits", "layer"]


def _stack_defs(defs, n: int):
    return tree_map(
        lambda d: dataclasses.replace(d, shape=(n,) + d.shape,
                                      axes=("layers",) + d.axes,
                                      fan_axis=d.fan_axis + 1), defs)


def model_defs(cfg: ModelConfig) -> dict:
    defs: dict = {}
    if cfg.input_mode in ("tokens", "multimodal") or cfg.tie_embeddings:
        # an embeds-input model keeps the table only as its tied output
        defs["embed"] = embed_def(cfg.vocab, cfg.d_model)
    segs = []
    for seg in cfg.segments:
        sd: dict = {"blocks": _stack_defs(
            blocks.block_defs(seg.block, cfg.d_model), seg.n_layers)}
        if seg.ramp:
            sd["ramp"] = {"norm": rms_norm_def(cfg.d_model)}
        segs.append(sd)
    defs["segments"] = segs
    defs["final_norm"] = rms_norm_def(cfg.d_model)
    if not cfg.tie_embeddings:
        defs["unembed"] = ParamDef((cfg.d_model, cfg.vocab),
                                   ("embed", "vocab"))
    return defs


def layer(tree, li: int):
    """Layer ``li`` of a layer-stacked tree (views: writes go through)."""
    return tree_map(lambda a: a[li], tree)


def unembed(params: dict, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    """Logits of the hidden ``h`` (..., D): the tied table's transpose or
    the untied ``unembed`` (D, V).  ``.to`` copies nothing when the table
    already has h's dtype."""
    if cfg.tie_embeddings:
        return h @ params["embed"]["table"].T.to(h.dtype)
    return h @ params["unembed"].to(h.dtype)


def ramp_readout(params, cfg: ModelConfig, h: torch.Tensor,
                 segment: int | None = None):
    """The shared ramp / final-head readout: per-node RMSNorm, the
    unembedding, and the T-Tamer loss proxy ``ell = 1 - max softmax``.

    ``h`` is the raw residual-stream hidden at the readout point,
    ``(..., D)``; ``segment`` selects that segment's ramp norm (``None``
    -> the final head norm).  Returns ``(logits (..., V), ell (...))``.
    """
    logits = readout_logits(params, cfg, h, segment)
    return logits, 1.0 - max_softmax(logits.float())


def readout_logits(params, cfg: ModelConfig, h: torch.Tensor,
                   segment: int | None = None) -> torch.Tensor:
    """`ramp_readout`'s logits alone (training needs no loss proxy)."""
    if segment is None:
        norm = params["final_norm"]
    else:
        norm = params["segments"][segment]["ramp"]["norm"]
    return unembed(params, cfg, rms_norm(norm, h, cfg.norm_eps))


def _stack_layers(trees: list):
    """Per-layer trees of tensors -> one tree stacked on a new axis 0."""
    if isinstance(trees[0], dict):
        return {k: _stack_layers([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _embed_inputs(params, cfg: ModelConfig, batch: dict):
    """Returns (x (B,S,D), positions (B,S) i32).  batch: {"tokens"
    (B,S)} or {"embeds" (B,S,D)}, or for a multimodal model {"tokens"
    (B,S_text), "image_embeds" (B,image_tokens,D)}: the image embeds
    come before the text tokens."""
    if cfg.input_mode == "tokens":
        x = embed_rows(params["embed"]["table"], batch["tokens"].long())
    elif cfg.input_mode == "embeds":
        x = batch["embeds"]
    elif cfg.input_mode == "multimodal":
        tok = embed_rows(params["embed"]["table"], batch["tokens"].long())
        x = torch.cat([batch["image_embeds"].to(tok.dtype), tok], dim=1)
    else:
        raise ValueError(cfg.input_mode)
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device).expand(b, s)
    return constrain_batch(x), positions


def _train_layer(p_layer, x, positions, block, eps, use_flash,
                 use_ssd_kernel):
    y, _, aux = blocks.block_forward(p_layer, x, positions, block, eps,
                                     use_flash, use_ssd_kernel)
    return y, aux


def _merge_aux(total: dict, layers: list) -> dict:
    """Add one segment's per-layer aux losses to ``total``: the layers'
    sum first, as the JAX package sums its layer-stacked aux."""
    for key in (layers[0] if layers else {}):
        seg = torch.stack([a[key] for a in layers]).sum()
        total[key] = total[key] + seg if key in total else seg
    return total


def _run_segments(params, cfg: ModelConfig, x, positions, *, remat: bool,
                  use_flash: bool, use_ssd_kernel: bool):
    """The training pass: (final hidden, [(segment, raw ramp hidden)],
    aux) with aux the MoE aux losses summed over layers (empty for a
    dense model).  ``remat`` recomputes each layer's activations in the
    backward pass (`torch.utils.checkpoint`, the JAX package's per-layer
    ``jax.checkpoint``); it changes no value."""
    ramps, aux = [], {}
    for si, seg in enumerate(cfg.segments):
        p_seg = params["segments"][si]["blocks"]
        seg_aux = []
        for li in range(seg.n_layers):
            args = (layer(p_seg, li), x, positions, seg.block, cfg.norm_eps,
                    use_flash, use_ssd_kernel)
            x, a = (checkpoint(_train_layer, *args, use_reentrant=False)
                    if remat else _train_layer(*args))
            seg_aux.append(a)
        x = constrain_batch(x)  # re-anchor residual-stream sharding
        aux = _merge_aux(aux, seg_aux)
        if seg.ramp:
            ramps.append((si, x))
    return x, ramps, aux


def _xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean CE over valid (label >= 0) positions, in f32.  logits
    (B,S,V), labels (B,S)."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    ll = reduce_partial(torch.gather(lf, -1, labels.clamp(min=0).long()[
        ..., None]))[..., 0]
    valid = labels >= 0
    ce = torch.where(valid, lse - ll, 0.0)
    return ce.sum() / valid.sum().clamp(min=1)


def _refuse_kernels_under_autograd(params, cfg: ModelConfig, use_flash,
                                   use_ssd_kernel) -> None:
    """The kernels have no backward (nor have the JAX package's): a
    training pass that would route a layer through one while gradients
    are being recorded raises, as the JAX package's ``jax.grad`` does."""
    mixers = {seg.block.mixer for seg in cfg.segments}
    routed = [name for name, on, mixer in (("use_flash", use_flash, "attn"),
                                           ("use_ssd_kernel", use_ssd_kernel,
                                            "ssm"))
              if on and (mixer in mixers or "hybrid" in mixers)]
    if routed and torch.is_grad_enabled() and any(
            t.requires_grad for t in tree_leaves(params)):
        raise NotImplementedError(
            f"forward_train: {', '.join(routed)} routes layers through a "
            "kernel that has no backward; train on the plain path")


def forward_train(params, cfg: ModelConfig, batch: dict, *,
                  ramp_loss_weight: float = 0.3, remat: bool = True,
                  use_flash: bool = False, use_ssd_kernel: bool = False):
    """Early-exit training objective: CE(final) + w * mean over ramps of
    CE(ramp) + the MoE aux losses.  batch: the inputs `_embed_inputs`
    takes and "labels" (B, S_total); labels below 0 are masked.  Returns
    (loss, metrics) with metrics ``ce_final``, ``ce_ramp{i}``, for an
    MoE model ``moe_load_balance`` and ``moe_router_z``, and ``loss``,
    all 0-dim tensors."""
    _refuse_kernels_under_autograd(params, cfg, use_flash, use_ssd_kernel)
    x, positions = _embed_inputs(params, cfg, batch)
    final, ramps, aux = _run_segments(params, cfg, x, positions,
                                      remat=remat, use_flash=use_flash,
                                      use_ssd_kernel=use_ssd_kernel)
    labels = batch["labels"]
    loss = _xent(readout_logits(params, cfg, final), labels)
    metrics = {"ce_final": loss}
    if ramps:
        ramp_ce = 0.0
        for ri, (si, h) in enumerate(ramps):
            ce = _xent(readout_logits(params, cfg, h, segment=si), labels)
            metrics[f"ce_ramp{ri}"] = ce
            ramp_ce = ramp_ce + ce
        loss = loss + ramp_loss_weight * ramp_ce / len(ramps)
    for k, v in aux.items():
        metrics[k] = v
        loss = loss + v
    metrics["loss"] = loss
    return loss, metrics


def prefill(params, cfg: ModelConfig, batch: dict, cache_len: int, *,
            use_flash: bool = False, use_ssd_kernel: bool = False):
    """Serving prefill over whole prompts: returns (last_logits (B,V),
    caches, node_losses (B, n_nodes), next_pos (B,)).  ``caches`` holds
    per segment the decode caches `cache_specs` describes (ring KV
    caches, SSM state), stacked over the segment's layers; n_nodes =
    ramps + final (the final head is the last node).  ``use_flash`` runs
    every layer's attention through the flash-attention kernel,
    ``use_ssd_kernel`` every SSM layer's chunks through the ssd-chunk
    kernel."""
    x, positions = _embed_inputs(params, cfg, batch)
    node_losses, caches = [], []
    for si, seg in enumerate(cfg.segments):
        p_seg = params["segments"][si]["blocks"]
        rings = []
        for li in range(seg.n_layers):
            x, entry, _ = blocks.block_forward(
                layer(p_seg, li), x, positions, seg.block, cfg.norm_eps,
                use_flash, use_ssd_kernel)
            rings.append(blocks.build_ring_cache(entry, positions,
                                                 cache_len))
        caches.append(_stack_layers(rings))
        x = constrain_batch(x)
        if seg.ramp:
            node_losses.append(
                ramp_readout(params, cfg, x[:, -1, :], segment=si)[1])
    logits, final_loss = ramp_readout(params, cfg, x[:, -1, :])
    node_losses.append(final_loss)
    return (logits, caches, torch.stack(node_losses, dim=1),
            positions[:, -1] + 1)


def decode_segment(params, cfg: ModelConfig, si: int, x: torch.Tensor,
                   cache_seg, pos: torch.Tensor, paged=None,
                   write_mask=None):
    """Run segment ``si`` for one token against its decode caches (ring
    KV or, with ``paged``, the paged pool; SSM state per lane), written
    in place.  ``write_mask`` (B,) keeps the masked-out lanes' SSM state
    and, on the paged pool, sends their K/V to the garbage page.  x
    (B,1,D) -> (x', cache_seg, readout) where readout is None for
    ramp-less segments and otherwise the `ramp_readout` pair (logits
    (B,V), loss proxy (B,))."""
    seg = cfg.segments[si]
    p_seg = params["segments"][si]["blocks"]
    for li in range(seg.n_layers):
        x, _ = blocks.block_decode(layer(p_seg, li), x, layer(cache_seg, li),
                                   pos, seg.block, cfg.norm_eps,
                                   paged=paged, write_mask=write_mask)
    x = constrain_batch(x)
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
    return constrain_batch(x), cache_seg


def decode_step(params, cfg: ModelConfig, batch: dict, caches, pos):
    """Full-depth one-token step on the ring caches (updated in place;
    no early exit).  batch: {"tokens": (B,)}, or {"embeds": (B, D)} for
    an embeds-input model.  Returns (logits (B,V), caches, node_losses
    (B, n_nodes))."""
    if cfg.input_mode in ("tokens", "multimodal"):
        x = embed_rows(params["embed"]["table"],
                       batch["tokens"].long())[:, None, :]
    else:
        x = batch["embeds"][:, None, :]
    x = constrain_batch(x)
    node_losses = []
    for si in range(len(cfg.segments)):
        x, _, ro = decode_segment(params, cfg, si, x, caches[si], pos)
        if ro is not None:
            node_losses.append(ro[1])
    logits, final_loss = ramp_readout(params, cfg, x[:, 0, :])
    node_losses.append(final_loss)
    return logits, caches, torch.stack(node_losses, dim=1)


def _stack_specs(spec, n: int):
    if isinstance(spec, dict):
        return {k: _stack_specs(v, n) for k, v in spec.items()}
    shape, dtype = spec
    return (n,) + shape, dtype


def cache_specs(cfg: ModelConfig, batch: int, cache_len: int) -> list:
    """(shape, dtype) spec tree of the decode caches, per segment and
    stacked over its layers: ring ``k, v (L, B, cache_len, Hkv, hd)``,
    ``pos (L, B, cache_len)`` for attention (under `cache_int8` also
    ``k_s, v_s``); ``conv (L, B, d_conv-1, conv_dim)``, ``ssm (L, B, H,
    P, N)`` for SSM blocks; both for hybrid blocks."""
    return [_stack_specs(blocks.cache_defs(seg.block, cfg.d_model, batch,
                                           cache_len), seg.n_layers)
            for seg in cfg.segments]


def paged_cache_specs(cfg: ModelConfig, n_lanes: int, n_pages: int,
                      page_size: int) -> list:
    """(shape, dtype) spec tree of the paged decode cache, per segment
    and stacked over its layers: attention leaves swap the lane axis for
    the global page pool, ``k, v (L, P, page_size, Hkv, hd)``, ``pos (L,
    P, page_size)``, while SSM state (no sequence axis to page) stays
    lane-indexed, ``(L, n_lanes, ...)``.  Leaf names match
    `cache_specs`."""
    out = []
    for seg in cfg.segments:
        pooled = blocks.cache_defs(seg.block, cfg.d_model, n_pages,
                                   page_size)
        laned = blocks.cache_defs(seg.block, cfg.d_model, n_lanes, 1)
        entry = {}
        if "attn" in pooled:
            entry["attn"] = pooled["attn"]
        if "ssm" in laned:
            entry["ssm"] = laned["ssm"]
        out.append(_stack_specs(entry, seg.n_layers))
    return out
