"""Segment-wise token step with T-Tamer early exit.

A decode step runs SEGMENT BY SEGMENT.  After every ramp segment it
computes each lane's loss proxy ell = 1 - confidence, hands it to the
pluggable strategy bank (``observe`` returns the lanes continuing
deeper), and keeps, per lane, the logits of whatever node ``serve``
designates.  The step holds no policy logic of its own.

Against the JAX package: each ``lax.cond(active.any(), ...)`` that
gates a segment there becomes a host-side ``if`` here, so the step
syncs with the card once per segment (and once for the head and once
for the prefill chunk), where the JAX program syncs once per token.
The segment counters are kept as device tensors and read once, with
the emitted tokens, at the end of the step.

Exited and unoccupied lanes write their K/V to the pool's garbage page
(the decode path redirects them), so each lane's stream depends on its
own request alone.
"""

from __future__ import annotations

import torch

from repro_torch.models import model as M
from repro_torch.models.attention import paged_kernel
from repro_torch.models.config import ModelConfig
from repro_torch.strategy.base import reset_lanes

__all__ = ["make_token_step", "bank_observe", "bank_serve",
           "fold_readout"]


def _check_online(strategy):
    if not getattr(strategy, "online", True):
        raise ValueError(
            f"{type(strategy).__name__} needs hindsight (online=False) and "
            "cannot drive the serving engine")
    return strategy


def bank_observe(strategies, states, node, losses, preds, active, sid):
    """Fold one node into every bank member's state; lanes only follow
    their own member's continue/stop verdict (``sid`` selects)."""
    new_states, conts = [], []
    for k, strat in enumerate(strategies):
        mask = active if len(strategies) == 1 else active & (sid == k)
        st, cont = strat.observe(states[k], node, losses, mask, aux=preds)
        new_states.append(st)
        conts.append(cont)
    if len(strategies) == 1:
        return tuple(new_states), conts[0]
    out = torch.zeros_like(active)
    for k, cont in enumerate(conts):
        out = torch.where(sid == k, cont, out)
    return tuple(new_states), out


def bank_serve(strategies, states, sid):
    served = strategies[0].serve(states[0]).to(torch.int32)
    for k in range(1, len(strategies)):
        served = torch.where(sid == k,
                             strategies[k].serve(states[k]).to(torch.int32),
                             served)
    return served


def fold_readout(strategies, states, node, logits, ell, active, sid, best):
    """Fold one ramp/head readout into the bank: observe the loss proxy,
    then refresh ``best`` with this node's logits for exactly the lanes
    whose SERVED node is this one.  Returns (states, active, best)."""
    preds = torch.argmax(logits, dim=-1).to(torch.int32)
    states, active = bank_observe(strategies, states, node, ell, preds,
                                  active, sid)
    take = bank_serve(strategies, states, sid) == node
    best = torch.where(take[:, None], logits.float(), best)
    return states, active, best


def make_token_step(params, cfg: ModelConfig, strategies, *,
                    paged_kernel_on: bool = False, prefill_slots: int = 0):
    """Build the one-token segment sweep of the continuous-batching
    runtime, on the paged KV pool, with the strategy bank's per-lane
    states carried across steps.

    Args:
      strategies: a tuple bank of online strategies; the per-lane
        ``sid`` (B,) int32 argument picks each lane's member.  Every
        occupied lane's state is re-initialized at its token boundary
        (`strategy.base.reset_lanes`).
      paged_kernel_on: run the paged decode and the prefill chunk
        through the CUDA kernels (plain PyTorch on CPU tensors) instead
        of the page-table gather.
      prefill_slots: > 0 adds CHUNKED PREFILL co-scheduled with decode:
        the step takes a `models.attention.PrefillChunk` of up to
        ``prefill_slots`` prompt tokens per admitting lane and runs its
        full-depth sweep against the same pool.  Lanes whose chunk
        finishes the prompt (``chunk.emit``) get their first token
        (argmax of the final-position head logits) in ``next_tok``.

    Returns ``step(tok (B,) i32, caches, pos (B,) i32, occupied (B,)
    bool, sid (B,) i32, kv, states[, chunk]) -> (next_tok, caches,
    served_node, seg_batch, seg_policy, states)``; the pool in
    ``caches`` is updated in place, and seg_* are int32 device scalars
    counting this token's launched segments and per-lane probes.
    """
    strategies = tuple(_check_online(s) for s in strategies)
    embed = params["embed"]["table"]

    def step(tok, caches, pos, occupied, sid, kv, states_in, chunk=None):
        b = tok.shape[0]
        dev = tok.device
        x = embed[tok.long()][:, None, :]
        states = tuple(reset_lanes(s, st, occupied)
                       for s, st in zip(strategies, states_in))
        active = occupied
        best = torch.zeros((b, cfg.vocab), dtype=torch.float32, device=dev)
        seg_batch = torch.zeros((), dtype=torch.int32, device=dev)
        seg_policy = torch.zeros((), dtype=torch.int32, device=dev)
        node = 0
        with paged_kernel(paged_kernel_on):
            for si, seg in enumerate(cfg.segments):
                any_active = bool(active.any())      # host sync
                seg_batch += int(any_active)
                seg_policy += active.sum(dtype=torch.int32)
                if any_active:
                    x, _, ro = M.decode_segment(params, cfg, si, x,
                                                caches[si], pos, paged=kv,
                                                write_mask=active)
                    if ro is not None:
                        states, active, best = fold_readout(
                            strategies, states, node, *ro, active, sid,
                            best)
                if seg.ramp:
                    node += 1
            if bool(active.any()):                   # host sync
                logits, ell = M.ramp_readout(params, cfg, x[:, 0, :])
                states, active, best = fold_readout(
                    strategies, states, node, logits, ell, active, sid,
                    best)
            next_tok = torch.argmax(best, dim=-1).to(torch.int32)

            if prefill_slots and bool(chunk.active.any()):   # host sync
                xc = embed[chunk.tok.long()]
                for si in range(len(cfg.segments)):
                    xc, _ = M.prefill_chunk_segment(
                        params, cfg, si, xc, caches[si], kv.page_table,
                        chunk)
                h = xc[torch.arange(b, device=dev), chunk.last_idx.long()]
                logits, _ = M.ramp_readout(params, cfg, h)
                t0 = torch.argmax(logits, dim=-1).to(torch.int32)
                # finishing lanes: seed the lane with its first token
                next_tok = torch.where(chunk.emit, t0, next_tok)

        served = bank_serve(strategies, states, sid)
        return next_tok, caches, served, seg_batch, seg_policy, states

    return step
