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

Exited and unoccupied lanes never change their own cache: on the paged
pool they write their K/V to the garbage page (the decode path
redirects them); on the ring caches every lane writes its slot in
place and `_mask_lane_writes` puts back the slots of the lanes that
were not active; an SSM layer writes ``torch.where(active, new, old)``
into its lane-indexed conv/SSM state in both modes (the step passes the
active mask down as ``write_mask``).  So each lane's stream depends on
its own request alone.

`Engine` serves one fixed batch (prefill, then greedy decode on the
ring caches); `Classifier` serves the paper's classification setting
over the prefill.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.models import model as M
from repro_torch.models.attention import paged_kernel
from repro_torch.models.blocks import block_forward
from repro_torch.models.config import ModelConfig
from repro_torch.serving.kvpool.alloc import GARBAGE_PAGE
from repro_torch.strategy.base import reset_lanes

__all__ = ["Engine", "GenerationStats", "Classifier", "make_token_step",
           "bank_observe", "bank_serve", "fold_readout"]


def _check_online(strategy):
    if not getattr(strategy, "online", True):
        raise ValueError(
            f"{type(strategy).__name__} needs hindsight (online=False) and "
            "cannot drive the serving engine; use strategy.evaluate on "
            "offline traces instead")
    # the engine's aux channel carries predicted labels, not support
    # bins: a table strategy built without a Support would read them as
    # bins, so refuse it rather than serve garbage
    if hasattr(strategy, "support") and strategy.support is None:
        raise ValueError(
            f"{type(strategy).__name__} was built without a Support and "
            "reads bins from the aux channel; the engine supplies "
            "predictions there — construct it with the cascade's Support")
    return strategy


@dataclasses.dataclass
class GenerationStats:
    tokens: np.ndarray              # (B, T) generated tokens
    served_nodes: np.ndarray        # (B, T) which node served each token
    segments_run_batch: int         # segments actually launched (batch)
    segments_run_policy: int        # sum over lanes of nodes probed
    segments_full: int              # full-depth reference


def _ring_slots(cache_seg: dict, pos: torch.Tensor) -> dict:
    """Copies of what every layer's ring cache holds at each lane's
    write slot ``pos % C``: the bits a decode of this segment is about
    to overwrite (none for a segment without attention)."""
    if "attn" not in cache_seg:
        return {}
    attn = cache_seg["attn"]
    # every attention cache (GQA or MLA) has "pos" (L, B, C)
    slot = (pos % attn["pos"].shape[2]).long()
    bidx = torch.arange(pos.shape[0], device=pos.device)
    return {name: leaf[:, bidx, slot].clone() for name, leaf in attn.items()}


def _mask_lane_writes(cache_seg: dict, saved: dict, pos: torch.Tensor,
                      active: torch.Tensor, probe=None) -> None:
    """Keep inactive lanes' ring-cache bits: put back, in place, the
    slots `_ring_slots` saved for the lanes that are not ``active``.
    (On the paged pool the decode already redirected masked lanes'
    writes to the garbage page, and SSM state is masked by the decode's
    ``write_mask`` in both modes, so there is nothing to do for them.)
    A ``probe`` counts and times the gate and each boolean index, each
    a read of the mask's count."""
    if not saved:
        return
    flag = bool if probe is None else probe.flag
    keep = ~active
    if not flag(keep.any()):                          # host sync
        return
    attn = cache_seg["attn"]
    if probe is not None:
        probe.enter("sync", "tt.sync")
    slot = (pos % attn["pos"].shape[2]).long()[keep]
    bidx = torch.nonzero(keep)[:, 0]
    for name, leaf in attn.items():
        leaf[:, bidx, slot] = saved[name][:, keep]
    if probe is not None:
        probe.leave(reads=2 + len(attn))


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
                    carry_state: bool = False, paged: bool = False,
                    paged_kernel_on: bool = False, prefill_slots: int = 0,
                    node_offset: int = 0, walk_io: bool = False,
                    resume_walk: bool = False):
    """Build the one-token segment sweep shared by `Engine.generate` and
    the continuous-batching runtime.

    Args:
      strategies: a tuple bank of online strategies; the per-lane
        ``sid`` (B,) int32 argument picks each lane's member.  The
        Engine passes a one-member bank.
      carry_state: runtime mode — the step takes the bank's per-lane
        states after ``kv`` and returns them updated; every occupied
        lane's state is re-initialized at its token boundary
        (`strategy.base.reset_lanes`), except for strategies that set
        ``persistent = True``, whose state lives across a request's
        tokens and is reset only at admission.  Off (the Engine), every
        token starts from fresh states.
      paged: the caches are the paged KV pool and the step takes a
        `models.attention.PagedKV` handle as ``kv``; off, they are the
        per-lane ring caches and ``kv`` is None.
      paged_kernel_on: run the paged decode and the prefill chunk
        through the CUDA kernels (plain PyTorch on CPU tensors) instead
        of the page-table gather.
      prefill_slots: > 0 (paged mode only) adds CHUNKED PREFILL
        co-scheduled with decode: the step takes a
        `models.attention.PrefillChunk` of up to ``prefill_slots``
        prompt tokens per admitting lane, the admitting lanes packed
        into its rows (``chunk.lane``), and runs its full-depth sweep
        against the same pool.  Lanes whose chunk finishes the prompt
        (``chunk.emit``, in lane space) get their first token (argmax of
        the final-position head logits) in ``next_tok``.
      node_offset: global id of this model's FIRST node.  The
        multi-model cascade (`serving.cascade`) builds one step per
        ladder model over ONE combined strategy bank, so model m's
        ramps and head fold under the global ids [offset, offset +
        n_m).  0 is the single-model case.
      walk_io: the step also takes a ``walk`` pair ``(active (B,) bool,
        best (B, vocab) f32)`` and returns the updated pair after its
        other outputs: the escalation handoff.  A lane still active
        after this model's head wants a deeper ladder model; its walk
        and its best-so-far logits go to that model's step, so the walk
        across models serves what one walk over the joined line would.
      resume_walk: (needs carry_state and walk_io) the step continues
        walks begun on an earlier ladder model: the bank states arrive
        already folded and are not reset at the token boundary.
        Persistent strategies are refused: their cross-token state
        cannot also carry a mid-token handoff.

    Returns ``step(tok (B,) i32, caches, pos (B,) i32, occupied (B,)
    bool, sid (B,) i32, kv=None, states=None, chunk=None, walk=None,
    probe=None, run_chunk=None) -> (next_tok, caches, served_node,
    seg_batch, seg_policy[, states][, walk])``; the caches are updated
    in place, and seg_* are int32 device scalars counting this token's
    launched segments and per-lane probes.  A
    `serving.obs.probe.StepProbe` (``probe``) counts and times the
    step's gate reads and marks its segments, folds, head and chunk for
    the profiler.  The step's ``chunk_pass(caches, page_table, chunk)
    -> t0 (B,) i32`` attribute is the prefill chunk's pass, which the
    step runs eagerly, before the decode; ``run_chunk``, called with the
    same arguments, begins it in its place and returns a function that
    gives ``t0`` once the decode is queued (the stepper's CUDA graph of
    it, replayed on a stream of its own, `serving.runtime.chunk_graph`).
    """
    strategies = tuple(_check_online(s) for s in strategies)
    if prefill_slots and not paged:
        raise ValueError("prefill_slots needs the paged KV pool "
                         "(chunks are committed page by page)")
    if resume_walk:
        if not (carry_state and walk_io):
            raise ValueError("resume_walk continues a handed-off walk; "
                             "it needs carry_state and walk_io")
        for s in strategies:
            if getattr(s, "persistent", False):
                raise ValueError(
                    f"{type(s).__name__} is persistent — its cross-token "
                    "state cannot double as a mid-token walk handoff")
    embed = params["embed"]["table"]

    def chunk_pass(caches, page_table, chunk):
        """The prefill chunk at full depth against the pool (written in
        place), then the head's argmax at each row's last chunk token:
        the first token of the lanes whose chunk ends their prompt, in
        lane space ``(B_lanes,)``.  The chunk's rows are the lanes of
        ``chunk.lane`` (`models.attention.PrefillChunk`): each reads its
        lane's row of ``page_table`` (B_lanes, maxp); an idle row, mapped
        past the last lane, reads garbage pages only and leaves its token
        in a sink row.  Every shape is the chunk's ``(rows,
        prefill_slots)`` or the lanes', and nothing reads the device's
        values back on the host."""
        n_lanes = page_table.shape[0]
        lane = chunk.lane.long()
        with paged_kernel(paged_kernel_on):
            sink = torch.full_like(page_table[:1], GARBAGE_PAGE)
            table = torch.cat([page_table, sink])[lane]
            xc = embed[chunk.tok.long()]
            for si in range(len(cfg.segments)):
                xc, _ = M.prefill_chunk_segment(params, cfg, si, xc,
                                                caches[si], table, chunk)
            rows = torch.arange(xc.shape[0], device=xc.device)
            h = xc[rows, chunk.last_idx.long()]
            logits, _ = M.ramp_readout(params, cfg, h)
            t0 = torch.zeros((n_lanes + 1,), dtype=torch.int32,
                             device=xc.device)
            t0[lane] = torch.argmax(logits, dim=-1).to(torch.int32)
            return t0[:n_lanes]

    def eager_chunk(caches, page_table, chunk):
        t0 = chunk_pass(caches, page_table, chunk)
        return lambda: t0

    def step(tok, caches, pos, occupied, sid, kv=None, states_in=None,
             chunk=None, walk=None, probe=None, run_chunk=None):
        flag = bool if probe is None else probe.flag
        finish_chunk = None
        if prefill_slots and flag(chunk.active.any()):   # host sync
            # the chunk's lanes are not decoding: it reads and writes
            # other pages than the decode (and the garbage page, at
            # position -1), so it goes first and may run beside it
            if probe is not None:
                probe.push("tt.chunk")
            finish_chunk = (run_chunk or eager_chunk)(caches, kv.page_table,
                                                      chunk)
            if probe is not None:
                probe.pop()
        b = tok.shape[0]
        dev = tok.device
        x = embed[tok.long()][:, None, :]
        if resume_walk:
            # mid-token continuation: the earlier ladder model's step
            # already reset and folded these states for this token
            states = tuple(states_in)
        elif carry_state:
            states = tuple(
                st if getattr(s, "persistent", False)
                else reset_lanes(s, st, occupied)
                for s, st in zip(strategies, states_in))
        else:
            states = tuple(s.init(b) for s in strategies)
        active = occupied
        best = torch.zeros((b, cfg.vocab), dtype=torch.float32, device=dev)
        if walk_io:
            # escalation handoff in: each lane's walk activity and its
            # best-served-so-far logits from the previous ladder model
            walk_active, best = walk
            active = occupied & walk_active
        seg_batch = torch.zeros((), dtype=torch.int32, device=dev)
        seg_policy = torch.zeros((), dtype=torch.int32, device=dev)
        node = node_offset
        with paged_kernel(paged_kernel_on):
            for si, seg in enumerate(cfg.segments):
                any_active = flag(active.any())      # host sync
                seg_batch += int(any_active)
                seg_policy += active.sum(dtype=torch.int32)
                if any_active:
                    if probe is not None:
                        probe.push("tt.segment")
                    if paged:
                        x, _, ro = M.decode_segment(
                            params, cfg, si, x, caches[si], pos, paged=kv,
                            write_mask=active)
                    else:
                        saved = _ring_slots(caches[si], pos)
                        x, _, ro = M.decode_segment(params, cfg, si, x,
                                                    caches[si], pos,
                                                    write_mask=active)
                        _mask_lane_writes(caches[si], saved, pos, active,
                                          probe)
                    if probe is not None:
                        probe.pop()
                    if ro is not None:
                        if probe is not None:
                            probe.push("tt.fold")
                        states, active, best = fold_readout(
                            strategies, states, node, *ro, active, sid,
                            best)
                        if probe is not None:
                            probe.pop()
                if seg.ramp:
                    node += 1
            if flag(active.any()):                   # host sync
                if probe is not None:
                    probe.push("tt.head")
                logits, ell = M.ramp_readout(params, cfg, x[:, 0, :])
                if probe is not None:
                    probe.pop()
                    probe.push("tt.fold")
                states, active, best = fold_readout(
                    strategies, states, node, logits, ell, active, sid,
                    best)
                if probe is not None:
                    probe.pop()
            next_tok = torch.argmax(best, dim=-1).to(torch.int32)
            if finish_chunk is not None:
                # finishing lanes: seed the lane with its first token
                next_tok = torch.where(chunk.emit, finish_chunk(),
                                       next_tok)

        served = bank_serve(strategies, states, sid)
        out = (next_tok, caches, served, seg_batch, seg_policy)
        if carry_state:
            out = out + (states,)
        if walk_io:
            # handoff out: a lane still active after the head wants a
            # node past this model's rung
            out = out + ((active, best),)
        return out

    step.chunk_pass = chunk_pass
    return step


class Engine:
    """Batched greedy-decode engine with per-token early exit, on the
    ring caches (SSM state for SSM layers).  ``use_flash`` runs the
    prefill's attention through the flash-attention kernel,
    ``use_ssd_kernel`` its SSD chunks through the ssd-chunk kernel."""

    def __init__(self, params, cfg: ModelConfig, strategy, cache_len: int,
                 use_flash: bool = False, use_ssd_kernel: bool = False):
        self.params = params
        self.cfg = cfg
        self.strategy = _check_online(strategy)
        self.cache_len = cache_len
        self.use_flash = bool(use_flash)
        self.use_ssd_kernel = bool(use_ssd_kernel)
        self._step = make_token_step(params, cfg, (self.strategy,))

    def prefill(self, batch: dict):
        return M.prefill(self.params, self.cfg, batch, self.cache_len,
                         use_flash=self.use_flash,
                         use_ssd_kernel=self.use_ssd_kernel)

    def generate(self, batch: dict, n_tokens: int) -> GenerationStats:
        cfg = self.cfg
        logits, caches, _, pos = self.prefill(batch)
        b = logits.shape[0]
        dev = logits.device
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        occupied = torch.ones((b,), dtype=torch.bool, device=dev)
        sid = torch.zeros((b,), dtype=torch.int32, device=dev)
        out_tokens, out_nodes = [], []
        seg_batch = seg_policy = 0
        for _ in range(n_tokens):
            tok, caches, served, sb, sp = self._step(tok, caches, pos,
                                                     occupied, sid)
            out_tokens.append(tok.cpu().numpy())
            out_nodes.append(served.cpu().numpy())
            seg_batch += int(sb)
            seg_policy += int(sp)
            pos = pos + 1
        return GenerationStats(
            tokens=np.stack(out_tokens, 1),
            served_nodes=np.stack(out_nodes, 1),
            segments_run_batch=seg_batch,
            segments_run_policy=seg_policy,
            segments_full=n_tokens * len(cfg.segments) * b,
        )


class Classifier:
    """Classification-mode serving — the paper's §6 experimental setting.

    One request = one input sequence; the prediction is read at the last
    position of a ramp (no decode loop).  The engine runs segment by
    segment over the prefill, consulting the strategy after each ramp,
    and serves whatever node ``strategy.serve`` designates.
    """

    def __init__(self, params, cfg: ModelConfig, strategy):
        self.params = params
        self.cfg = cfg
        self.strategy = _check_online(strategy)

    def classify(self, batch: dict) -> dict:
        cfg = self.cfg
        params = self.params
        strategy = self.strategy
        x, positions = M._embed_inputs(params, cfg, batch)
        b = x.shape[0]
        state = strategy.init(b)
        active = torch.ones((b,), dtype=torch.bool, device=x.device)
        best = torch.zeros((b, cfg.vocab), dtype=torch.float32,
                           device=x.device)
        node = 0
        seg_run = seg_policy = 0
        n_seg = len(cfg.segments)
        for si, seg in enumerate(cfg.segments):
            if not bool(active.any()):
                break
            p_seg = params["segments"][si]["blocks"]
            for li in range(seg.n_layers):
                x, _, _ = block_forward(M.layer(p_seg, li), x, positions,
                                        seg.block, cfg.norm_eps)
            seg_run += 1
            seg_policy += int(active.sum())
            if seg.ramp:
                # the engine's shared fold: observe, then refresh best
                # logits for lanes whose SERVED node is this ramp
                logits, loss = M.ramp_readout(params, cfg, x[:, -1, :],
                                              segment=si)
                (state,), active, best = fold_readout(
                    (strategy,), (state,), node, logits, loss, active,
                    None, best)
                node += 1
        if bool(active.any()):
            logits, loss = M.ramp_readout(params, cfg, x[:, -1, :])
            (state,), active, best = fold_readout(
                (strategy,), (state,), node, logits, loss, active, None,
                best)
        return {
            "labels": torch.argmax(best, dim=-1).cpu().numpy(),
            "served_node": strategy.serve(state).cpu().numpy(),
            "segments_run_batch": seg_run,
            "segments_run_policy": seg_policy,
            "segments_full": n_seg * b,
        }
