"""Lane scheduling: fixed-width slots, immediate recycling, static
shapes, on per-lane ring caches or on the paged KV pool, with
stop-the-world or chunked prefill.

Three layers:

  * `LaneScheduler` — the pure allocator.  `n_lanes` slots; a lane is
    recycled the moment its request finishes (or its stream hits EOS);
    admission pops the `RequestQueue` into free lanes, gated by a
    ``can_admit`` callback (the pool's page-budget reservation: when the
    pool can't cover a request's worst case, the request STAYS QUEUED,
    head-of-line, instead of being dropped).

  * `EngineStepper` — the device state of the REAL model: the ring
    caches or the paged KV pool (SSM state per lane in either mode),
    current tokens, positions and the carried strategy-bank states.
    Stop-the-world admission prefills the whole prompt at batch 1 and
    scatters it into the lane's ring slot or its pages, and its SSM
    state into the lane's row; chunked admission (paged, attention
    only) allocates the prompt's pages and registers a prefill cursor.
    Each `step` first executes the pool's host-planned page ops
    (fresh-page position resets, copy-on-write splits), then runs
    decode for the decoding lanes AND, when chunked, a
    planner-budgeted prefill chunk for the admitting lanes through the
    shared `serving.engine.make_token_step`.  Caches are updated in
    place (``index_put_`` / indexed assignment), where the JAX package
    builds new ones each step.  On the card the chunk's pass is one CUDA
    graph a pool, recorded when the lane state is allocated and replayed
    by every chunk step beside the decode (`serving.runtime.chunk_graph`).

  * `ChunkPlanner` — the per-step token budget for those chunks, split
    fairly across prompt-length buckets.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import model as M
from repro_torch.models.attention import PagedKV, PrefillChunk
from repro_torch.serving.engine import make_token_step
from repro_torch.serving.kvpool import KVPool, PoolExhausted
from repro_torch.serving.runtime.chunk_graph import ChunkGraph, pool_key
from repro_torch.serving.runtime.request import Request, RequestQueue
from repro_torch.strategy.base import init_lane

__all__ = ["LaneScheduler", "ChunkPlanner", "EngineStepper",
           "check_chunkable"]


class LaneScheduler:
    """Fixed-width lane allocator with immediate recycling."""

    def __init__(self, n_lanes: int):
        if n_lanes < 1:
            raise ValueError("need at least one lane")
        self.n_lanes = int(n_lanes)
        self.lane_req: list[Request | None] = [None] * self.n_lanes
        self.remaining = np.zeros(self.n_lanes, np.int64)
        self.sid = np.zeros(self.n_lanes, np.int32)

    def occupied_mask(self) -> np.ndarray:
        return np.asarray([r is not None for r in self.lane_req])

    def busy(self) -> bool:
        return any(r is not None for r in self.lane_req)

    def free_lanes(self) -> list[int]:
        return [i for i, r in enumerate(self.lane_req) if r is None]

    def admit(self, queue: RequestQueue, sid_of, *,
              static_batching: bool = False,
              can_admit=None) -> list[tuple[int, Request]]:
        """Pop queued requests into free lanes; returns assignments.

        ``static_batching=True`` reproduces the fixed-batch
        `Engine.generate` discipline (the baseline): a new batch is
        admitted only once EVERY lane is free, so stragglers idle the
        whole width.

        ``can_admit(req)`` gates (and RESERVES resources for) each pop —
        the paged-KV page budget.  A False verdict stops admission at
        the queue head: the request waits, later arrivals wait behind it
        (deterministic head-of-line order; no starvation, no drops).
        """
        if static_batching and self.busy():
            return []
        out = []
        for lane in self.free_lanes():
            if not len(queue):
                break
            if can_admit is not None and not can_admit(queue.peek()):
                break
            req = queue.pop()
            self.lane_req[lane] = req
            self.remaining[lane] = req.max_tokens
            self.sid[lane] = sid_of(req)
            out.append((lane, req))
        return out

    def consume_token(self, lane: int) -> bool:
        """Account one emitted token; True when the budget is exhausted."""
        self.remaining[lane] -= 1
        return bool(self.remaining[lane] <= 0)

    def release(self, lane: int) -> Request:
        req = self.lane_req[lane]
        if req is None:
            raise ValueError(f"lane {lane} is already free")
        self.lane_req[lane] = None
        self.remaining[lane] = 0
        self.sid[lane] = 0
        return req


class ChunkPlanner:
    """Per-step prefill-chunk planning under a token budget with
    prompt-length-bucketed fairness (DESIGN.md §9).

    Each step, at most ``budget`` prompt tokens are spread over the
    lanes currently mid-prefill, every lane capped at ``chunk`` tokens
    (the device chunk width).  Lanes are grouped into power-of-two
    prompt-length BUCKETS (in units of ``chunk``) and the budget is
    split evenly across the nonempty buckets — a lane prefilling a
    4096-token prompt can take at most its bucket's share, so freshly
    admitted short prompts always find budget and reach their first
    token in O(1) steps instead of queueing behind the long prefill
    (and vice versa: the long prompt keeps its share no matter how many
    shorts arrive, so neither side starves).  Within a bucket a
    rotating round-robin pointer decides who goes first; the
    budget-split remainder rotates across buckets.  Unused share flows
    to the next bucket, then tops up any lane still under its cap —
    the budget is never wasted while work remains.

    Used by both the real `EngineStepper` and the virtual-clock
    `SimStepper`, so the sim sweeps exercise the exact admission
    discipline the engine serves with.
    """

    def __init__(self, chunk: int, budget: int | None = None):
        if chunk < 1:
            raise ValueError("chunk must be >= 1")
        self.chunk = int(chunk)
        self.budget = int(budget) if budget is not None else self.chunk
        if self.budget < 1:
            raise ValueError("budget must be >= 1")
        self._rr = 0

    def bucket(self, prompt_len: int) -> int:
        """Power-of-two bucket index: 0 for prompts up to one chunk,
        then doubling (chunk, 2*chunk] -> 1, (2c, 4c] -> 2, ..."""
        return max(0, -(-int(prompt_len) // self.chunk) - 1).bit_length()

    def plan(self, lanes: dict) -> dict:
        """``lanes``: lane -> (remaining_tokens, prompt_len).  Returns
        lane -> tokens to prefill this step (each in [1, chunk], total
        <= budget)."""
        if not lanes:
            return {}
        buckets: dict[int, list[int]] = {}
        for lane in sorted(lanes):
            buckets.setdefault(self.bucket(lanes[lane][1]), []).append(lane)
        keys = sorted(buckets)
        base, rem = divmod(self.budget, len(keys))
        rem_at = self._rr % len(keys)

        def rotated(seq):
            off = self._rr % len(seq)
            return seq[off:] + seq[:off]

        out: dict[int, int] = {}
        leftover = 0
        for i, bk in enumerate(keys):
            share = base + (rem if i == rem_at else 0) + leftover
            for lane in rotated(buckets[bk]):
                w = min(self.chunk, lanes[lane][0], share)
                if w > 0:
                    out[lane] = w
                    share -= w
            leftover = share
        if leftover > 0:       # top-up pass: no budget left stranded
            for lane in rotated(sorted(lanes)):
                got = out.get(lane, 0)
                add = min(self.chunk - got, lanes[lane][0] - got, leftover)
                if add > 0:
                    out[lane] = got + add
                    leftover -= add
                if leftover == 0:
                    break
        self._rr += 1
        return out



def check_chunkable(cfg, kv: str) -> None:
    """Raise ValueError (the JAX package's message) unless chunked
    prefill can serve ``cfg`` on ``kv``: chunks commit into the paged
    pool, and only GQA attention segments have a prefill chunk (SSM and
    hybrid state is sequential over the prompt; MLA has none)."""
    if kv != "paged":
        raise ValueError("chunked prefill needs --kv paged "
                         "(chunks commit into the page pool)")
    for seg in cfg.segments:
        if seg.block.mixer != "attn" or seg.block.attn.mla is not None:
            raise ValueError(
                "chunked prefill currently supports GQA "
                "attention segments only (SSM state is "
                "sequential over the prompt; MLA chunking is a "
                "ROADMAP item) — drop --prefill-chunk for "
                f"mixer {seg.block.mixer!r}")


def _materialize_cache(spec, device, key=None):
    """Zero-filled caches from a `models.model.cache_specs` or
    `paged_cache_specs` tree (``pos`` buffers start at -1 == empty
    slot)."""
    if isinstance(spec, dict):
        return {k: _materialize_cache(v, device, k) for k, v in spec.items()}
    shape, dtype = spec
    if key == "pos":
        return torch.full(shape, -1, dtype=dtype, device=device)
    return torch.zeros(shape, dtype=dtype, device=device)


class EngineStepper:
    """Real-model lane state: ring caches or the paged pool + the shared
    token step.

    ``node_offset``, ``walk_io`` and ``resume_walk`` go to the token
    step (`serving.engine.make_token_step`): the multi-model cascade
    builds one stepper per ladder rung over one strategy bank.
    ``max_lane_pages`` and ``model_key`` go to the paged pool (a lane's
    page cap for `KVPool.grow`, and the key that keeps two rungs'
    prefix caches apart).

    A chunked stepper whose weights are on a CUDA device replays its
    chunk pass as a CUDA graph (`serving.runtime.chunk_graph`): `alloc`
    records it on the new pool, before any serve's clock starts, and a
    chunk step whose pool is not the graph's records it again.
    ``chunk_stats`` then also counts ``chunk_graph_replays`` and
    ``chunk_graph_captures``, and with a probe every step adds both to
    its turn's record.  Elsewhere the pass runs eagerly."""

    virtual_time = False
    emits_tokens = True    # `emitted` really is token ids (EOS applies)
    # the server installs a `SpanTracer` here when one is attached: each
    # prefill chunk lands as an event, from host values only; and with
    # it a `serving.obs.probe.StepProbe`, which times the step's parts
    # and counts and times its transfers
    tracer = None
    probe = None

    def __init__(self, params, cfg, strategies: tuple, *, n_lanes: int,
                 cache_len: int, prompt_len: int, kv: str = "ring",
                 page_size: int = 16, n_pages: int | None = None,
                 paged_kernel: bool = False,
                 prefill_chunk: int | None = None,
                 prefill_budget: int | None = None,
                 use_flash: bool = False, use_ssd_kernel: bool = False,
                 node_offset: int = 0, walk_io: bool = False,
                 resume_walk: bool = False,
                 max_lane_pages: int | None = None,
                 model_key: str | None = None):
        if kv not in ("ring", "paged"):
            raise ValueError(f"unknown kv mode {kv!r} (ring|paged)")
        prefill_chunk = prefill_chunk or None      # 0 == disabled
        if prefill_chunk is not None:
            check_chunkable(cfg, kv)
        self.params = params
        self.cfg = cfg
        self.device = params["embed"]["table"].device
        self.strategies = strategies
        self.n_lanes = int(n_lanes)
        self.cache_len = int(cache_len)
        self.prompt_len = int(prompt_len)
        self.full_depth = len(cfg.segments)
        self.kv = kv
        self.use_flash = bool(use_flash)
        self.use_ssd_kernel = bool(use_ssd_kernel)
        self.prefill_chunk = None if prefill_chunk is None \
            else int(prefill_chunk)
        self.planner = None if prefill_chunk is None else ChunkPlanner(
            self.prefill_chunk, prefill_budget)
        self.walk_io = bool(walk_io)
        self._chunk_graphed = (self.prefill_chunk is not None
                               and self.device.type == "cuda")
        self._chunk_graph = None
        self._step = make_token_step(params, cfg, strategies,
                                     carry_state=True,
                                     paged=(kv == "paged"),
                                     paged_kernel_on=paged_kernel,
                                     prefill_slots=self.prefill_chunk or 0,
                                     node_offset=node_offset,
                                     walk_io=self.walk_io,
                                     resume_walk=resume_walk)
        self.pool = None
        if kv == "paged":
            self.pool = KVPool(n_lanes=self.n_lanes, page_size=page_size,
                               lane_pages=-(-self.cache_len // page_size),
                               n_pages=n_pages,
                               max_lane_pages=max_lane_pages,
                               model_key=model_key)
        self._new_lane_state()

    def _dev(self, a, dtype=torch.int32) -> torch.Tensor:
        probe = self.probe
        if probe is not None:
            probe.enter("sync", "tt.sync")
        t = torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)
        if probe is not None:
            probe.leave(uploads=1, nbytes=t.numel() * t.element_size())
        return t

    def _unset(self, pos: torch.Tensor, pages: torch.Tensor) -> None:
        """``pos[:, pages] = -1`` in place.  On the card the -1 crosses
        in a blocking copy of its own: the probe counts it an upload."""
        probe = self.probe
        if probe is not None:
            probe.enter("sync", "tt.sync")
        pos[:, pages] = -1
        if probe is not None:
            probe.leave(uploads=1, nbytes=pos.element_size())

    # ---- paged device ops (in place) ------------------------------------

    def _reset_pages(self, pages: torch.Tensor) -> None:
        """Gate the stale bytes of freshly allocated pages before a
        chunked admission writes into them: pos[:, pages] = -1 in every
        layer.  ``pages`` is garbage-padded (the sink's positions are -1
        by construction, so resetting it again changes nothing)."""
        for seg_c in self.caches:
            if "attn" in seg_c:
                self._unset(seg_c["attn"]["pos"], pages.long())

    def _paged_prep(self, fresh, cow_src, cow_dst) -> None:
        """Pre-step page ops: COW page copies (src -> dst in every layer;
        the right-hand side is gathered before any write lands) and
        fresh-page position resets.  Idle entries are garbage-page pairs
        (0 -> 0), which copy the sink onto itself."""
        src, dst = cow_src.long(), cow_dst.long()
        for seg_c in self.caches:
            if "attn" not in seg_c:
                continue
            attn = seg_c["attn"]
            for leaf in attn.values():
                leaf[:, dst] = leaf[:, src]
            self._unset(attn["pos"], fresh.long())

    # ---- lane state ------------------------------------------------------

    def alloc(self) -> None:
        """(Re)build empty lane state: empty caches, fresh bank states;
        and record the chunk pass's graph on the new pool, where the
        stepper graphs it."""
        self._new_lane_state()
        if self._chunk_graphed:
            self._chunk_graph_ready(self.caches)

    def _new_lane_state(self) -> None:
        # the old graph holds the old pool: both go before the new pool
        self._chunk_graph = None
        if self.pool is not None:
            self.pool.reset()
            specs = M.paged_cache_specs(self.cfg, self.n_lanes,
                                        self.pool.n_pages,
                                        self.pool.page_size)
        else:
            specs = M.cache_specs(self.cfg, self.n_lanes, self.cache_len)
        self.caches = [_materialize_cache(s, self.device) for s in specs]
        self.tok = torch.zeros((self.n_lanes,), dtype=torch.int32,
                               device=self.device)
        self.pos = torch.zeros((self.n_lanes,), dtype=torch.int32,
                               device=self.device)
        self.states = tuple(s.init(self.n_lanes) for s in self.strategies)
        # chunked-prefill lane state: lane -> {prompt, plan, cursor, lp}
        self._prefilling = {}
        self._idle_chunk = None
        self.chunk_stats = {"tokens_computed": 0, "tokens_skipped": 0,
                            "chunk_steps": 0, "prefills": 0}
        if self._chunk_graphed:
            self.chunk_stats.update(chunk_graph_replays=0,
                                    chunk_graph_captures=0)

    def _chunk_graph_ready(self, caches) -> int:
        """Record the chunk pass's graph on ``caches`` unless the graph
        held was recorded on them; returns the recordings made (0 or
        1)."""
        graph = self._chunk_graph
        if graph is not None and graph.key == pool_key(caches):
            return 0
        graph = self._chunk_graph = None       # its memory goes first
        self._chunk_graph = ChunkGraph(
            self._step.chunk_pass, caches, self.n_lanes,
            self.prefill_chunk, self.pool.table.shape[1], self.device)
        self.chunk_stats["chunk_graph_captures"] += 1
        return 1

    def _replay_chunk(self, caches, page_table, chunk):
        """The token step's chunk pass on the card (its ``run_chunk``):
        the pool's graph replayed on ``chunk``, beside the decode."""
        captured = self._chunk_graph_ready(caches)
        finish = self._chunk_graph.run(page_table, chunk)
        self.chunk_stats["chunk_graph_replays"] += 1
        if self.probe is not None:
            self.probe.count(chunk_graph_replays=1,
                             chunk_graph_captures=captured)
        return finish

    def reserve(self, req: Request) -> bool:
        """Admission gate (the scheduler's ``can_admit``): reserve the
        request's worst-case page need.  Ring mode has nothing to
        reserve — lane availability is the only constraint."""
        if self.pool is None:
            return True
        return self.pool.reserve(req.prompt, req.max_tokens)

    def release(self, lane: int) -> None:
        """Return the lane's pages to the pool (ring lanes have nothing
        to return) and drop any prefill cursor it still holds."""
        self._prefilling.pop(lane, None)
        if self.pool is not None:
            self.pool.release(lane)

    def _prefill_one(self, req: Request, cache_len: int):
        """Whole-prompt prefill at batch 1: (caches, first token (1,),
        next position (1,))."""
        prompt = self._dev(np.asarray(req.prompt, np.int32)[None, :])
        logits, pc, _, npos = M.prefill(self.params, self.cfg,
                                        {"tokens": prompt}, cache_len,
                                        use_flash=self.use_flash,
                                        use_ssd_kernel=self.use_ssd_kernel)
        return pc, torch.argmax(logits, dim=-1).to(torch.int32), \
            npos.to(torch.int32)

    @staticmethod
    def _scatter_lane(dst: dict, src: dict, lane: int) -> None:
        """Copy the leaves of a batch-1 cache tree into row ``lane`` of
        the lane-indexed tree ``dst`` (leaves ``(L, lanes, ...)``)."""
        for name, leaf in dst.items():
            leaf[:, lane] = src[name][:, 0].to(leaf.dtype)

    def _scatter_ring(self, lane: int, pc) -> None:
        """Copy a batch-1 prefill's ring caches and SSM state into the
        lane's slot."""
        for seg_c, one in zip(self.caches, pc):
            for key, tree in seg_c.items():
                self._scatter_lane(tree, one[key], lane)

    def _scatter_pages(self, lane: int, plan, pc) -> None:
        """Scatter a batch-1 prefill (ring length == prompt length, so
        slot t holds position t) into the admitted lane's pages: gate
        the stale bytes of the freshly allocated pages, then write each
        token to its (page, slot) target; prefix-shared tokens go to the
        garbage page at position -1.  SSM state goes to the lane's
        row."""
        dp = self._dev(plan.dest_page, torch.long)
        ds = self._dev(plan.dest_slot, torch.long)
        fresh = self._dev(plan.new_pages, torch.long)
        pos_vals = self._dev(plan.pos_vals)
        for seg_c, one in zip(self.caches, pc):
            if "ssm" in seg_c:
                self._scatter_lane(seg_c["ssm"], one["ssm"], lane)
            if "attn" not in seg_c:
                continue
            attn = seg_c["attn"]
            self._unset(attn["pos"], fresh)
            for name, leaf in attn.items():
                leaf[:, dp, ds] = pos_vals if name == "pos" \
                    else one["attn"][name][:, 0].to(leaf.dtype)

    def admit(self, lane: int, req: Request) -> None:
        """Admit the request into ``lane``.

        Stop-the-world (no ``prefill_chunk``): prefill the whole prompt
        at batch 1 and scatter it into the lane's ring slot or pages;
        every decode lane waits for it.  Chunked: allocate the prompt's
        pages now and defer the compute — the prompt is fed through the
        step ``prefill_chunk`` tokens at a time, co-scheduled with
        decode, and prefix-cache hits skip their already-cached
        chunks."""
        if self.prefill_chunk is None:
            if req.prompt.shape[0] != self.prompt_len:
                raise ValueError(
                    f"request {req.rid}: prompt length "
                    f"{req.prompt.shape[0]} != stepper bucket "
                    f"{self.prompt_len} (static shapes)")
            if self.pool is None:
                pc, t0, npos = self._prefill_one(req, self.cache_len)
                self._scatter_ring(lane, pc)
            else:
                plan = self.pool.admit(lane, req.prompt, req.max_tokens)
                pc, t0, npos = self._prefill_one(req, self.prompt_len)
                self._scatter_pages(lane, plan, pc)
            self.tok[lane] = t0[0]
            self.pos[lane] = npos[0]
            self.states = tuple(init_lane(s, st, lane) for s, st
                                in zip(self.strategies, self.states))
            return
        plan = self.pool.admit(lane, req.prompt, req.max_tokens,
                               register_prefix=False)
        self._reset_pages(self._dev(plan.new_pages))
        lp = int(req.prompt.shape[0])
        # full prefix hit still recomputes the final token: the
        # first-token logits need the last position's hidden state
        cursor = min(plan.n_shared_tokens, lp - 1)
        self.chunk_stats["tokens_skipped"] += cursor
        self.chunk_stats["prefills"] += 1
        self._prefilling[lane] = {
            "prompt": np.asarray(req.prompt, np.int32),
            "plan": plan, "cursor": cursor, "lp": lp, "rid": req.rid}
        # the recycled lane starts from fresh strategy state no matter
        # what its predecessor observed
        self.states = tuple(init_lane(s, st, lane)
                            for s, st in zip(self.strategies, self.states))

    def set_lane_token(self, lane: int, token: int) -> None:
        """Override a lane's next input token.  The cascade uses this
        after an escalation's catch-up prefill: the finishing chunk
        seeds its own head argmax, but the escalated stream's next
        input is the token the SOURCE model already emitted."""
        self.tok[lane] = int(token)

    def warmup(self) -> None:
        """Run one dummy request through prefill and a decode token
        before the serving clock starts (on the card this builds and
        loads the kernels), then reset all lane state."""
        dummy = Request(rid=-1, prompt=np.zeros(self.prompt_len, np.int32),
                        max_tokens=1)
        if not self.reserve(dummy):
            raise PoolExhausted(
                f"kv pool of {self.pool.n_pages} pages x "
                f"{self.pool.page_size} tokens cannot fit even one "
                f"{self.prompt_len}-token request — raise --pages or "
                "--page-size")
        self.admit(0, dummy)
        occ = np.zeros((self.n_lanes,), bool)
        occ[0] = True
        sid0 = np.zeros((self.n_lanes,), np.int32)
        for _ in range(2 * self.prompt_len + 2):
            if not self._prefilling:
                break
            self.step(occ, sid0)
        self.step(occ, sid0)
        self.alloc()

    def _build_chunk(self, widths: dict):
        """Turn the planner's lane -> width map into the device
        `PrefillChunk` (all idle when nothing is prefilling: position -1
        rows, garbage destinations).  Advances the per-lane cursors and
        returns the lanes whose prompt finishes with this chunk."""
        if not widths and self._idle_chunk is not None:
            return self._idle_chunk, []
        n, c = self.n_lanes, self.prefill_chunk
        tok = np.zeros((n, c), np.int32)
        pos = np.full((n, c), -1, np.int32)
        dp = np.zeros((n, c), np.int32)     # 0 == the garbage sink
        ds = np.zeros((n, c), np.int32)
        start = np.zeros(n, np.int32)
        last = np.zeros(n, np.int32)
        emit = np.zeros(n, bool)
        act = np.zeros(n, bool)
        finished = []
        for lane, w in widths.items():
            st = self._prefilling[lane]
            cur = st["cursor"]
            sl = slice(cur, cur + w)
            tok[lane, :w] = st["prompt"][sl]
            pos[lane, :w] = np.arange(cur, cur + w, dtype=np.int32)
            dp[lane, :w] = st["plan"].dest_page[sl]
            ds[lane, :w] = st["plan"].dest_slot[sl]
            start[lane] = cur
            last[lane] = w - 1
            act[lane] = True
            st["cursor"] = cur + w
            if st["cursor"] == st["lp"]:
                emit[lane] = True
                finished.append(lane)
            self.chunk_stats["tokens_computed"] += w
            if self.tracer is not None:
                self.tracer.emit(
                    "prefill_chunk", lane=int(lane),
                    rid=int(st.get("rid", -1)), width=int(w),
                    left=int(st["lp"] - st["cursor"]))
        chunk = PrefillChunk(
            tok=self._dev(tok), pos=self._dev(pos), dest_page=self._dev(dp),
            dest_slot=self._dev(ds), start=self._dev(start),
            last_idx=self._dev(last), emit=self._dev(emit, torch.bool),
            active=self._dev(act, torch.bool))
        if widths:
            self.chunk_stats["chunk_steps"] += 1
        else:
            self._idle_chunk = chunk
        return chunk, finished

    def step(self, occupied: np.ndarray, sid: np.ndarray, walk=None):
        """One step: a decode token for every occupied DECODING lane and
        a budgeted prefill chunk for the admitting lanes.

        Returns host-side ``(emitted (B,), served (B,), seg_batch,
        seg_policy, emit_mask (B,) bool)``; ``emit_mask`` marks the lanes
        whose ``emitted`` entry is a real token (lanes mid-prefill emit
        nothing).

        ``walk_io`` steppers (the cascade's rungs) also take an optional
        ``walk`` handoff pair ``(active (B,) bool, best (B, vocab) f32)``
        on the device — omitted, every occupied lane starts a fresh walk
        — and return an extra last element ``(walk_active (B,) bool on
        the host, best on the device)``: the escalation handoff the
        cascade stashes for the next ladder model.

        With a probe, the time before the token step is its ``plan``
        part and the rest its ``step_host`` part, and every upload and
        read is counted and timed.
        """
        probe = self.probe
        if probe is not None:
            probe.step_start(self.device)
            probe.enter("plan", "tt.plan")
            if self._chunk_graphed:     # every step's record has both
                probe.count(chunk_graph_replays=0, chunk_graph_captures=0)
        decode = np.asarray(occupied, bool).copy()
        widths: dict = {}
        if self._prefilling:
            for lane in self._prefilling:
                decode[lane] = False
            widths = self.planner.plan({
                lane: (st["lp"] - st["cursor"], st["lp"])
                for lane, st in self._prefilling.items()})
        occ = self._dev(decode, torch.bool)
        kv = chunk = None
        finished: list = []
        if self.pool is not None:
            plan = self.pool.prepare_step(decode)
            if plan.fresh.any() or plan.cow_dst.any():
                # page ops only when the plan has any
                self._paged_prep(self._dev(plan.fresh),
                                 self._dev(plan.cow_src),
                                 self._dev(plan.cow_dst))
            kv = PagedKV(page_table=self._dev(self.pool.table),
                         write_page=self._dev(plan.write_page),
                         write_slot=self._dev(plan.write_slot))
        if self.prefill_chunk is not None:
            chunk, finished = self._build_chunk(widths)
        if self.walk_io and walk is None:
            walk = (torch.ones((self.n_lanes,), dtype=torch.bool,
                               device=self.device),
                    torch.zeros((self.n_lanes, self.cfg.vocab),
                                dtype=torch.float32, device=self.device))
        if probe is not None:
            probe.leave()
            probe.enter("step_host", "tt.token_step")
        out = self._step(self.tok, self.caches, self.pos, occ,
                         self._dev(sid), kv, self.states, chunk, walk,
                         probe=probe, run_chunk=self._replay_chunk
                         if self._chunk_graphed else None)
        tok, self.caches, served, sb, sp, self.states = out[:6]
        if self.pool is not None:
            self.pool.note_written(decode)
        self.tok = tok
        self.pos = self.pos + occ.to(torch.int32)
        if finished:
            # the final chunk seeded tok[lane] with the first token;
            # point the lane past its prompt and make its pages
            # shareable now that every byte exists
            lanes = self._dev(finished, torch.long)
            self.pos[lanes] = self._dev(
                [self._prefilling[ln]["lp"] for ln in finished])
            for lane in finished:
                st = self._prefilling.pop(lane)
                self.pool.commit_prefix(lane, st["prompt"])
        if probe is not None:
            probe.enter("sync", "tt.sync")
        host = (tok.cpu().numpy(), served.cpu().numpy(), int(sb), int(sp),
                decode)
        if self.walk_io:
            walk_active, best = out[6]
            host = host + ((walk_active.cpu().numpy(), best),)
        if probe is not None:
            probe.leave(reads=4 + self.walk_io)
            probe.step_end(self.device)
            probe.leave()
        return host
