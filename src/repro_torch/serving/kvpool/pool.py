"""The paged KV pool: host bookkeeping + device-plan construction
(DESIGN.md §8).

`KVPool` owns the allocation state for one `EngineStepper`:

  * per-lane page TABLES (``(n_lanes, lane_pages)`` int32, garbage-page
    padded) and sequence lengths,
  * the `PageAllocator` free list / refcounts and the `PrefixCache`,
  * per-lane page BUDGETS — admission reserves the worst-case page count
    up front (``sum(budget) <= free_count`` is the invariant), so lazy
    page growth and copy-on-write splits during decode can never fail
    mid-stream; a request that doesn't fit stays in the queue.

Every method returns plain numpy plans (page/slot indices) for the
stepper to feed into its jitted device programs — the pool itself never
touches a device array, which is what keeps allocation host-side while
gather/scatter stays on device.

Copy-on-write: a lane appends KV into its tail page every decode token.
If that page is referenced by ANYONE else — another lane's table or a
`PrefixCache` entry — the writer first gets a private copy
(`StepPlan.cow_src/cow_dst`, executed as a device page copy before the
token step).  Cached pages are therefore IMMUTABLE after the admission
prefill scatter: they hold exactly the prompt's KV, complete across
every layer (prefill runs full depth).  That immutability is what makes
sharing exact — decode appends land only in probed layers (early-exit
masking), so letting them touch a shared page would leak one request's
per-layer KV holes into another's attention.
"""

from __future__ import annotations

import collections
import dataclasses

import numpy as np

from repro_torch.serving.kvpool.alloc import (GARBAGE_PAGE, PageAllocator,
                                        PrefixCache)

__all__ = ["KVPool", "PoolExhausted", "StepPlan", "AdmitPlan"]


class PoolExhausted(RuntimeError):
    """A request can never fit (config error, not transient pressure)."""


@dataclasses.dataclass
class AdmitPlan:
    """Device scatter plan for one admission (all host numpy)."""

    lane: int
    dest_page: np.ndarray     # (Lp,) i32 per-token page (garbage if shared)
    dest_slot: np.ndarray     # (Lp,) i32 per-token slot within the page
    pos_vals: np.ndarray      # (Lp,) i32 position to store (-1 if shared)
    new_pages: np.ndarray     # (lane_pages,) i32 pages to pos-reset (0 pad)
    n_shared_tokens: int


@dataclasses.dataclass
class StepPlan:
    """Per-token device plan: where each lane writes, plus the page
    copies (COW) and fresh-page resets that must run first."""

    write_page: np.ndarray    # (n_lanes,) i32 (garbage for idle lanes)
    write_slot: np.ndarray    # (n_lanes,) i32
    fresh: np.ndarray         # (n_lanes,) i32 page to pos-reset (0 = none)
    cow_src: np.ndarray       # (n_lanes,) i32 (0 = none)
    cow_dst: np.ndarray       # (n_lanes,) i32 (0 = none)


class KVPool:
    """Host-side paged-KV bookkeeping for ``n_lanes`` decode lanes."""

    def __init__(self, *, n_lanes: int, page_size: int, lane_pages: int,
                 n_pages: int | None = None,
                 max_lane_pages: int | None = None,
                 model_key: str | None = None,
                 reclaim_watermark: float | None = None):
        if page_size < 1 or lane_pages < 1:
            raise ValueError("page_size and lane_pages must be >= 1")
        if reclaim_watermark is not None and not 0.0 < reclaim_watermark <= 1.0:
            raise ValueError(
                f"reclaim_watermark must be in (0, 1], got "
                f"{reclaim_watermark}")
        self.n_lanes = int(n_lanes)
        self.page_size = int(page_size)
        self.lane_pages = int(lane_pages)
        # sliding-window reclamation (DESIGN.md §14): above this
        # occupancy fraction an admission short on headroom may CLIP the
        # oldest sole-owner page off the longest lane — trading that
        # lane's attention history for admission instead of refusing it.
        # None disables (engine mode: device page-table positions assume
        # an unclipped table).
        self.reclaim_watermark = (None if reclaim_watermark is None
                                  else float(reclaim_watermark))
        # the device page-table WIDTH (static shape): admission reserves
        # against `lane_pages`, but `grow` may extend a lane's budget in
        # page-aligned increments up to this hard capacity — the knob
        # that lets escalated lanes avoid double worst-case reservation
        self.max_lane_pages = max(self.lane_pages,
                                  int(max_lane_pages or self.lane_pages))
        # namespaces the prefix cache (multi-model cascades: identical
        # prompt text on two models must never share page chains)
        self.model_key = model_key
        # default: ring-equivalent HBM (n_lanes x lane capacity) + sink
        self.n_pages = int(n_pages) if n_pages is not None \
            else self.n_lanes * self.lane_pages + 1
        self.reset()

    def reset(self) -> None:
        """Fresh allocation state (the stepper re-materializes device
        pools separately — stale KV bytes are gated by pos resets)."""
        self.allocator = PageAllocator(self.n_pages)
        self.prefix = PrefixCache(self.allocator, model_key=self.model_key)
        self.table = np.full((self.n_lanes, self.max_lane_pages),
                             GARBAGE_PAGE, np.int32)
        self.n_held = np.zeros(self.n_lanes, np.int32)
        self.seq_len = np.zeros(self.n_lanes, np.int32)
        self.budget = np.zeros(self.n_lanes, np.int32)
        # reservations awaiting their admit: (need, matched-chain pages);
        # the pages are PINNED against eviction so the sharing the need
        # was computed from cannot disappear before admit
        self._pending: collections.deque[tuple[int, tuple[int, ...]]] = \
            collections.deque()
        self._pinned: collections.Counter[int] = collections.Counter()
        self.prompt_tokens = 0
        self.cow_splits = 0
        self.peak_pages = 0
        self.grows = 0
        # admissions refused for lack of headroom — the page-exhaustion
        # signal the observability flight recorder triggers on
        self.reserve_failures = 0
        # fault plane (DESIGN.md §14): pages clipped off each lane's
        # front by sliding-window reclamation (positions shift by
        # clipped * page_size), plus the chaos harness's page squeeze —
        # pages withheld from headroom while a pressure window is active
        self.clipped = np.zeros(self.n_lanes, np.int32)
        self.reclaimed_pages = 0
        self.squeezed = 0

    # ------------------------------------------------------------------
    # admission
    # ------------------------------------------------------------------

    def pages_for(self, prompt_len: int, max_tokens: int) -> int:
        total = prompt_len + max_tokens
        return -(-total // self.page_size)

    def _fresh_need(self, prompt, max_tokens: int) -> tuple[int, list]:
        """Worst-case NEW pages a request needs given current sharing,
        plus the matched prefix chain the estimate relies on.

        Shared FULL pages are never written again, so they cost nothing.
        A shared partial tail page still costs its copy-on-write split —
        which is exactly the tail page already counted in the total.
        A FRESH partial tail gets registered in the prefix cache at
        admission, so its first decode append ALSO splits (refcount > 1:
        the cache pins it) — reserve that page too (unused budget is
        simply returned at release)."""
        lp = len(prompt)
        total = self.pages_for(lp, max_tokens)
        pages, n_tok = self.prefix.lookup(prompt, self.page_size,
                                          peek=True)
        contested = 1 if (lp % self.page_size and n_tok < lp) else 0
        return total - n_tok // self.page_size + contested, pages

    def _headroom(self) -> int:
        """Pages neither allocated, lane-reserved, pending-reserved,
        nor withheld by an active pressure squeeze."""
        return (self.allocator.free_count - int(self.budget.sum())
                - sum(need for need, _ in self._pending)
                - self.squeezed)

    def set_squeeze(self, pages: int) -> None:
        """Withhold ``pages`` from admission headroom (chaos page
        pressure).  Squeezes only gate NEW reservations — budgets
        already granted keep the never-fail-mid-stream guarantee."""
        self.squeezed = max(0, int(pages))

    def reserve(self, prompt, max_tokens: int) -> bool:
        """The admission gate: reserve the request's worst-case page need
        (evicting cached prefixes if that closes the gap), or return
        False so the request STAYS QUEUED.  The scheduler calls this at
        pop time; the matching `admit` consumes the reservation — the
        two may be separated by other reserve/admit pairs of the same
        admission round (FIFO discipline, enforced by the deque).  The
        matched prefix chain is pinned against eviction until the admit,
        so the sharing this need was computed from cannot be evicted out
        from under it (by this call's own eviction or a later one's)."""
        if len(prompt) + max_tokens > self.max_lane_pages * self.page_size:
            raise PoolExhausted(
                f"request needs {len(prompt) + max_tokens} tokens but a "
                f"lane holds at most {self.max_lane_pages} pages x "
                f"{self.page_size} = "
                f"{self.max_lane_pages * self.page_size}")
        need, match = self._fresh_need(prompt, max_tokens)
        self._pinned.update(match)
        if need > self._headroom():
            self.prefix.evict(need - self._headroom(),
                              pinned=self._pinned)
        if need > self._headroom():
            # degradation ladder's last rung before refusing: clip
            # attention history off the longest lanes (DESIGN.md §14)
            self._reclaim(need - self._headroom())
        if need > self._headroom():
            self._pinned.subtract(match)
            self._pinned = +self._pinned        # drop zero counts
            self.reserve_failures += 1
            return False
        self._pending.append((need, tuple(match)))
        return True

    # ------------------------------------------------------------------
    # sliding-window reclamation (DESIGN.md §14)
    # ------------------------------------------------------------------

    def _occupancy(self) -> float:
        return self.allocator.pages_in_use / max(1, self.n_pages - 1)

    def _clip_candidate(self, lane: int) -> bool:
        """A lane may lose its head page only when that page is pure
        private history: the lane alone references it (so it is neither
        a prefix-cache chain nor pinned by a pending reservation) and
        the lane has at least one more page behind it — the tail being
        written is never clipped."""
        if self.n_held[lane] < 2:
            return False
        head = int(self.table[lane, 0])
        if head == GARBAGE_PAGE or self._pinned.get(head, 0):
            return False
        return self.allocator.refcount(head) == 1

    def _reclaim(self, need_pages: int) -> int:
        """Clip up to ``need_pages`` oldest sole-owner pages off the
        longest lanes while occupancy sits above the watermark.  Each
        clip shifts the victim's page table left one slot and frees the
        head page — the lane keeps decoding with a shorter attention
        window (``clipped[lane]`` records the shift so position math
        stays exact).  Returns pages actually reclaimed."""
        if self.reclaim_watermark is None:
            return 0
        got = 0
        while got < need_pages and self._occupancy() > self.reclaim_watermark:
            live = self.seq_len - self.clipped * self.page_size
            order = sorted(range(self.n_lanes),
                           key=lambda ln: (-int(live[ln]), ln))
            victim = next((ln for ln in order
                           if self._clip_candidate(ln)), None)
            if victim is None:
                break
            head = int(self.table[victim, 0])
            self.allocator.decref(head)           # sole ref: page freed
            self.table[victim, :-1] = self.table[victim, 1:]
            self.table[victim, -1] = GARBAGE_PAGE
            self.n_held[victim] -= 1
            self.clipped[victim] += 1
            self.reclaimed_pages += 1
            got += 1
        return got

    def admit(self, lane: int, prompt, max_tokens: int, *,
              register_prefix: bool = True) -> AdmitPlan:
        """Consume the oldest `reserve` and build the request's prefill
        scatter plan.  Sharing can only have IMPROVED since the reserve
        (earlier admissions of this round insert their prefixes), so the
        reservation is an upper bound on what gets allocated here.

        ``register_prefix=False`` defers the prefix-cache insert —
        chunked prefill admits BEFORE the prompt's KV bytes exist in the
        pool, and registering the chain early would let a concurrent
        admission share pages whose contents are still being written
        chunk by chunk.  The stepper calls `commit_prefix` once the
        final chunk has committed."""
        prompt = np.asarray(prompt, np.int32)
        lp, ps = len(prompt), self.page_size
        if self.n_held[lane]:
            raise ValueError(f"lane {lane} still holds pages")
        if not self._pending:
            raise ValueError("admit without a matching reserve")
        _, pinned = self._pending.popleft()
        self._pinned.subtract(pinned)
        self._pinned = +self._pinned            # drop zero counts
        shared, n_shared = self.prefix.lookup(prompt, ps)  # increfs
        n_prompt_pages = -(-lp // ps)
        fresh_prompt = n_prompt_pages - len(shared)
        got = self.allocator.alloc(fresh_prompt)
        if got is None:  # reserve guaranteed this; keep the invariant
            for pid in shared:
                self.allocator.decref(pid)
            raise PoolExhausted("allocator out of pages at admit "
                                "(reserve not consulted?)")
        pages = shared + got
        contested = 1 if (lp % ps and n_shared < lp) else 0
        need = self.pages_for(lp, max_tokens) - n_shared // ps + contested
        self.budget[lane] = need - fresh_prompt
        row = self.table[lane]
        row[:] = GARBAGE_PAGE
        row[:len(pages)] = pages
        self.n_held[lane] = len(pages)
        self.seq_len[lane] = lp
        self.clipped[lane] = 0

        # per-token scatter targets; shared tokens go to the sink
        tok = np.arange(lp, dtype=np.int32)
        dest_page = np.asarray(pages, np.int32)[tok // ps]
        dest_page[:n_shared] = GARBAGE_PAGE
        pos_vals = tok.copy()
        pos_vals[:n_shared] = -1
        new_pages = np.full(self.max_lane_pages, GARBAGE_PAGE, np.int32)
        new_pages[:len(got)] = got

        # future identical/extending prompts share these pages
        if register_prefix:
            self.prefix.insert(prompt, pages, ps)
        self.prompt_tokens += lp
        self.peak_pages = max(self.peak_pages, self.allocator.pages_in_use)
        return AdmitPlan(lane=lane, dest_page=dest_page,
                         dest_slot=(tok % ps).astype(np.int32),
                         pos_vals=pos_vals, new_pages=new_pages,
                         n_shared_tokens=n_shared)

    def commit_prefix(self, lane: int, prompt) -> None:
        """Register a deferred-admit lane's prompt chain in the prefix
        cache — called by the chunked-prefill stepper AFTER the final
        chunk's writes committed, at which point the pages hold exactly
        the prompt's KV across every layer (chunks run full depth) and
        sharing them is sound.  The lane has not decoded yet, so its
        table still holds exactly the prompt chain."""
        prompt = np.asarray(prompt, np.int32)
        n_prompt_pages = -(-len(prompt) // self.page_size)
        if n_prompt_pages > self.n_held[lane]:
            raise ValueError(
                f"lane {lane} holds {self.n_held[lane]} pages but the "
                f"prompt needs {n_prompt_pages} — commit_prefix before "
                "the final chunk?")
        pages = [int(p) for p in self.table[lane, :n_prompt_pages]]
        self.prefix.insert(prompt, pages, self.page_size)

    # ------------------------------------------------------------------
    # decode
    # ------------------------------------------------------------------

    def prepare_step(self, occupied: np.ndarray) -> StepPlan:
        """Plan this token's writes for every occupied lane: grow a fresh
        tail page at page boundaries, split shared tails (COW), emit
        (page, slot) write targets.  Call `note_written` after the device
        step commits."""
        n = self.n_lanes
        plan = StepPlan(
            write_page=np.full(n, GARBAGE_PAGE, np.int32),
            write_slot=np.zeros(n, np.int32),
            fresh=np.full(n, GARBAGE_PAGE, np.int32),
            cow_src=np.full(n, GARBAGE_PAGE, np.int32),
            cow_dst=np.full(n, GARBAGE_PAGE, np.int32))
        for lane in np.flatnonzero(occupied):
            pos = int(self.seq_len[lane])
            slot = pos % self.page_size
            # physical table index: reclamation shifts the table left,
            # so clipped pages no longer occupy slots
            pidx = pos // self.page_size - int(self.clipped[lane])
            if pidx >= self.max_lane_pages:
                raise PoolExhausted(
                    f"lane {lane} exceeded its page table "
                    f"({self.max_lane_pages} pages) — admission (plus "
                    "any grow() increments) must cap prompt_len + "
                    "max_tokens")
            if pidx == self.n_held[lane]:        # page boundary: grow
                got = self._alloc_from_budget(lane)
                self.table[lane, pidx] = got
                self.n_held[lane] += 1
                plan.fresh[lane] = got
            tail = int(self.table[lane, pidx])
            # any other reference — another lane OR a prefix-cache entry
            # — makes the tail immutable: split before appending (cached
            # pages must stay exact per-layer prompt snapshots)
            if self.allocator.refcount(tail) > 1:
                got = self._alloc_from_budget(lane)
                plan.cow_src[lane] = tail
                plan.cow_dst[lane] = got
                self.table[lane, pidx] = got
                self.allocator.decref(tail)
                self.cow_splits += 1
                tail = got
            plan.write_page[lane] = tail
            plan.write_slot[lane] = slot
        self.peak_pages = max(self.peak_pages, self.allocator.pages_in_use)
        return plan

    def _alloc_from_budget(self, lane: int) -> int:
        if self.budget[lane] <= 0:
            raise PoolExhausted(
                f"lane {lane} page budget exhausted (reservation bug)")
        got = self.allocator.alloc(1)
        if got is None:
            raise PoolExhausted(
                "free list empty despite reservation (invariant bug)")
        self.budget[lane] -= 1
        return got[0]

    def can_append(self, lane: int) -> bool:
        """Can the lane's NEXT decode append succeed from its reserved
        budget?  Mirrors exactly what `prepare_step` will need: a fresh
        page at a page boundary, a COW split when the tail is shared —
        callers of incremental reservation (`grow`) consult this before
        including the lane in a step and defer it when growth fails
        (the never-fail-mid-stream guarantee, kept incrementally)."""
        pos = int(self.seq_len[lane])
        pidx = pos // self.page_size - int(self.clipped[lane])
        if pidx >= self.max_lane_pages:
            return False
        need = 0
        if pidx == self.n_held[lane]:
            need = 1                                  # fresh tail page
        elif self.allocator.refcount(int(self.table[lane, pidx])) > 1:
            need = 1                                  # COW split
        return int(self.budget[lane]) >= need

    def tokens_headroom(self, lane: int) -> int:
        """Tokens the lane can still append WITHOUT another `grow`:
        slack in its held pages plus its reserved (budgeted) pages."""
        cap = (int(self.clipped[lane]) + int(self.n_held[lane])
               + int(self.budget[lane])) * self.page_size
        return cap - int(self.seq_len[lane])

    def grow(self, lane: int, extra_tokens: int) -> bool:
        """Extend a live lane's page budget by a page-aligned increment
        covering ``extra_tokens`` more appends — growth BEYOND the
        admission-time reservation (the escalated-lane fix: a stream
        re-admitted on another model reserves a small initial budget and
        grows as it decodes instead of double worst-case reservation).

        The increment is RESERVED here (the same never-fail-mid-stream
        guarantee as admission: decode only ever allocates from budget),
        so a True return means the next ``extra_tokens`` appends cannot
        hit an empty free list.  Returns False — leaving all state
        untouched — when the pool lacks headroom or the lane's table is
        at its hard ``max_lane_pages`` capacity; the caller defers the
        lane (emit nothing, retry next step) rather than crashing."""
        if extra_tokens < 1:
            raise ValueError(f"grow({extra_tokens})")
        if not self.n_held[lane]:
            raise ValueError(f"lane {lane} holds no pages (grow is for "
                             "live lanes; use reserve/admit)")
        inc = -(-int(extra_tokens) // self.page_size)
        if (int(self.n_held[lane]) + int(self.budget[lane]) + inc
                > self.max_lane_pages):
            return False
        if inc > self._headroom():
            self.prefix.evict(inc - self._headroom(), pinned=self._pinned)
        if inc > self._headroom():
            return False
        self.budget[lane] += inc
        self.grows += 1
        return True

    def note_written(self, occupied: np.ndarray) -> None:
        """Commit one decoded token per occupied lane."""
        self.seq_len[np.flatnonzero(occupied)] += 1

    def release(self, lane: int) -> None:
        """Drop the lane's page references (cached prefixes keep theirs,
        so the prompt's pages stay warm for future lookups)."""
        for pid in self.table[lane, :self.n_held[lane]]:
            self.allocator.decref(int(pid))
        self.table[lane] = GARBAGE_PAGE
        self.n_held[lane] = 0
        self.seq_len[lane] = 0
        self.budget[lane] = 0
        self.clipped[lane] = 0

    # ------------------------------------------------------------------

    def check_invariants(self) -> list[str]:
        """Audit the pool's conservation laws; returns violations (empty
        when healthy).  This is the invariant ledger's page-conservation
        probe (DESIGN.md §13) — pure host numpy over small arrays, cheap
        enough to run at every counter-event edge of a soak:

          * refcounts never negative; free XOR referenced per page,
          * allocs == frees + in_use: ``free_count + pages_in_use``
            covers every non-garbage page exactly once,
          * every reference is accounted for: a page's refcount equals
            the lane tables' holds plus the prefix cache's entry refs,
          * reserved budgets never exceed the free list
            (the never-fail-mid-stream admission guarantee).
        """
        bad: list[str] = []
        alloc = self.allocator
        ref = alloc._ref
        if (ref < 0).any():
            bad.append(f"negative refcount at pages "
                       f"{np.flatnonzero(ref < 0).tolist()}")
        free = set(alloc._free)
        if len(free) != len(alloc._free):
            bad.append("free list holds duplicate page ids")
        if alloc.free_count + alloc.pages_in_use != alloc.n_pages - 1:
            bad.append(
                f"page conservation broken: free={alloc.free_count} + "
                f"in_use={alloc.pages_in_use} != {alloc.n_pages - 1}")
        for pid in free:
            if ref[pid] != 0:
                bad.append(f"page {pid} free but refcount {int(ref[pid])}")
        # reference accounting: lane holds + cache refs == refcount
        held: collections.Counter[int] = collections.Counter()
        for lane in range(self.n_lanes):
            for pid in self.table[lane, :self.n_held[lane]]:
                held[int(pid)] += 1
        for pid in range(1, alloc.n_pages):
            if pid in free:
                continue
            expect = held.get(pid, 0) + self.prefix._page_refs.get(pid, 0)
            if int(ref[pid]) != expect:
                bad.append(
                    f"page {pid} refcount {int(ref[pid])} != "
                    f"{held.get(pid, 0)} lane holds + "
                    f"{self.prefix._page_refs.get(pid, 0)} cache refs")
            if int(ref[pid]) == 0:
                bad.append(f"page {pid} in use but refcount 0")
        pending = sum(need for need, _ in self._pending)
        if int(self.budget.sum()) + pending > alloc.free_count:
            bad.append(
                f"reserved budget {int(self.budget.sum())}+{pending} "
                f"pending exceeds free pages {alloc.free_count}")
        return bad

    @property
    def pages_in_use(self) -> int:
        return int(self.allocator.pages_in_use)

    def stats(self) -> dict:
        pf = self.prefix
        return {
            "page_size": self.page_size,
            "n_pages": self.n_pages,
            "pages_in_use": self.allocator.pages_in_use,
            "pages_peak": self.peak_pages,
            "pages_free": self.allocator.free_count,
            "prefix_entries": len(pf),
            "prefix_lookups": pf.lookups,
            "prefix_hits": pf.hits,
            "prefix_hit_rate": (pf.shared_tokens / self.prompt_tokens
                                if self.prompt_tokens else 0.0),
            "shared_tokens": pf.shared_tokens,
            "cow_splits": self.cow_splits,
            "evictions": pf.evictions,
            "grows": self.grows,
            "reserve_failures": self.reserve_failures,
            "reclaimed_pages": self.reclaimed_pages,
            "squeezed_pages": self.squeezed,
        }
