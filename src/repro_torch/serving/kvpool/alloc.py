"""Page allocation + shared-prefix index (host-side, DESIGN.md §8).

`PageAllocator` is a refcounted free list over the global page pool.
Page 0 is RESERVED as the garbage sink: the device-side paged writes of
masked/exited lanes are redirected there (with position -1, so gathered
garbage is never attended), and unused page-table entries point at it.

`PrefixCache` maps prompt-prefix hashes to page chains so a new request
whose prompt shares a prefix with an earlier one points its page table
at the SAME pages instead of storing duplicate KV.  Every cache entry
holds its own reference on each of its pages, which is what keeps a
prefix alive after the request that wrote it has released its lane;
entries are dropped LRU-first when admission needs pages back.
"""

from __future__ import annotations

import collections
import hashlib

import numpy as np

__all__ = ["GARBAGE_PAGE", "PageAllocator", "PrefixCache"]

GARBAGE_PAGE = 0


class PageAllocator:
    """Refcounted free-list allocator over ``n_pages`` fixed-size pages.

    Invariants (pinned by tests/serving/test_kvpool.py):
      * a page is either free or has refcount >= 1 — incref/decref of a
        free page raises (double-free guard),
      * ``alloc`` is atomic: it returns ``None`` rather than a partial
        list when fewer than ``n`` pages are free,
      * page ids come back in deterministic (ascending-preferred) order.
    """

    def __init__(self, n_pages: int):
        if n_pages < 2:
            raise ValueError("need at least 2 pages (page 0 is reserved)")
        self.n_pages = int(n_pages)
        # LIFO stack initialized descending so pop() yields ascending ids
        self._free = list(range(self.n_pages - 1, GARBAGE_PAGE, -1))
        self._ref = np.zeros(self.n_pages, np.int32)

    # ------------------------------------------------------------------
    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        # excludes the reserved garbage page
        return self.n_pages - 1 - len(self._free)

    def refcount(self, pid: int) -> int:
        return int(self._ref[pid])

    def alloc(self, n: int = 1) -> list[int] | None:
        """Take ``n`` pages (refcount 1 each) or ``None`` if short."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free):
            return None
        out = [self._free.pop() for _ in range(n)]
        self._ref[out] = 1
        return out

    def incref(self, pid: int) -> None:
        if pid == GARBAGE_PAGE:
            raise ValueError("page 0 is the reserved garbage sink")
        if self._ref[pid] <= 0:
            raise ValueError(f"incref of free page {pid}")
        self._ref[pid] += 1

    def decref(self, pid: int) -> bool:
        """Drop one reference; returns True when the page became free."""
        if pid == GARBAGE_PAGE:
            raise ValueError("page 0 is the reserved garbage sink")
        if self._ref[pid] <= 0:
            raise ValueError(f"double free of page {pid}")
        self._ref[pid] -= 1
        if self._ref[pid] == 0:
            self._free.append(pid)
            return True
        return False


def _prefix_key(tokens: np.ndarray, n: int, salt: bytes = b"") -> bytes:
    """Content hash of ``tokens[:n]`` (length-salted, dtype-canonical).

    ``salt`` namespaces the key — the cascade subsystem passes a MODEL
    key so identical prompt text admitted on two different models can
    never resolve to the same page chain (their KV bytes are different
    tensors entirely)."""
    h = hashlib.sha1(salt)
    h.update(np.ascontiguousarray(tokens[:n], np.int32).tobytes())
    h.update(n.to_bytes(8, "little"))
    return h.digest()


class PrefixCache:
    """LRU index: prompt-prefix hash -> (page ids, tokens covered).

    ``insert`` registers one entry per page-aligned prefix boundary plus
    one for the full prompt (whose last page may be PARTIAL — sharing it
    is what later forces a copy-on-write split when the new lane appends
    its own tokens).  ``lookup`` returns the longest match and increfs
    the matched pages on behalf of the caller's lane.

    ``model_key`` salts every hash: two caches (or one cache serving two
    models over a shared allocator) with different keys are fully
    isolated — the same prompt text never matches across models.
    """

    def __init__(self, allocator: PageAllocator,
                 model_key: str | None = None):
        self.allocator = allocator
        self._salt = (model_key or "").encode()
        self._entries: collections.OrderedDict[bytes, tuple[tuple[int, ...],
                                                            int]] = \
            collections.OrderedDict()
        # per-page count of refs held BY CACHE ENTRIES: a page whose
        # total refcount equals this is backing no live lane, so
        # evicting its entries makes real progress toward freeing it
        self._page_refs: collections.Counter[int] = collections.Counter()
        # stats (KVPool folds these into its report)
        self.lookups = 0
        self.hits = 0
        self.shared_tokens = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._entries)

    def _match_keys(self, tokens: np.ndarray, page_size: int):
        """Candidate prefix lengths, longest first: the full prompt
        (which may end mid-page), then each page-aligned boundary."""
        n = len(tokens)
        lens = [] if n % page_size == 0 else [n]
        lens += [k * page_size for k in range(n // page_size, 0, -1)]
        return lens

    def lookup(self, tokens: np.ndarray, page_size: int,
               peek: bool = False):
        """Longest shared prefix of ``tokens``.

        Returns ``(pages, n_tokens)`` — the page chain covering the first
        ``n_tokens`` of the prompt.  Unless ``peek``, the matched pages
        are increfed for the caller (the lane owns those references and
        must decref them at release).
        """
        if not peek:
            self.lookups += 1
        for ln in self._match_keys(tokens, page_size):
            ent = self._entries.get(_prefix_key(tokens, ln, self._salt))
            if ent is None:
                continue
            pages, n_tok = ent
            if not peek:
                self._entries.move_to_end(
                    _prefix_key(tokens, ln, self._salt))
                for pid in pages:
                    self.allocator.incref(pid)
                self.hits += 1
                self.shared_tokens += n_tok
            return list(pages), n_tok
        return [], 0

    def insert(self, tokens: np.ndarray, pages: list[int],
               page_size: int) -> None:
        """Register the prompt's page chain (full pages + partial tail).

        ``pages`` covers ``tokens`` in order.  Each NEW entry increfs its
        pages; keys that already exist are left untouched (the earlier
        entry is canonical — its pages carry the same KV by determinism).
        """
        n = len(tokens)
        bounds = [k * page_size for k in range(1, n // page_size + 1)]
        if n % page_size:
            bounds.append(n)
        for ln in bounds:
            key = _prefix_key(tokens, ln, self._salt)
            if key in self._entries:
                continue
            chain = tuple(pages[: (ln + page_size - 1) // page_size])
            for pid in chain:
                self.allocator.incref(pid)
                self._page_refs[pid] += 1
            self._entries[key] = (chain, ln)

    def _drop(self, key: bytes) -> int:
        pages, _ = self._entries.pop(key)
        freed = 0
        for pid in pages:
            self._page_refs[pid] -= 1
            if self.allocator.decref(pid):
                freed += 1
        return freed

    def evict(self, n_needed: int, pinned=None) -> int:
        """Drop entries, LRU first, until ``n_needed`` pages became FREE.

        Entries ALL of whose pages back a live lane are kept: dropping
        them can never free a page (the lane's refs pin it) — it would
        only burn future prefix hits.  An entry counts as progress when
        at least one of its pages is held by cache entries alone
        (``refcount == cache refs``); chains sharing pages may need
        several such evictions before the last ref drops.  ``pinned``
        (page id -> pin count) protects chains that pending admission
        reservations counted as shared — evicting those would silently
        turn a sufficient reservation into an under-estimate.  Returns
        the number of pages actually freed."""
        pinned = pinned or {}
        freed = 0
        progress = True
        while freed < n_needed and progress:
            progress = False
            for key, (pages, _) in list(self._entries.items()):
                if any(pinned.get(p, 0) > 0 for p in pages):
                    continue
                if not any(self.allocator.refcount(p) == self._page_refs[p]
                           for p in pages):
                    continue
                freed += self._drop(key)
                self.evictions += 1
                progress = True
                if freed >= n_needed:
                    break
        return freed

    def clear(self) -> None:
        """Drop every entry (release-all; used by pool reset)."""
        for key in list(self._entries.keys()):
            self._drop(key)
