"""Paged KV-cache subsystem.

Every attention layer's K/V lives in a global pool of fixed-size pages
and each lane holds a page table.  All allocation decisions (free list,
refcounts, prefix hashing, copy-on-write planning) are host-side Python
here; the page writes, copies and gathers run on the device in
`repro_torch.models.attention` and `serving.runtime.scheduler`.
"""

from repro_torch.serving.kvpool.alloc import PageAllocator, PrefixCache
from repro_torch.serving.kvpool.pool import KVPool, PoolExhausted, StepPlan

__all__ = ["PageAllocator", "PrefixCache", "KVPool", "PoolExhausted",
           "StepPlan"]
