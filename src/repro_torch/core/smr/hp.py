"""Hazard pointers: the original (fence-per-read), a deliberately broken
fence-less variant (to validate the simulator finds the bug class), and the
Folly-style asymmetric variant (sys_membarrier on the reclaimer).
"""

from __future__ import annotations

from typing import Generator, List

from repro_torch.core.sim.engine import NULL, Engine, ThreadCtx
from repro_torch.core.smr.base import SMRScheme


class HazardPointers(SMRScheme):
    """Michael's HP [42]: reserve -> FENCE -> validate, on *every* read."""

    name = "HP"
    robust = True
    fence_on_read = True

    def __init__(self, engine: Engine, **kw):
        super().__init__(engine, **kw)
        self.res = engine.alloc_shared(self.n * self.max_hp)

    def _slot(self, tid: int, slot: int) -> int:
        return self.res + tid * self.max_hp + slot

    def thread_init(self, t: ThreadCtx) -> None:
        super().thread_init(t)

    def read(self, t: ThreadCtx, slot: int, ptr_addr: int, decode=None) -> Generator:
        while True:
            ptr = yield from t.load(ptr_addr)
            if ptr == NULL:
                return NULL
            node = decode(ptr) if decode else ptr
            yield from t.store(self._slot(t.tid, slot), node)
            if self.fence_on_read:
                yield from t.fence()
            again = yield from t.load(ptr_addr)
            t.stats.reads += 1
            if again == ptr:
                return ptr

    def clear(self, t: ThreadCtx) -> Generator:
        for s in range(self.max_hp):
            yield from t.store(self._slot(t.tid, s), NULL)

    def reserve_many(self, t: ThreadCtx, ptr_addrs, decode=None) -> Generator:
        """Batched session reserve: publish all slots, then ONE store-load
        fence for the whole batch (vs one per read on the hot path).  Both
        the reserve pass and the validation pass go through the backend's
        batched load (one gather on vec)."""
        while True:
            ptrs = yield from self._load_many(t, ptr_addrs)
            for i, p in enumerate(ptrs):
                node = decode(p) if decode else p
                yield from t.store(self._slot(t.tid, i), node)
            if self.fence_on_read:
                yield from t.fence()
            again = yield from self._load_many(t, ptr_addrs)
            t.stats.reads += len(ptr_addrs)
            if again == ptrs:
                return ptrs

    def retire(self, t: ThreadCtx, addr: int) -> Generator:
        t.local["retire"].append(addr)
        self._account_retire(t)
        if len(t.local["retire"]) >= self.reclaim_freq:
            yield from self._reclaim(t)

    def _pre_scan(self, t: ThreadCtx) -> Generator:
        return
        yield

    def _reclaim(self, t: ThreadCtx) -> Generator:
        self.reclaim_calls += 1
        t.stats.reclaim_events += 1
        yield from self._pre_scan(t)
        # the n*max_hp slot scan is ONE gather on the vec backend
        slots = [self._slot(tid, s) for tid in range(self.n)
                 for s in range(self.max_hp)]
        vals = yield from self._load_many(t, slots)
        reserved = {v for v in vals if v != NULL}
        keep: List[int] = []
        for addr in t.local["retire"]:
            if addr in reserved:
                keep.append(addr)
            else:
                yield from self._free(t, addr)
        t.local["retire"] = keep

    def flush(self, t: ThreadCtx) -> Generator:
        if t.local["retire"]:
            yield from self._reclaim(t)


class HazardPointersBroken(HazardPointers):
    """HP with the store-load fence removed.

    UNSAFE BY CONSTRUCTION: the reservation store can still sit in the store
    buffer while the validation load executes, so a concurrent reclaimer can
    scan, miss the reservation, and free the node under the reader.  Exists
    only so the test suite can demonstrate the simulator's memory model is
    weak enough to expose the bug POP must (and does) avoid.
    """

    name = "HP-broken"
    robust = True
    fence_on_read = False


class HazardPointersAsym(HazardPointers):
    """HPAsym (Folly-style): readers skip the fence; the reclaimer executes a
    process-wide sys_membarrier before scanning, forcing every thread's
    buffered reservation stores to become visible."""

    name = "HPAsym"
    robust = True
    fence_on_read = False

    def _pre_scan(self, t: ThreadCtx) -> Generator:
        yield from t.membarrier()
