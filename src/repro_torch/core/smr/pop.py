"""The paper's contribution: publish-on-ping reclamation.

HazardPtrPOP (Algorithms 1-2): readers keep reservations in thread-LOCAL
slots with no fence; a reclaimer pings (signals) every thread, whose handler
publishes the local slots to the shared SWMR array, bumps its publishCounter,
and fences ONCE.  The reclaimer waits for every counter to advance past its
pre-ping snapshot, then scans and frees the complement.

HazardEraPOP (Algorithm 5): same, with era reservations instead of pointers.
"""

from __future__ import annotations

from typing import Generator, List

from repro_torch.core.sim.engine import NULL, Engine, ThreadCtx
from repro_torch.core.smr.base import MAX_ERA, SMRScheme

NONE_ERA = 0


class HazardPtrPOP(SMRScheme):
    name = "HazardPtrPOP"
    robust = True
    uses_signals = True

    def __init__(self, engine: Engine, **kw):
        super().__init__(engine, **kw)
        self.res = engine.alloc_shared(self.n * self.max_hp)       # sharedReservations
        self.pub_counter = engine.alloc_shared(self.n)             # publishCounter

    def _slot(self, tid: int, slot: int) -> int:
        return self.res + tid * self.max_hp + slot

    def thread_init(self, t: ThreadCtx) -> None:
        super().thread_init(t)
        t.local["lres"] = [NULL] * self.max_hp       # localReservations (no fence!)
        t.local["pub_count"] = 0                     # SWMR mirror of own counter

    # ---- reader path: Algorithm 1, READ / CLEAR ----

    def read(self, t: ThreadCtx, slot: int, ptr_addr: int, decode=None) -> Generator:
        while True:
            ptr = yield from t.load(ptr_addr)
            t.local["lres"][slot] = decode(ptr) if decode else ptr
            yield from t.local_op()                  # local slot write: ~1 cycle
            # NO store-load fence needed (the paper's point)
            again = yield from t.load(ptr_addr)
            t.stats.reads += 1
            if again == ptr:
                return ptr

    def clear(self, t: ThreadCtx) -> Generator:
        lres = t.local["lres"]
        for s in range(self.max_hp):
            lres[s] = NULL
        yield from t.local_op()

    def reserve_many(self, t: ThreadCtx, ptr_addrs, decode=None) -> Generator:
        """Batched session reserve: all reservations stay thread-local --
        one cheap local op covers the batch; publication happens only if a
        reclaimer pings (the paper's traversal-retention argument applied at
        serving granularity).  Loads go through the backend's batched path:
        on the vec engine the reserve pass and the validation pass are one
        numpy gather each instead of N inline loads."""
        while True:
            lres = t.local["lres"]
            ptrs = yield from self._load_many(t, ptr_addrs)
            for i, p in enumerate(ptrs):
                lres[i] = decode(p) if decode else p
            yield from t.local_op()              # NO fence, NO shared store
            again = yield from self._load_many(t, ptr_addrs)
            t.stats.reads += len(ptr_addrs)
            if again == ptrs:
                return ptrs

    # ---- signal handler: Algorithm 2, publishReservations ----

    def handler(self, t: ThreadCtx) -> Generator:
        lres = t.local["lres"]
        for s in range(self.max_hp):
            yield from t.store(self._slot(t.tid, s), lres[s])
        t.local["pub_count"] += 1
        yield from t.store(self.pub_counter + t.tid, t.local["pub_count"])
        yield from t.fence()                         # ONE fence per ping
        t.stats.publishes += 1

    # ---- reclaimer path: Algorithm 2 ----

    def retire(self, t: ThreadCtx, addr: int) -> Generator:
        t.local["retire"].append(addr)
        self._account_retire(t)
        if len(t.local["retire"]) >= self.reclaim_freq:
            yield from self._pop_reclaim(t)

    def _collect_counters(self, t: ThreadCtx) -> Generator:
        snap = yield from self._load_many(
            t, [self.pub_counter + tid for tid in range(self.n)])
        return snap

    def _ping_all(self, t: ThreadCtx) -> Generator:
        for tid in range(self.n):
            if tid != t.tid:
                yield from t.send_signal(tid)

    def _wait_all_published(self, t: ThreadCtx, snap: List[int]) -> Generator:
        for tid in range(self.n):
            if tid == t.tid:
                continue
            if self.engine.threads[tid].done:
                continue  # pthread_kill returned ESRCH: skip dead threads
            while True:
                v = yield from t.load(self.pub_counter + tid)
                if v > snap[tid]:
                    break
                yield from t.spin()
                if self.engine.threads[tid].done:
                    break

    def _collect_reservations(self, t: ThreadCtx) -> Generator:
        reserved = set(t.local["lres"])              # own are known locally
        # (n-1)*max_hp published slots: one gather on the vec backend
        slots = [self._slot(tid, s) for tid in range(self.n) if tid != t.tid
                 for s in range(self.max_hp)]
        vals = yield from self._load_many(t, slots)
        reserved.update(v for v in vals if v != NULL)
        return reserved

    def _pop_reclaim(self, t: ThreadCtx) -> Generator:
        self.reclaim_calls += 1
        t.stats.reclaim_events += 1
        snap = yield from self._collect_counters(t)  # collectPublishedCounters
        t0 = t.now()
        yield from self._ping_all(t)                 # pingAllToPublish
        yield from self._wait_all_published(t, snap) # waitForAllPublished
        self._note_ping_stall(t, t0)
        reserved = yield from self._collect_reservations(t)
        keep: List[int] = []
        for addr in t.local["retire"]:
            if addr in reserved:
                keep.append(addr)
            else:
                yield from self._free(t, addr)
        t.local["retire"] = keep

    def flush(self, t: ThreadCtx) -> Generator:
        if t.local["retire"]:
            yield from self._pop_reclaim(t)


class HazardEraPOP(SMRScheme):
    """Algorithm 5: era reservations tracked locally, published on ping."""

    name = "HazardEraPOP"
    robust = True
    uses_signals = True

    def __init__(self, engine: Engine, **kw):
        super().__init__(engine, **kw)
        self.res = engine.alloc_shared(self.n * self.max_hp)
        self.pub_counter = engine.alloc_shared(self.n)
        self.epoch = engine.alloc_shared(1)
        engine.mem.cells[self.epoch] = 1

    def _slot(self, tid: int, slot: int) -> int:
        return self.res + tid * self.max_hp + slot

    def thread_init(self, t: ThreadCtx) -> None:
        super().thread_init(t)
        t.local["lres"] = [NONE_ERA] * self.max_hp
        t.local["pub_count"] = 0

    def alloc_node(self, t: ThreadCtx, nfields: int) -> Generator:
        addr = yield from t.alloc(nfields)
        era = yield from t.load(self.epoch)
        self.birth[addr] = era
        return addr

    def read(self, t: ThreadCtx, slot: int, ptr_addr: int, decode=None) -> Generator:
        old_era = t.local["lres"][slot]
        while True:
            ptr = yield from t.load(ptr_addr)
            new_era = yield from t.load(self.epoch)
            t.stats.reads += 1
            if old_era == new_era:
                return ptr
            t.local["lres"][slot] = new_era
            yield from t.local_op()                  # no fence needed
            old_era = new_era

    def clear(self, t: ThreadCtx) -> Generator:
        lres = t.local["lres"]
        for s in range(self.max_hp):
            lres[s] = NONE_ERA
        yield from t.local_op()

    def handler(self, t: ThreadCtx) -> Generator:
        lres = t.local["lres"]
        for s in range(self.max_hp):
            yield from t.store(self._slot(t.tid, s), lres[s])
        t.local["pub_count"] += 1
        yield from t.store(self.pub_counter + t.tid, t.local["pub_count"])
        yield from t.fence()
        t.stats.publishes += 1

    def retire(self, t: ThreadCtx, addr: int) -> Generator:
        era = yield from t.load(self.epoch)
        self.retire_era[addr] = era
        t.local["retire"].append(addr)
        self._account_retire(t)
        if len(t.local["retire"]) >= self.reclaim_freq:
            yield from t.faa(self.epoch, 1)
            yield from self._pop_reclaim(t)

    # counter collect / ping / wait are identical to HazardPtrPOP
    _collect_counters = HazardPtrPOP._collect_counters
    _ping_all = HazardPtrPOP._ping_all
    _wait_all_published = HazardPtrPOP._wait_all_published

    def reserve_many(self, t: ThreadCtx, ptr_addrs, decode=None) -> Generator:
        """Batched era reserve: load the batch (one gather on vec), check
        the global era; all reservations stay thread-local, published only
        on ping -- one local op per batch, no fence."""
        lres = t.local["lres"]
        n = len(ptr_addrs)
        while True:
            ptrs = yield from self._load_many(t, ptr_addrs)
            new_era = yield from t.load(self.epoch)
            t.stats.reads += n
            if all(lres[i] == new_era for i in range(n)):
                return ptrs
            for i in range(n):
                lres[i] = new_era
            yield from t.local_op()              # no fence needed (POP)

    def _pop_reclaim(self, t: ThreadCtx) -> Generator:
        self.reclaim_calls += 1
        t.stats.reclaim_events += 1
        snap = yield from self._collect_counters(t)
        t0 = t.now()
        yield from self._ping_all(t)
        yield from self._wait_all_published(t, snap)
        self._note_ping_stall(t, t0)
        eras = [e for e in t.local["lres"] if e != NONE_ERA]
        slots = [self._slot(tid, s) for tid in range(self.n) if tid != t.tid
                 for s in range(self.max_hp)]
        vals = yield from self._load_many(t, slots)
        eras.extend(v for v in vals if v != NONE_ERA)
        keep: List[int] = []
        for addr in t.local["retire"]:
            b = self.birth.get(addr, 0)
            r = self.retire_era.get(addr, MAX_ERA)
            if any(b <= e <= r for e in eras):
                keep.append(addr)
            else:
                yield from self._free(t, addr)
        t.local["retire"] = keep

    def flush(self, t: ThreadCtx) -> Generator:
        if t.local["retire"]:
            yield from self._pop_reclaim(t)
