"""EpochPOP (paper Algorithm 3): EBR fast path + HazardPtrPOP fallback.

Threads announce epochs like EBR *and* privately track pointer reservations
like HazardPtrPOP, simultaneously -- no mode switch.  Reclaimers free via the
epoch scan; if the retire list is still above C*reclaimFreq afterwards (a
delayed thread is pinning the minimum epoch), they ping all threads and free
by published pointer reservations instead.  Robust, EBR-fast.
"""

from __future__ import annotations

from typing import Generator, List

from repro_torch.core.sim.engine import NULL, Engine, ThreadCtx
from repro_torch.core.smr.base import MAX_ERA, SMRScheme
from repro_torch.core.smr.pop import HazardPtrPOP


class EpochPOP(SMRScheme):
    name = "EpochPOP"
    robust = True
    uses_signals = True

    def __init__(self, engine: Engine, C: int = 2, **kw):
        super().__init__(engine, **kw)
        self.C = C
        self.epoch = engine.alloc_shared(1)
        engine.mem.cells[self.epoch] = 1
        self.reserved_epoch = engine.alloc_shared(self.n)
        for i in range(self.n):
            engine.mem.cells[self.reserved_epoch + i] = MAX_ERA
        self.res = engine.alloc_shared(self.n * self.max_hp)
        self.pub_counter = engine.alloc_shared(self.n)
        self.epoch_reclaims = 0
        self.pop_reclaims = 0

    def _slot(self, tid: int, slot: int) -> int:
        return self.res + tid * self.max_hp + slot

    def thread_init(self, t: ThreadCtx) -> None:
        super().thread_init(t)
        t.local["lres"] = [NULL] * self.max_hp
        t.local["pub_count"] = 0
        t.local["op_counter"] = 0

    # ---- EBR-style op brackets (Alg 3: STARTOP / ENDOP) ----

    def start_op(self, t: ThreadCtx) -> Generator:
        t.local["op_counter"] += 1
        if t.local["op_counter"] % self.epoch_freq == 0:
            yield from t.faa(self.epoch, 1)
        e = yield from t.load(self.epoch)
        yield from t.atomic_store(self.reserved_epoch + t.tid, e)
        yield from t.fence()

    def end_op(self, t: ThreadCtx) -> Generator:
        yield from t.store(self.reserved_epoch + t.tid, MAX_ERA)
        yield from self.clear(t)

    # ---- HazardPtrPOP-style fence-free READ (Alg 3: READ) ----

    def read(self, t: ThreadCtx, slot: int, ptr_addr: int, decode=None) -> Generator:
        while True:
            ptr = yield from t.load(ptr_addr)
            t.local["lres"][slot] = decode(ptr) if decode else ptr
            yield from t.local_op()
            again = yield from t.load(ptr_addr)
            t.stats.reads += 1
            if again == ptr:
                return ptr

    def clear(self, t: ThreadCtx) -> Generator:
        lres = t.local["lres"]
        for s in range(self.max_hp):
            lres[s] = NULL
        yield from t.local_op()

    def handler(self, t: ThreadCtx) -> Generator:
        lres = t.local["lres"]
        for s in range(self.max_hp):
            yield from t.store(self._slot(t.tid, s), lres[s])
        t.local["pub_count"] += 1
        yield from t.store(self.pub_counter + t.tid, t.local["pub_count"])
        yield from t.fence()
        t.stats.publishes += 1

    # ---- RETIRE (Alg 3): epoch fast path, POP fallback ----

    def retire(self, t: ThreadCtx, addr: int) -> Generator:
        e = yield from t.load(self.epoch)
        self.retire_era[addr] = e
        t.local["retire"].append(addr)
        self._account_retire(t)
        if len(t.local["retire"]) % self.reclaim_freq == 0:
            yield from self._reclaim_epoch_freeable(t)
            if len(t.local["retire"]) >= self.C * self.reclaim_freq:
                # a delayed thread is suspected: publish-on-ping
                yield from self._reclaim_hp_freeable(t)

    def _reclaim_epoch_freeable(self, t: ThreadCtx) -> Generator:
        self.reclaim_calls += 1
        self.epoch_reclaims += 1
        t.stats.reclaim_events += 1
        vals = yield from self._load_many(
            t, [self.reserved_epoch + tid for tid in range(self.n)])
        m = min(vals, default=MAX_ERA)
        keep: List[int] = []
        for addr in t.local["retire"]:
            if self.retire_era.get(addr, MAX_ERA) < m:
                yield from self._free(t, addr)
            else:
                keep.append(addr)
        t.local["retire"] = keep

    _collect_counters = HazardPtrPOP._collect_counters
    _ping_all = HazardPtrPOP._ping_all
    _wait_all_published = HazardPtrPOP._wait_all_published
    _collect_reservations = HazardPtrPOP._collect_reservations
    # batched sessions share the fence-free local reservation path
    reserve_many = HazardPtrPOP.reserve_many

    def _reclaim_hp_freeable(self, t: ThreadCtx) -> Generator:
        self.pop_reclaims += 1
        snap = yield from self._collect_counters(t)
        t0 = t.now()
        yield from self._ping_all(t)
        yield from self._wait_all_published(t, snap)
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
            yield from self._reclaim_epoch_freeable(t)
        if t.local["retire"]:
            yield from self._reclaim_hp_freeable(t)
