"""NBR+ (neutralization-based reclamation [54,57]) -- the signal-based
baseline whose *restarts* POP eliminates.

Readers run fence-free in a restartable read phase.  Before writing, a thread
publishes the handful of pointers it needs (one fence) and leaves the
restartable region.  A reclaimer signals everyone; read-phase threads are
NEUTRALIZED (their operation unwinds and restarts -- the cost that shows up in
the paper's long-running-reads experiment, Fig. 4), write-phase threads just
acknowledge.  The reclaimer then frees everything outside the published
write-phase reservations.
"""

from __future__ import annotations

from typing import Generator, List

from repro_torch.core.sim.engine import NULL, Engine, ThreadCtx
from repro_torch.core.smr.base import SMRScheme
from repro_torch.core.smr.pop import HazardPtrPOP


class NBR(SMRScheme):
    name = "NBR+"
    robust = True
    uses_signals = True
    neutralizing = True

    def __init__(self, engine: Engine, **kw):
        super().__init__(engine, **kw)
        self.res = engine.alloc_shared(self.n * self.max_hp)
        self.ack = engine.alloc_shared(self.n)   # announcement counters

    def _slot(self, tid: int, slot: int) -> int:
        return self.res + tid * self.max_hp + slot

    def thread_init(self, t: ThreadCtx) -> None:
        super().thread_init(t)
        t.local["read_phase"] = False
        t.local["ack_count"] = 0
        t.local["published"] = 0

    def start_op(self, t: ThreadCtx) -> Generator:
        t.local["read_phase"] = True   # restartable from here
        return
        yield

    def end_op(self, t: ThreadCtx) -> Generator:
        t.local["read_phase"] = False
        if t.local["published"]:
            for s in range(t.local["published"]):
                yield from t.store(self._slot(t.tid, s), NULL)
            t.local["published"] = 0
        # retires deferred from the read phase (helping unlinks) reclaim here,
        # at quiescence, where this thread holds no unprotected pointers
        if len(t.local["retire"]) >= self.reclaim_freq:
            yield from self._reclaim(t)

    def read(self, t: ThreadCtx, slot: int, ptr_addr: int, decode=None) -> Generator:
        ptr = yield from t.load(ptr_addr)   # bare load: NBR's read phase is free
        t.stats.reads += 1
        return ptr

    def enter_write(self, t: ThreadCtx, ptrs: List[int]) -> Generator:
        """Publish reservations, ONE fence, leave the restartable region."""
        for s, p in enumerate(ptrs[: self.max_hp]):
            yield from t.store(self._slot(t.tid, s), p)
        t.local["published"] = max(t.local["published"], len(ptrs))
        yield from t.fence()
        t.local["read_phase"] = False   # from here on, signals only ack

    def exit_write(self, t: ThreadCtx) -> Generator:
        # back to (restartable) read phase; reservations stay until end_op
        t.local["read_phase"] = True
        return
        yield

    def reserve_many(self, t: ThreadCtx, ptr_addrs, decode=None) -> Generator:
        """Batched session reserve: bare loads, then publish the whole batch
        with enter_write's single fence.  The session runs outside the
        restartable region, so pings during it only acknowledge."""
        ptrs = yield from self._load_many(t, ptr_addrs)
        t.stats.reads += len(ptr_addrs)
        nodes = [decode(p) if decode else p for p in ptrs]
        yield from self.enter_write(t, nodes)
        return ptrs

    def clear_many(self, t: ThreadCtx) -> Generator:
        if t.local["published"]:
            for s in range(t.local["published"]):
                yield from t.store(self._slot(t.tid, s), NULL)
            t.local["published"] = 0
        t.local["read_phase"] = False

    def handler(self, t: ThreadCtx) -> Generator:
        if t.local["read_phase"]:
            t.pending_neutralize = True   # longjmp out of the operation
        t.local["ack_count"] += 1
        yield from t.store(self.ack + t.tid, t.local["ack_count"])
        yield from t.fence()

    def retire(self, t: ThreadCtx, addr: int) -> Generator:
        t.local["retire"].append(addr)
        self._account_retire(t)
        if t.local["read_phase"]:
            # NBR discipline: no reclamation from the (unprotected) read
            # phase -- a reclaim here could free nodes this very traversal
            # still holds bare pointers to.  Defer to end_op/quiescence.
            return
        if len(t.local["retire"]) >= self.reclaim_freq:
            yield from self._reclaim(t)

    def _collect_acks(self, t: ThreadCtx) -> Generator:
        snap = yield from self._load_many(
            t, [self.ack + tid for tid in range(self.n)])
        return snap

    _ping_all = HazardPtrPOP._ping_all

    def _wait_acks(self, t: ThreadCtx, snap: List[int]) -> Generator:
        for tid in range(self.n):
            if tid == t.tid or self.engine.threads[tid].done:
                continue
            while True:
                v = yield from t.load(self.ack + tid)
                if v > snap[tid]:
                    break
                yield from t.spin()
                if self.engine.threads[tid].done:
                    break

    def _reclaim(self, t: ThreadCtx) -> Generator:
        self.reclaim_calls += 1
        t.stats.reclaim_events += 1
        snap = yield from self._collect_acks(t)
        t0 = t.now()
        yield from self._ping_all(t)
        yield from self._wait_acks(t, snap)
        self._note_ping_stall(t, t0)
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
