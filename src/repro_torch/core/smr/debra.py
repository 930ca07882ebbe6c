"""DEBRA+ (Brown [arXiv:1712.01044]) -- epoch-based reclamation made
robust by signal-driven neutralization.

DEBRA is distributed EBR: threads announce an epoch at operation start and
quiesce at operation end; reclaimers free bags whose retire epoch predates
the minimum announcement.  The "+" adds fault tolerance: when the retire
list keeps growing past the epoch path (a reader is stalled and pinning the
minimum), the reclaimer signals every thread.  A thread caught in its
restartable read phase is NEUTRALIZED -- its announcement is set to
quiescent and its operation unwinds and restarts -- so a stalled or even
crashed reader stops holding the epoch back.  Threads past their read
phase (holding published reservations, the NBR discipline this repo
already models) just acknowledge.  After every live thread has responded
(dead ones return ESRCH), the reclaimer re-scans the minimum over live
announcements and frees everything older that is not in a published
reservation.

Contrast with the paper's POP schemes: DEBRA+ signals restart readers
(the long-running-read cost of Fig. 4), POP signals only *publish* --
both appear in the gauntlet's signal-delay sweep, where each ping-based
scheme's ``max_ping_stall`` stretches with the injected delivery delay.
"""

from __future__ import annotations

from typing import Generator, List

from repro_torch.core.sim.engine import NULL, Engine, ThreadCtx
from repro_torch.core.smr.base import MAX_ERA, SMRScheme
from repro_torch.core.smr.nbr import NBR
from repro_torch.core.smr.pop import HazardPtrPOP


class DebraPlus(SMRScheme):
    name = "DEBRA+"
    robust = True
    uses_signals = True
    neutralizing = True

    def __init__(self, engine: Engine, C: int = 2, **kw):
        super().__init__(engine, **kw)
        self.C = C
        self.epoch = engine.alloc_shared(1)
        engine.mem.cells[self.epoch] = 1
        self.announced = engine.alloc_shared(self.n)
        for i in range(self.n):
            engine.mem.cells[self.announced + i] = MAX_ERA
        self.res = engine.alloc_shared(self.n * self.max_hp)
        self.ack = engine.alloc_shared(self.n)
        self.epoch_reclaims = 0
        self.ping_reclaims = 0
        self.neutralizations = 0

    def _slot(self, tid: int, slot: int) -> int:
        return self.res + tid * self.max_hp + slot

    def thread_init(self, t: ThreadCtx) -> None:
        super().thread_init(t)
        t.local["op_counter"] = 0
        t.local["read_phase"] = False
        t.local["deferred"] = False
        t.local["ack_count"] = 0
        t.local["published"] = 0

    # ---- DEBRA fast path: EBR-style announce / quiesce ----

    def start_op(self, t: ThreadCtx) -> Generator:
        t.local["op_counter"] += 1
        if t.local["op_counter"] % self.epoch_freq == 0:
            yield from t.faa(self.epoch, 1)
        e = yield from t.load(self.epoch)
        yield from t.atomic_store(self.announced + t.tid, e)
        yield from t.fence()
        t.local["read_phase"] = True   # restartable (neutralizable) from here

    def end_op(self, t: ThreadCtx) -> Generator:
        t.local["read_phase"] = False
        yield from t.store(self.announced + t.tid, MAX_ERA)
        if t.local["published"]:
            for s in range(t.local["published"]):
                yield from t.store(self._slot(t.tid, s), NULL)
            t.local["published"] = 0
        # retires deferred from the read phase reclaim here, at quiescence
        # (only when this op actually deferred some: leftover pinned nodes
        # alone retry at the next retire, keeping reclaim-call counts a
        # schedule-independent function of the retire count)
        if t.local["deferred"]:
            t.local["deferred"] = False
            if len(t.local["retire"]) >= self.reclaim_freq:
                yield from self._reclaim(t)

    def read(self, t: ThreadCtx, slot: int, ptr_addr: int, decode=None) -> Generator:
        ptr = yield from t.load(ptr_addr)   # bare load: the epoch protects
        t.stats.reads += 1
        return ptr

    # ---- write-phase reservations (the NBR discipline; keeps sessions
    # and structure writers safe across a neutralizing ping) ----

    enter_write = NBR.enter_write
    exit_write = NBR.exit_write
    reserve_many = NBR.reserve_many
    clear_many = NBR.clear_many

    # ---- signal handler: neutralize read-phase threads, always ack ----

    def handler(self, t: ThreadCtx) -> Generator:
        if t.local["read_phase"]:
            # The engine guarantees a neutralized body executes no further
            # simulated op before unwinding, so it is safe to quiesce its
            # announcement here: it will re-announce at the restart.
            t.pending_neutralize = True
            t.local["read_phase"] = False
            self.neutralizations += 1
            yield from t.store(self.announced + t.tid, MAX_ERA)
        t.local["ack_count"] += 1
        yield from t.store(self.ack + t.tid, t.local["ack_count"])
        yield from t.fence()

    # ---- retire / reclaim: epoch fast path, neutralizing fallback ----

    def retire(self, t: ThreadCtx, addr: int) -> Generator:
        e = yield from t.load(self.epoch)
        self.retire_era[addr] = e
        t.local["retire"].append(addr)
        self._account_retire(t)
        if t.local["read_phase"]:
            t.local["deferred"] = True
            return   # no reclaim from the restartable region; defer to end_op
        if len(t.local["retire"]) >= self.reclaim_freq:
            yield from self._reclaim(t)

    def _min_live_announced(self, t: ThreadCtx, live_only: bool) -> Generator:
        tids = [tid for tid in range(self.n)
                if not (live_only and self.engine.threads[tid].done)]
        vals = yield from self._load_many(
            t, [self.announced + tid for tid in tids])
        return min(vals, default=MAX_ERA)

    def _epoch_sweep(self, t: ThreadCtx, m: int, reserved) -> Generator:
        keep: List[int] = []
        for addr in t.local["retire"]:
            if self.retire_era.get(addr, MAX_ERA) < m and addr not in reserved:
                yield from self._free(t, addr)
            else:
                keep.append(addr)
        t.local["retire"] = keep

    def _reclaim(self, t: ThreadCtx) -> Generator:
        self.reclaim_calls += 1
        self.epoch_reclaims += 1
        t.stats.reclaim_events += 1
        m = yield from self._min_live_announced(t, live_only=False)
        yield from self._epoch_sweep(t, m, ())
        if len(t.local["retire"]) >= self.C * self.reclaim_freq:
            # a stalled (or dead) reader is pinning the minimum: neutralize
            yield from self._reclaim_neutralize(t)

    _collect_acks = NBR._collect_acks
    _ping_all = HazardPtrPOP._ping_all
    _wait_acks = NBR._wait_acks

    def _reclaim_neutralize(self, t: ThreadCtx) -> Generator:
        self.ping_reclaims += 1
        snap = yield from self._collect_acks(t)
        t0 = t.now()
        yield from self._ping_all(t)
        yield from self._wait_acks(t, snap)
        self._note_ping_stall(t, t0)
        # every live read-phase thread is now quiescent; dead threads
        # returned ESRCH from the ping and are excluded from the minimum
        m = yield from self._min_live_announced(t, live_only=True)
        slots = [self._slot(tid, s) for tid in range(self.n)
                 for s in range(self.max_hp)]
        vals = yield from self._load_many(t, slots)
        reserved = {v for v in vals if v != NULL}
        yield from self._epoch_sweep(t, m, reserved)

    def flush(self, t: ThreadCtx) -> Generator:
        if t.local["retire"]:
            m = yield from self._min_live_announced(t, live_only=False)
            yield from self._epoch_sweep(t, m, ())
        if t.local["retire"]:
            yield from self._reclaim_neutralize(t)
