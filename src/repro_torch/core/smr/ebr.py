"""Epoch-based reclamation (RCU-style, paper Algorithm 6) and interval-based
reclamation (IBR, 2GE variant [60]).  EBR is the fast-but-not-robust baseline;
IBR bounds garbage by reservation intervals."""

from __future__ import annotations

from typing import Generator, List, Tuple

from repro_torch.core.sim.engine import Engine, ThreadCtx
from repro_torch.core.smr.base import MAX_ERA, SMRScheme


class EBR(SMRScheme):
    """reservedEpoch announce at op start; min-scan frees strictly older retires.

    NOT robust: one stalled thread pins the minimum forever (shown by
    tests/test_smr_robustness.py and benchmarks/memory_footprint.py).
    """

    name = "EBR"
    robust = False

    def __init__(self, engine: Engine, **kw):
        super().__init__(engine, **kw)
        self.epoch = engine.alloc_shared(1)
        engine.mem.cells[self.epoch] = 1
        self.reserved = engine.alloc_shared(self.n)
        for i in range(self.n):
            engine.mem.cells[self.reserved + i] = MAX_ERA

    def thread_init(self, t: ThreadCtx) -> None:
        super().thread_init(t)
        t.local["op_counter"] = 0

    def start_op(self, t: ThreadCtx) -> Generator:
        t.local["op_counter"] += 1
        if t.local["op_counter"] % self.epoch_freq == 0:
            yield from t.faa(self.epoch, 1)
        e = yield from t.load(self.epoch)
        # announce + store-load fence, once per *operation* (amortized)
        yield from t.atomic_store(self.reserved + t.tid, e)
        yield from t.fence()

    def end_op(self, t: ThreadCtx) -> Generator:
        yield from t.store(self.reserved + t.tid, MAX_ERA)

    def read(self, t: ThreadCtx, slot: int, ptr_addr: int, decode=None) -> Generator:
        ptr = yield from t.load(ptr_addr)
        t.stats.reads += 1
        return ptr

    def alloc_node(self, t: ThreadCtx, nfields: int) -> Generator:
        addr = yield from t.alloc(nfields)
        return addr

    def retire(self, t: ThreadCtx, addr: int) -> Generator:
        e = yield from t.load(self.epoch)
        self.retire_era[addr] = e
        t.local["retire"].append(addr)
        self._account_retire(t)
        if len(t.local["retire"]) % self.reclaim_freq == 0:
            yield from self._reclaim(t)

    def _min_reserved(self, t: ThreadCtx) -> Generator:
        vals = yield from self._load_many(
            t, [self.reserved + tid for tid in range(self.n)])
        return min(vals, default=MAX_ERA)

    def _reclaim(self, t: ThreadCtx) -> Generator:
        self.reclaim_calls += 1
        t.stats.reclaim_events += 1
        m = yield from self._min_reserved(t)
        keep: List[int] = []
        for addr in t.local["retire"]:
            if self.retire_era.get(addr, MAX_ERA) < m:
                yield from self._free(t, addr)
            else:
                keep.append(addr)
        t.local["retire"] = keep

    def flush(self, t: ThreadCtx) -> Generator:
        if t.local["retire"]:
            yield from self._reclaim(t)


class IBR(EBR):
    """2GE interval-based reclamation: per-thread [lo, hi] era reservation;
    free nodes whose [birth, retire] lifespan misses every interval."""

    name = "IBR"
    robust = True  # garbage bounded by interval-intersecting nodes

    def __init__(self, engine: Engine, **kw):
        super().__init__(engine, **kw)
        self.lo = engine.alloc_shared(self.n)
        self.hi = engine.alloc_shared(self.n)
        for i in range(self.n):
            engine.mem.cells[self.lo + i] = MAX_ERA
            engine.mem.cells[self.hi + i] = 0

    def start_op(self, t: ThreadCtx) -> Generator:
        t.local["op_counter"] += 1
        if t.local["op_counter"] % self.epoch_freq == 0:
            yield from t.faa(self.epoch, 1)
        e = yield from t.load(self.epoch)
        yield from t.store(self.lo + t.tid, e)
        yield from t.atomic_store(self.hi + t.tid, e)
        yield from t.fence()
        t.local["ibr_hi"] = e

    def end_op(self, t: ThreadCtx) -> Generator:
        yield from t.store(self.lo + t.tid, MAX_ERA)
        yield from t.store(self.hi + t.tid, 0)

    def read(self, t: ThreadCtx, slot: int, ptr_addr: int, decode=None) -> Generator:
        while True:
            ptr = yield from t.load(ptr_addr)
            e = yield from t.load(self.epoch)
            t.stats.reads += 1
            if e == t.local["ibr_hi"]:
                return ptr
            # era moved mid-read: extend the interval and re-validate
            yield from t.store(self.hi + t.tid, e)
            yield from t.fence()
            t.local["ibr_hi"] = e

    def alloc_node(self, t: ThreadCtx, nfields: int) -> Generator:
        addr = yield from t.alloc(nfields)
        era = yield from t.load(self.epoch)
        self.birth[addr] = era
        return addr

    def _reclaim(self, t: ThreadCtx) -> Generator:
        self.reclaim_calls += 1
        t.stats.reclaim_events += 1
        los = yield from self._load_many(
            t, [self.lo + tid for tid in range(self.n)])
        his = yield from self._load_many(
            t, [self.hi + tid for tid in range(self.n)])
        ivals: List[Tuple[int, int]] = [(l, h) for l, h in zip(los, his)
                                        if l <= h]
        keep: List[int] = []
        for addr in t.local["retire"]:
            b = self.birth.get(addr, 0)
            r = self.retire_era.get(addr, MAX_ERA)
            if any(not (r < l or b > h) for (l, h) in ivals):
                keep.append(addr)
            else:
                yield from self._free(t, addr)
        t.local["retire"] = keep
