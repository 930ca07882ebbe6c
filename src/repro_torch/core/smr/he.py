"""Hazard Eras [51] (paper Algorithm 4): reserve *eras*, fence only when the
global era moved since the slot's last published value."""

from __future__ import annotations

from typing import Generator, List

from repro_torch.core.sim.engine import Engine, ThreadCtx
from repro_torch.core.smr.base import MAX_ERA, SMRScheme

NONE_ERA = 0


class HazardEras(SMRScheme):
    name = "HE"
    robust = True

    def __init__(self, engine: Engine, **kw):
        super().__init__(engine, **kw)
        self.res = engine.alloc_shared(self.n * self.max_hp)
        self.epoch = engine.alloc_shared(1)
        engine.mem.cells[self.epoch] = 1

    def _slot(self, tid: int, slot: int) -> int:
        return self.res + tid * self.max_hp + slot

    def thread_init(self, t: ThreadCtx) -> None:
        super().thread_init(t)
        t.local["he_mirror"] = [NONE_ERA] * self.max_hp  # avoids re-loading own SWMR slot

    def alloc_node(self, t: ThreadCtx, nfields: int) -> Generator:
        addr = yield from t.alloc(nfields)
        era = yield from t.load(self.epoch)
        self.birth[addr] = era
        return addr

    def read(self, t: ThreadCtx, slot: int, ptr_addr: int, decode=None) -> Generator:
        old_era = t.local["he_mirror"][slot]
        while True:
            ptr = yield from t.load(ptr_addr)
            new_era = yield from t.load(self.epoch)
            t.stats.reads += 1
            if old_era == new_era:
                return ptr
            # era moved: publish the new reservation, with the store-load
            # fence the original algorithm cannot avoid
            yield from t.store(self._slot(t.tid, slot), new_era)
            yield from t.fence()
            t.local["he_mirror"][slot] = new_era
            old_era = new_era

    def clear(self, t: ThreadCtx) -> Generator:
        for s in range(self.max_hp):
            if t.local["he_mirror"][s] != NONE_ERA:
                yield from t.store(self._slot(t.tid, s), NONE_ERA)
                t.local["he_mirror"][s] = NONE_ERA

    def retire(self, t: ThreadCtx, addr: int) -> Generator:
        era = yield from t.load(self.epoch)
        self.retire_era[addr] = era
        t.local["retire"].append(addr)
        self._account_retire(t)
        if len(t.local["retire"]) >= self.reclaim_freq:
            yield from t.faa(self.epoch, 1)
            yield from self._reclaim(t)

    def reserve_many(self, t: ThreadCtx, ptr_addrs, decode=None) -> Generator:
        """Batched era reserve: one gather for the batch (on vec), then --
        only when the global era moved -- one publish + ONE fence for the
        whole batch instead of a fence per slot."""
        mirror = t.local["he_mirror"]
        n = len(ptr_addrs)
        while True:
            ptrs = yield from self._load_many(t, ptr_addrs)
            new_era = yield from t.load(self.epoch)
            t.stats.reads += n
            if all(mirror[i] == new_era for i in range(n)):
                return ptrs
            for i in range(n):
                if mirror[i] != new_era:
                    yield from t.store(self._slot(t.tid, i), new_era)
                    mirror[i] = new_era
            yield from t.fence()
            # loop: revalidate the batch under the now-published era

    def _collect(self, t: ThreadCtx) -> Generator:
        slots = [self._slot(tid, s) for tid in range(self.n)
                 for s in range(self.max_hp)]
        vals = yield from self._load_many(t, slots)
        return [v for v in vals if v != NONE_ERA]

    def _reclaim(self, t: ThreadCtx) -> Generator:
        self.reclaim_calls += 1
        t.stats.reclaim_events += 1
        eras = yield from self._collect(t)
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
            yield from self._reclaim(t)
