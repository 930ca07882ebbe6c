"""Lazy list (LL) [Heller et al. '05]: wait-free-ish traversals, lock-based
updates with logical marking.  Node: [KEY, NEXT, MARK, LOCK]."""

from __future__ import annotations

from typing import Generator

from repro_torch.core.sim.engine import NULL, Engine, ThreadCtx
from repro_torch.core.smr.base import SMRScheme

KEY, NEXT, MARK, LOCK = 0, 1, 2, 3
MINKEY, MAXKEY = -(1 << 40), 1 << 40


class LazyList:
    SLOTS = 3

    def __init__(self, engine: Engine, smr: SMRScheme):
        self.engine = engine
        self.smr = smr
        a = engine.mem.alloc
        self.head = a.alloc(4)
        self.tail = a.alloc(4)
        engine.mem.cells[self.head + KEY] = MINKEY
        engine.mem.cells[self.head + NEXT] = self.tail
        engine.mem.cells[self.tail + KEY] = MAXKEY

    # ---- lock helpers (CAS spin) ----

    def _lock(self, t: ThreadCtx, node: int) -> Generator:
        while True:
            ok = yield from t.cas(node + LOCK, 0, 1 + t.tid)
            if ok:
                return
            yield from t.spin()

    def _unlock(self, t: ThreadCtx, node: int) -> Generator:
        yield from t.atomic_store(node + LOCK, 0)

    # ---- traversal: returns (pred, curr) with reservations held ----

    def _locate(self, t: ThreadCtx, key: int) -> Generator:
        smr = self.smr
        while True:
            pred = self.head
            s = 0
            curr = yield from smr.read(t, s, pred + NEXT)
            restart = False
            while True:
                if curr == NULL:      # torn traversal (pred recycled): restart
                    restart = True
                    break
                # HP-compat validation: if pred got marked, curr's reservation
                # may protect an already-unlinked suffix -- restart from head.
                pm = yield from t.load(pred + MARK)
                if pm != 0:
                    restart = True
                    break
                ckey = yield from t.load(curr + KEY)
                if ckey >= key:
                    return pred, curr, ckey
                pred = curr
                s = (s + 1) % 3
                curr = yield from smr.read(t, s, curr + NEXT)
            if restart:
                continue

    def contains(self, t: ThreadCtx, key: int) -> Generator:
        _, curr, ckey = yield from self._locate(t, key)
        if ckey != key:
            return False
        m = yield from t.load(curr + MARK)
        return m == 0

    def _validate(self, t: ThreadCtx, pred: int, curr: int) -> Generator:
        pm = yield from t.load(pred + MARK)
        cm = yield from t.load(curr + MARK)
        nx = yield from t.load(pred + NEXT)
        return pm == 0 and cm == 0 and nx == curr

    def insert(self, t: ThreadCtx, key: int) -> Generator:
        smr = self.smr
        while True:
            pred, curr, ckey = yield from self._locate(t, key)
            yield from smr.enter_write(t, [pred, curr])
            yield from self._lock(t, pred)
            ok = yield from self._validate(t, pred, curr)
            if not ok:
                yield from self._unlock(t, pred)
                yield from smr.exit_write(t)
                continue
            if ckey == key:
                yield from self._unlock(t, pred)
                yield from smr.exit_write(t)
                return False
            new = yield from smr.alloc_node(t, 4)
            t.local["pending_alloc"] = new
            yield from t.store(new + KEY, key)
            yield from t.store(new + NEXT, curr)
            yield from t.atomic_store(pred + NEXT, new)
            t.local["pending_alloc"] = None
            yield from self._unlock(t, pred)
            yield from smr.exit_write(t)
            return True

    def delete(self, t: ThreadCtx, key: int) -> Generator:
        smr = self.smr
        while True:
            pred, curr, ckey = yield from self._locate(t, key)
            if ckey != key:
                return False
            yield from smr.enter_write(t, [pred, curr])
            yield from self._lock(t, pred)
            yield from self._lock(t, curr)
            ok = yield from self._validate(t, pred, curr)
            if not ok:
                yield from self._unlock(t, curr)
                yield from self._unlock(t, pred)
                yield from smr.exit_write(t)
                continue
            nxt = yield from t.load(curr + NEXT)
            yield from t.atomic_store(curr + MARK, 1)   # logical
            yield from t.atomic_store(pred + NEXT, nxt)  # physical
            yield from self._unlock(t, curr)
            yield from self._unlock(t, pred)
            yield from smr.retire(t, curr)
            yield from smr.exit_write(t)
            return True

    def snapshot_keys(self) -> list:
        mem = self.engine.mem
        for tid in range(self.engine.n):
            mem.drain_all(tid)
        out = []
        node = mem.cells[self.head + NEXT]
        while node != self.tail:
            if mem.cells[node + MARK] == 0:
                out.append(mem.cells[node + KEY])
            node = mem.cells[node + NEXT]
        return out
