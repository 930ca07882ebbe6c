"""DGT-style external binary search tree [20]: lock-free searches, lock-based
updates (BST-TK flavor).  Internal nodes route; leaves hold keys.

Node layout: [KEY, LEFT, RIGHT, LOCK, MARK, ISLEAF].
SMR discipline: rotating reservations over (gparent, parent, leaf).
"""

from __future__ import annotations

from typing import Generator

from repro_torch.core.sim.engine import NULL, Engine, ThreadCtx
from repro_torch.core.smr.base import SMRScheme

KEY, LEFT, RIGHT, LOCK, MARK, ISLEAF = 0, 1, 2, 3, 4, 5
INF = 1 << 41


class ExternalBST:
    SLOTS = 4

    def __init__(self, engine: Engine, smr: SMRScheme):
        self.engine = engine
        self.smr = smr
        a = engine.mem.alloc
        # sentinels: root internal (key=+INF) with two leaf children
        self.root = a.alloc(6)
        lmin = a.alloc(6)
        lmax = a.alloc(6)
        c = engine.mem.cells
        c[self.root + KEY] = INF
        c[self.root + LEFT] = lmin
        c[self.root + RIGHT] = lmax
        c[lmin + KEY] = -INF
        c[lmin + ISLEAF] = 1
        c[lmax + KEY] = INF
        c[lmax + ISLEAF] = 1

    def _child_cell(self, node: int, key: int, node_key: int) -> int:
        return node + (LEFT if key < node_key else RIGHT)

    def _locate(self, t: ThreadCtx, key: int) -> Generator:
        """Descend to a leaf; returns (gp, p, leaf, leaf_key) with
        reservations held (slots: rotating over 4)."""
        smr = self.smr
        while True:
            gp = NULL
            p = self.root
            pkey = INF
            s = 0
            leaf = yield from smr.read(t, s, self._child_cell(p, key, pkey))
            restart = False
            while True:
                if leaf == NULL:
                    restart = True
                    break
                # validation: a marked parent means our reserved child may be
                # an unlinked subtree -- restart (cf. lazy list).
                pmark = yield from t.load(p + MARK)
                if pmark != 0:
                    restart = True
                    break
                is_leaf = yield from t.load(leaf + ISLEAF)
                lkey = yield from t.load(leaf + KEY)
                if is_leaf:
                    return gp, p, leaf, lkey
                gp, p, pkey = p, leaf, lkey
                s = (s + 1) % 4
                leaf = yield from smr.read(t, s, self._child_cell(p, key, pkey))
            if restart:
                continue

    def contains(self, t: ThreadCtx, key: int) -> Generator:
        _, _, _, lkey = yield from self._locate(t, key)
        return lkey == key

    def _lock(self, t: ThreadCtx, node: int) -> Generator:
        while True:
            ok = yield from t.cas(node + LOCK, 0, 1 + t.tid)
            if ok:
                return
            yield from t.spin()

    def _unlock(self, t: ThreadCtx, node: int) -> Generator:
        yield from t.atomic_store(node + LOCK, 0)

    def insert(self, t: ThreadCtx, key: int) -> Generator:
        smr = self.smr
        while True:
            gp, p, leaf, lkey = yield from self._locate(t, key)
            if lkey == key:
                return False
            pkey = yield from t.load(p + KEY)
            cell = self._child_cell(p, key, pkey)
            yield from smr.enter_write(t, [x for x in (p, leaf) if x])
            yield from self._lock(t, p)
            pm = yield from t.load(p + MARK)
            cur = yield from t.load(cell)
            if pm != 0 or cur != leaf:
                yield from self._unlock(t, p)
                yield from smr.exit_write(t)
                continue
            # build: new internal with children {new leaf, old leaf}
            nleaf = yield from smr.alloc_node(t, 6)
            t.local["pending_alloc"] = nleaf
            yield from t.store(nleaf + KEY, key)
            yield from t.store(nleaf + ISLEAF, 1)
            ninner = yield from smr.alloc_node(t, 6)
            yield from t.store(ninner + KEY, max(key, lkey))
            if key < lkey:
                yield from t.store(ninner + LEFT, nleaf)
                yield from t.store(ninner + RIGHT, leaf)
            else:
                yield from t.store(ninner + LEFT, leaf)
                yield from t.store(ninner + RIGHT, nleaf)
            yield from t.atomic_store(cell, ninner)
            t.local["pending_alloc"] = None
            yield from self._unlock(t, p)
            yield from smr.exit_write(t)
            return True

    def delete(self, t: ThreadCtx, key: int) -> Generator:
        smr = self.smr
        while True:
            gp, p, leaf, lkey = yield from self._locate(t, key)
            if lkey != key:
                return False
            if gp == NULL:       # deleting a sentinel child position: impossible
                return False
            gpkey = yield from t.load(gp + KEY)
            gcell = self._child_cell(gp, key, gpkey)
            pkey = yield from t.load(p + KEY)
            cell = self._child_cell(p, key, pkey)
            sib_cell = p + (RIGHT if cell == p + LEFT else LEFT)
            yield from smr.enter_write(t, [x for x in (gp, p, leaf) if x])
            yield from self._lock(t, gp)
            yield from self._lock(t, p)
            gpm = yield from t.load(gp + MARK)
            pm = yield from t.load(p + MARK)
            gcur = yield from t.load(gcell)
            cur = yield from t.load(cell)
            if gpm != 0 or pm != 0 or gcur != p or cur != leaf:
                yield from self._unlock(t, p)
                yield from self._unlock(t, gp)
                yield from smr.exit_write(t)
                continue
            sib = yield from t.load(sib_cell)
            yield from t.atomic_store(p + MARK, 1)
            yield from t.atomic_store(leaf + MARK, 1)
            yield from t.atomic_store(gcell, sib)
            yield from self._unlock(t, p)
            yield from self._unlock(t, gp)
            yield from smr.retire(t, p)
            yield from smr.retire(t, leaf)
            yield from smr.exit_write(t)
            return True

    def snapshot_keys(self) -> list:
        mem = self.engine.mem
        for tid in range(self.engine.n):
            mem.drain_all(tid)
        out = []
        stack = [mem.cells[self.root + LEFT]]
        while stack:
            n = stack.pop()
            if n == NULL:
                continue
            if mem.cells[n + ISLEAF]:
                k = mem.cells[n + KEY]
                if -INF < k < INF:
                    out.append(k)
            else:
                stack.append(mem.cells[n + LEFT])
                stack.append(mem.cells[n + RIGHT])
        return sorted(out)
