"""Harris-Michael lock-free linked-list set (HML) -- the paper's core
traversal-bound benchmark structure.

Node layout: [KEY, NEXT] where NEXT encodes ``(successor_addr << 1) | mark``.
SMR discipline: three rotating reservation slots (prev, curr, next); the
``decode`` passed to ``smr.read`` strips the mark bit so reservations hold
node addresses.
"""

from __future__ import annotations

from typing import Generator

from repro_torch.core.sim.engine import NULL, Engine, ThreadCtx
from repro_torch.core.smr.base import SMRScheme

KEY, NEXT = 0, 1
_decode = lambda raw: raw >> 1  # noqa: E731


class HarrisMichaelList:
    SLOTS = 3

    def __init__(self, engine: Engine, smr: SMRScheme, head_cell: int = 0):
        self.engine = engine
        self.smr = smr
        # the head pointer cell is structure-lifetime (never retired)
        self.head = head_cell if head_cell else engine.alloc_shared(1)

    # ---- Michael's find with physical helping of marked nodes ----

    def _search(self, t: ThreadCtx, key: int) -> Generator:
        """Return (prev_cell, curr, next, curr_key); reservations held on return."""
        smr = self.smr
        while True:
            prev_cell = self.head
            # explicit slot bookkeeping: s_prev holds the predecessor's
            # reservation and MUST NOT be overwritten while prev stands still
            # (the helping branch advances curr but not prev)
            s_prev, s_curr = 2, 0
            raw_curr = yield from smr.read(t, s_curr, prev_cell, decode=_decode)
            retry = False
            while True:
                curr = raw_curr >> 1
                if curr == NULL:
                    return prev_cell, NULL, NULL, 0
                s_next = 3 - s_prev - s_curr      # the one free slot
                raw_next = yield from smr.read(t, s_next, curr + NEXT, decode=_decode)
                nxt, cmark = raw_next >> 1, raw_next & 1
                v = yield from t.load(prev_cell)
                if v != curr << 1:          # prev moved or got marked: restart
                    retry = True
                    break
                if cmark:
                    # help unlink the logically-deleted curr
                    ok = yield from t.cas(prev_cell, curr << 1, nxt << 1)
                    if not ok:
                        retry = True
                        break
                    yield from smr.retire(t, curr)
                    raw_curr = nxt << 1
                    s_curr = s_next           # prev (and its slot) stand still
                    continue
                ckey = yield from t.load(curr + KEY)
                if ckey >= key:
                    return prev_cell, curr, nxt, ckey
                prev_cell = curr + NEXT
                raw_curr = raw_next
                s_prev, s_curr = s_curr, s_next
            if retry:
                continue

    def contains(self, t: ThreadCtx, key: int) -> Generator:
        _, curr, _, ckey = yield from self._search(t, key)
        return curr != NULL and ckey == key

    def insert(self, t: ThreadCtx, key: int) -> Generator:
        smr = self.smr
        new = NULL
        while True:
            prev_cell, curr, nxt, ckey = yield from self._search(t, key)
            if curr != NULL and ckey == key:
                if new != NULL:
                    t.local["pending_alloc"] = None
                    yield from t.free(new)   # private node, never linked
                return False
            if new == NULL:
                new = yield from smr.alloc_node(t, 2)
                t.local["pending_alloc"] = new
                yield from t.store(new + KEY, key)
            yield from t.store(new + NEXT, curr << 1)
            prevnode = prev_cell - NEXT if prev_cell != self.head else NULL
            yield from smr.enter_write(t, [p for p in (prevnode, curr) if p])
            ok = yield from t.cas(prev_cell, curr << 1, new << 1)
            yield from smr.exit_write(t)
            if ok:
                t.local["pending_alloc"] = None
                return True

    def delete(self, t: ThreadCtx, key: int) -> Generator:
        smr = self.smr
        while True:
            prev_cell, curr, nxt, ckey = yield from self._search(t, key)
            if curr == NULL or ckey != key:
                return False
            prevnode = prev_cell - NEXT if prev_cell != self.head else NULL
            yield from smr.enter_write(t, [p for p in (prevnode, curr, nxt) if p])
            # logical delete: set mark bit on curr.next
            ok = yield from t.cas(curr + NEXT, nxt << 1, (nxt << 1) | 1)
            if not ok:
                yield from smr.exit_write(t)
                continue
            # physical unlink (helpers may do it if we fail)
            ok2 = yield from t.cas(prev_cell, curr << 1, nxt << 1)
            if ok2:
                yield from smr.retire(t, curr)
            yield from smr.exit_write(t)
            return True

    # ---- non-concurrent helpers (tests / prefill verification) ----

    def snapshot_keys(self) -> list:
        """Engine-side walk of the (quiesced) list; applies no memory model."""
        mem = self.engine.mem
        out = []
        raw = mem.cells[self.head]
        # include any straggler buffered stores
        for tid in range(self.engine.n):
            mem.drain_all(tid)
        raw = mem.cells[self.head]
        while raw >> 1:
            node = raw >> 1
            nxt = mem.cells[node + NEXT]
            if not (nxt & 1):
                out.append(mem.cells[node + KEY])
            raw = nxt
        return out
