"""Hyaline (Nikolaev & Ravindran [arXiv:1905.07903]) -- snapshot-free
reclamation by per-slot reference-counted retirement lists.

Where the HP/HE/POP family makes *readers* advertise what they hold (and
reclaimers scan), Hyaline inverts the flow: readers only mark themselves
active, and *retiring* threads hand each active reader its share of the
garbage.  Per reservation slot there is a packed head word ``(HRef,
HPtr)``: ``HRef`` counts active readers, ``HPtr`` heads a list of batch
descriptors.  ENTER is one FAA (no per-read work afterwards); LEAVE is one
FAA plus a walk of the descriptors inserted during the operation, handing
back one reference per batch; a batch is freed by whoever returns its last
reference (the refs cell reaching zero after the inserter's adjustment).

Host adaptations (sim idioms, see DESIGN.md §8.2):

* one reservation slot per thread (the paper's one-slot-per-CPU layout at
  nthreads CPUs), so ``HRef`` is 0/1 and only the owner FAAs it;
* batch descriptors live in simulated memory (2 cells: next, refs-cell
  address) but are *named* by monotonically increasing ids in the packed
  head word -- the sim's stand-in for the paper's pointer-tagging ABA
  defense: a traversal's stop-at-handle comparison can never be fooled by
  a recycled address;
* robustness ("-S" variant): nodes carry birth eras, readers publish an
  access era at ENTER (made visible by the ENTER FAA's full barrier) and
  re-publish + fence when the era moves mid-read (the Hazard-Eras read
  protocol, amortized to era changes).  A retiring thread SKIPS any slot
  whose published access era predates the batch's minimum birth era --
  that reader can never legally dereference those nodes -- so a stalled or
  crashed reader only ever pins batches containing nodes born before it
  went quiet: bounded garbage, like HE and unlike plain Hyaline/EBR.
  This inherits HE's protection rule (and its known structural caveats)
  rather than re-proving it; the litmus and gauntlet suites exercise it.
"""

from __future__ import annotations

from typing import Dict, Generator, List, Tuple

from repro_torch.core.sim.engine import Engine, ThreadCtx
from repro_torch.core.smr.base import SMRScheme

#: packed head word: href * REF_UNIT + head_descriptor_id
REF_UNIT = 1 << 44
PTR_MASK = REF_UNIT - 1
#: descriptor fields (2 simulated cells)
DNEXT, DREFS = 0, 1


class Hyaline(SMRScheme):
    name = "Hyaline"
    robust = True
    uses_signals = False

    def __init__(self, engine: Engine, **kw):
        super().__init__(engine, **kw)
        self.heads = engine.alloc_shared(self.n)     # packed (HRef, HPtr) per slot
        self.access = engine.alloc_shared(self.n)    # published access eras
        self.epoch = engine.alloc_shared(1)
        engine.mem.cells[self.epoch] = 1
        # engine-side descriptor naming: id -> sim address (ids are never
        # reused, so the traversal's handle comparison is ABA-free)
        self._desc_addr: Dict[int, int] = {}
        self._next_id = 1
        # refs-cell addr -> (node addrs, [(desc addr, desc id)])
        self._batches: Dict[int, Tuple[List[int], List[Tuple[int, int]]]] = {}

    # ---- lifecycle ----

    def thread_init(self, t: ThreadCtx) -> None:
        super().thread_init(t)
        t.local["hy_handle"] = None     # head id captured at ENTER
        t.local["hy_era"] = 0           # last era this thread published

    def start_op(self, t: ThreadCtx) -> Generator:
        """ENTER: publish the access era, then one FAA on the own head.
        The FAA is a full barrier, so the era store is globally visible by
        the time HRef shows this reader active -- an inserter that sees
        HRef > 0 also sees a current access era."""
        e = yield from t.load(self.epoch)
        yield from t.store(self.access + t.tid, e)
        old = yield from t.faa(self.heads + t.tid, REF_UNIT)
        t.local["hy_handle"] = old & PTR_MASK
        t.local["hy_era"] = e

    def end_op(self, t: ThreadCtx) -> Generator:
        """LEAVE: one FAA, then hand back one reference per batch inserted
        during the operation (current head down to the ENTER handle)."""
        handle = t.local["hy_handle"]
        if handle is None:
            return
        t.local["hy_handle"] = None
        old = yield from t.faa(self.heads + t.tid, -REF_UNIT)
        cur = old & PTR_MASK
        while cur != handle:
            d = self._desc_addr[cur]
            nxt = yield from t.load(d + DNEXT)
            refs_cell = yield from t.load(d + DREFS)
            o = yield from t.faa(refs_cell, -1)
            if o - 1 == 0:
                yield from self._free_batch(t, refs_cell)
            cur = nxt

    def read(self, t: ThreadCtx, slot: int, ptr_addr: int, decode=None) -> Generator:
        """Transparent while the global era stands still (one extra load);
        on an era move, re-publish the access era and re-validate -- the
        Hazard-Eras read protocol with a single per-thread era."""
        era = t.local["hy_era"]
        while True:
            ptr = yield from t.load(ptr_addr)
            e = yield from t.load(self.epoch)
            t.stats.reads += 1
            if e == era:
                return ptr
            yield from t.store(self.access + t.tid, e)
            yield from t.fence()
            t.local["hy_era"] = era = e

    def alloc_node(self, t: ThreadCtx, nfields: int) -> Generator:
        addr = yield from t.alloc(nfields)
        era = yield from t.load(self.epoch)
        self.birth[addr] = era
        return addr

    # ---- retire / batch insertion ----

    def retire(self, t: ThreadCtx, addr: int) -> Generator:
        t.local["retire"].append(addr)
        self._account_retire(t)
        if len(t.local["retire"]) >= self.reclaim_freq:
            yield from self._insert_batch(t)

    def _insert_batch(self, t: ThreadCtx) -> Generator:
        """Hand the pending batch to every active (and era-eligible) slot.

        Per slot: read the packed head; skip if idle (HRef == 0) or if the
        published access era predates the batch's minimum birth era (the
        robust skip); otherwise link a fresh descriptor and CAS the head.
        Afterwards add the total captured HRef to the refs cell; whoever
        brings the sum to zero -- possibly this very FAA, when every slot
        was skipped -- frees the batch.
        """
        batch = t.local["retire"]
        t.local["retire"] = []
        self.reclaim_calls += 1
        t.stats.reclaim_events += 1
        yield from t.faa(self.epoch, 1)       # era clock: ages quiet readers
        min_birth = min(self.birth.get(a, 0) for a in batch)
        refs_cell = yield from t.alloc(1)     # starts at 0
        placed: List[Tuple[int, int]] = []
        adj = 0
        for tid in range(self.n):
            d = 0
            did = 0
            while True:
                cur = yield from t.load(self.heads + tid)
                r = cur // REF_UNIT
                if r == 0:
                    break                     # idle slot: no hand-off needed
                acc = yield from t.load(self.access + tid)
                if acc < min_birth:
                    break                     # robust skip: reader is too old
                if not d:
                    d = yield from t.alloc(2)
                    did = self._next_id
                    self._next_id += 1
                    self._desc_addr[did] = d
                yield from t.store(d + DNEXT, cur & PTR_MASK)
                yield from t.store(d + DREFS, refs_cell)
                # the CAS drains the descriptor stores before the head moves
                ok = yield from t.cas(self.heads + tid, cur, r * REF_UNIT + did)
                if ok:
                    adj += r
                    placed.append((d, did))
                    d = 0
                    break
            if d:                             # allocated but ultimately skipped
                del self._desc_addr[did]
                yield from t.free(d)
        self._batches[refs_cell] = (batch, placed)
        old = yield from t.faa(refs_cell, adj)
        if old + adj == 0:
            yield from self._free_batch(t, refs_cell)

    def _free_batch(self, t: ThreadCtx, refs_cell: int) -> Generator:
        nodes, placed = self._batches.pop(refs_cell)
        for addr in nodes:
            yield from self._free(t, addr)
        for d, did in placed:
            del self._desc_addr[did]
            yield from t.free(d)
        yield from t.free(refs_cell)

    def flush(self, t: ThreadCtx) -> Generator:
        if t.local["retire"]:
            yield from self._insert_batch(t)
