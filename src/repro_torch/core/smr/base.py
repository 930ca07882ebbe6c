"""Common SMR interface (the paper's programmer view, §4.1.1).

Every scheme exposes the same five per-read calls the paper's setbench
uses, all as simulator generators:

    start_op / read(slot, ptr_addr) / clear / retire(addr) / end_op

plus ``alloc_node`` (so era-based schemes can tag birth eras), an optional
``enter_write`` hook (a no-op everywhere except NBR+, which publishes its
reservations and leaves the restartable region there), and the **batched
reader sessions** the serving runtime drives -- ``reserve_many`` /
``clear_many`` protect a whole working set (a decode step's dozens of KV
blocks) in one call, with ``_load_many`` routing the underlying loads
through the vec backend's single-gather path.  The default batched
implementations fall back to the per-read loop, so a scheme only overrides
them to amortize its publication cost (see each scheme's override and
docs/SCHEMES.md for the per-scheme batching behavior).

Data structures are written once against this interface and run unchanged
under all eleven registered schemes -- the paper's "drop-in replacement"
property -- and so does the serving block pool, which plugs any of them in
through ``runtime/reclaim.py::SimulatedSMRPolicy``.
"""

from __future__ import annotations

from typing import Dict, Generator, List

from repro_torch.core.sim.engine import Engine, ThreadCtx

MAX_ERA = 1 << 60


class SMRScheme:
    name = "base"
    robust = True
    uses_signals = False

    def __init__(
        self,
        engine: Engine,
        max_hp: int = 8,
        reclaim_freq: int = 64,
        epoch_freq: int = 32,
    ):
        self.engine = engine
        self.n = engine.n
        self.max_hp = max_hp
        self.reclaim_freq = reclaim_freq
        self.epoch_freq = epoch_freq
        # era metadata (engine-side bookkeeping, see DESIGN.md §8.2)
        self.birth: Dict[int, int] = {}
        self.retire_era: Dict[int, int] = {}
        # global garbage accounting (for the paper's memory plots)
        self.garbage = 0
        self.garbage_peak = 0
        self.frees = 0
        self.reclaim_calls = 0
        # longest simulated-cycle span a reclaimer spent blocked between
        # pinging and seeing every response (signal-based schemes update it;
        # 0.0 for schemes that never ping).  The gauntlet reports it in
        # seconds at the 1 GHz simulated-clock convention.
        self.max_ping_stall = 0.0
        # optional observer called as free_hook(t, addr) on every free --
        # the gauntlet uses it to timestamp crash recovery
        self.free_hook = None
        # optional observer called as ping_hook(t, t0, t1) for every timed
        # ping->all-acks span (simulated cycles) -- the gauntlet records the
        # full stall distribution (ping_stall_p99_s) and emits cycle-domain
        # trace spans through it
        self.ping_hook = None

    # ---- lifecycle ----

    def thread_init(self, t: ThreadCtx) -> None:
        t.local["retire"] = []

    def handler(self, t: ThreadCtx) -> Generator:
        """Signal handler body; schemes that use signals override."""
        return
        yield  # pragma: no cover

    # ---- programmer interface ----

    def start_op(self, t: ThreadCtx) -> Generator:
        return
        yield

    def end_op(self, t: ThreadCtx) -> Generator:
        yield from self.clear(t)

    def read(self, t: ThreadCtx, slot: int, ptr_addr: int, decode=None) -> Generator:
        """Protected read of *ptr_addr.  ``decode`` maps the raw cell value to
        the node address to reserve (e.g. stripping a mark bit)."""
        raise NotImplementedError

    def clear(self, t: ThreadCtx) -> Generator:
        return
        yield

    # ---- batched reader sessions (serving-runtime granularity) ----
    #
    # A decode step of the paged serving runtime touches dozens of KV blocks
    # at once.  reserve_many/clear_many let such a reader protect the whole
    # working set in one call, so schemes can amortize their publication cost
    # across the batch -- POP schemes stay fully local (one publish per PING,
    # not per block), HP pays ONE store-load fence per batch instead of one
    # per block.  The default is the per-read loop, correct for every scheme.

    @staticmethod
    def _load_many(t: ThreadCtx, addrs: List[int]) -> Generator:
        """Batched load helper: one vectorized gather (with the vectorized
        use-after-free sweep) on backends that expose ``load_many`` (the vec
        engine), a plain per-address loop elsewhere.  Cost and stats
        accounting are identical either way (n loads, n * load-cost), so the
        gen/vec equivalence suite holds; only the Python-level overhead
        changes -- a reclaimer slot scan over N*H reservations becomes ONE
        numpy gather instead of N*H inline loads."""
        load_many = getattr(t, "load_many", None)
        if load_many is not None:
            vals = yield from load_many(addrs)
            return vals
        vals = []
        for a in addrs:
            v = yield from t.load(a)
            vals.append(v)
        return vals

    def reserve_many(self, t: ThreadCtx, ptr_addrs: List[int], decode=None) -> Generator:
        """Protect *ptr_addrs[i] in reservation slot i; returns loaded ptrs."""
        ptrs = []
        for i, a in enumerate(ptr_addrs):
            p = yield from self.read(t, i, a, decode)
            ptrs.append(p)
        return ptrs

    def clear_many(self, t: ThreadCtx) -> Generator:
        """Drop every reservation taken by reserve_many."""
        yield from self.clear(t)

    def enter_write(self, t: ThreadCtx, ptrs: List[int]) -> Generator:
        """NBR hook: publish reservations, end the restartable region."""
        return
        yield

    def exit_write(self, t: ThreadCtx) -> Generator:
        return
        yield

    def alloc_node(self, t: ThreadCtx, nfields: int) -> Generator:
        addr = yield from t.alloc(nfields)
        return addr

    def retire(self, t: ThreadCtx, addr: int) -> Generator:
        raise NotImplementedError

    # ---- helpers ----

    def _account_retire(self, t: ThreadCtx) -> None:
        t.stats.retired += 1
        self.garbage += 1
        if self.garbage > self.garbage_peak:
            self.garbage_peak = self.garbage

    def _note_ping_stall(self, t: ThreadCtx, t0: float) -> None:
        """The ping-timing seam: every scheme that pings wraps its
        ping->wait-for-all-acks window with ``t0 = t.now()`` before and
        this call after.  Updates the scalar max and feeds the optional
        ``ping_hook`` observer with the full (t, t0, t1) span so callers
        can build distributions and traces, not just a maximum."""
        t1 = t.now()
        stall = t1 - t0
        if stall > self.max_ping_stall:
            self.max_ping_stall = stall
        if self.ping_hook is not None:
            self.ping_hook(t, t0, t1)

    def _free(self, t: ThreadCtx, addr: int) -> Generator:
        self.birth.pop(addr, None)
        self.retire_era.pop(addr, None)
        yield from t.free(addr)
        self.garbage -= 1
        self.frees += 1
        if self.free_hook is not None:
            self.free_hook(t, addr)

    def flush(self, t: ThreadCtx) -> Generator:
        """Best-effort final reclaim at thread exit (keeps end-state stats honest)."""
        return
        yield


class NoReclamation(SMRScheme):
    """NR: the leaky baseline -- retire leaks, reads are bare loads."""

    name = "NR"
    robust = False

    def read(self, t: ThreadCtx, slot: int, ptr_addr: int, decode=None) -> Generator:
        ptr = yield from t.load(ptr_addr)
        return ptr

    def retire(self, t: ThreadCtx, addr: int) -> Generator:
        self._account_retire(t)
        return
        yield
