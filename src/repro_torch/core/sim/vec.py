"""Vectorized batch-stepped simulator backend (``backend="vec"``).

Same programmer surface as :mod:`repro_torch.core.sim.engine` -- the SMR schemes
and data structures, written as generators over a thread context, run
unchanged -- but a different execution model tuned for wall-clock
throughput.  The generator backend is a discrete-event scheduler that
resumes ONE Python generator per memory access (heap pop, dispatch
if-chain, jitter draw, heap push: ~6us/op); this backend instead

* holds the globally-visible state in **numpy arrays**: memory cells and
  allocation states (``VecMemory``) are the authoritative storage the
  batch ops gather/scatter on.  Per-thread clocks, pending-signal times,
  done flags, and the per-thread cost table are additionally mirrored as
  arrays (``VecEngine.clocks_np`` / ``signal_at_np`` / ``done_np`` /
  ``cost_table``) at round granularity -- that is the *observability*
  surface for tooling; the op fast paths themselves read the Python
  scalar attributes, which are cheaper at 8-16-wide;
* executes memory operations **inline** inside the thread context: a
  ``load`` checks the allocation state, charges the per-thread cost and
  reads the cell directly instead of round-tripping through a scheduler
  (scalar accesses go through zero-copy memoryviews over the arrays; batch
  accesses -- :meth:`VecThreadCtx.load_many`, the serving runtime's
  touch-path -- are single vectorized gathers with a vectorized
  use-after-free sweep);
* advances **every runnable thread per step**: the run loop is a lockstep
  sweep that resumes each thread for a *quantum* of ops per round, bounded
  by a clock horizon so no thread races more than ``horizon`` simulated
  cycles ahead of the laggard.  Ops that return no value complete without
  even yielding (``yield from`` over a shared empty tuple), so a quantum
  of POP's local-reservation reads costs a handful of attribute updates.

Semantics kept bit-compatible with the generator backend: x86-TSO store
buffers with store-to-load forwarding, RMWs and fences as full barriers,
``membarrier``, POSIX-style coalesced signals with handler frames and
NBR-style neutralization, and the instrumented allocator's
:class:`UseAfterFree` / :class:`DoubleFree` tripwires (the ``Allocator``
class itself is shared).  Documented differences (docs/ARCHITECTURE.md):

* scheduling is horizon-bounded lockstep, not strictly smallest-clock
  first, so interleavings differ from the generator backend at equal
  seeds (single-threaded runs are bit-identical);
* per-op cost jitter is off -- costs are deterministic; schedules still
  vary with the seed through signal-latency jitter;
* signals are delivered at quantum boundaries: at most ``quantum`` ops
  after the target's clock passes the delivery time (Assumption 1's bound
  becomes ``signal_latency + quantum`` ops instead of ``signal_latency``);
* store-buffer drains apply at the owning thread's scheduling points, and
  ``membarrier`` conservatively drains every thread's buffer.
"""

from __future__ import annotations

import random
from collections import deque
from typing import Any, Callable, Dict, Generator, List, Optional, Sequence

import numpy as np

from repro_torch.core.sim.engine import (Allocator, Costs, Neutralized, SimError,
                                   Stats, UseAfterFree)

__all__ = ["VecEngine", "VecMemory", "VecThreadCtx"]

#: ``yield from`` fast path for ops without a return value: an exhausted
#: iterable completes the op with no scheduling point at all...
_EMPTY: tuple = ()
#: ...and a one-element iterable yields exactly one scheduling point (used
#: when the thread's op quantum is spent).
_YIELD: tuple = (None,)

_BIG_BUDGET = 1 << 62

#: Freed and never-allocated cells hold values >= POISON in the vec
#: backend, so the load fast path detects a use-after-free from the value
#: it just read -- no second array access for the allocation state.  All
#: legitimate simulated values (addresses, eras up to MAX_ERA = 2^60,
#: counters) are far below it.  The ``state`` array is still maintained --
#: it is the interface the reclaim policies and the shared Allocator use.
POISON = 1 << 61

# cost fields materialized into the per-thread numpy cost table
_COST_FIELDS = ("load", "store", "local", "fence", "cas", "faa",
                "atomic_store", "membarrier", "signal_send",
                "signal_latency", "handler_overhead", "spin", "work",
                "drain_latency")


class VecAllocator(Allocator):
    """Shared allocator semantics + poison-marking of freed cells.

    Unlike the gen backend, freed cells do NOT retain their contents (they
    are overwritten with the poison pattern); with ``uaf_check`` enabled --
    the only supported vec configuration -- any read of them raises before
    the value could be observed anyway.
    """

    def free(self, addr: int) -> None:
        size = self.sizes.get(addr, 0)
        super().free(addr)
        cells = self.mem.cells
        for i in range(size):
            cells[addr + i] = POISON + addr + i


class VecMemory:
    """numpy-backed globally-visible cells + per-cell allocation state.

    The arrays are the authoritative storage -- vectorized helpers gather
    and scatter straight on ``cells_np``/``state_np`` -- while ``cells``
    and ``state`` are zero-copy memoryviews over them for the scalar op
    fast paths (int indexing through a memoryview is ~2.5x cheaper than
    numpy scalar indexing and writes through to the array).  The surface
    matches :class:`repro_torch.core.sim.engine.Memory` where the schemes and
    the reclaim policies touch it: ``cells[i]``/``state[i]`` read+assign,
    ``brk``, ``alloc`` (the shared :class:`Allocator`), ``_grow``.
    """

    def __init__(self, nthreads: int, capacity: int = 8192):
        self.nthreads = nthreads
        # unallocated cells are pre-poisoned: touching one raises, exactly
        # like the gen backend's state-0 check
        self.cells_np = np.full(capacity, POISON, np.int64)
        self.state_np = np.zeros(capacity, np.uint8)
        self.cells = memoryview(self.cells_np)
        self.state = memoryview(self.state_np)
        self.brk = 1                      # address 0 is NULL
        self.alloc = VecAllocator(self)
        self._on_grow: List[Callable[[], None]] = []

    def _grow(self, n: int) -> None:
        cap = len(self.cells_np)
        if n <= cap:
            return
        new_cap = max(n + 256, cap * 2)
        cells = np.full(new_cap, POISON, np.int64)
        cells[:cap] = self.cells_np
        state = np.zeros(new_cap, np.uint8)
        state[:cap] = self.state_np
        self.cells_np, self.state_np = cells, state
        self.cells, self.state = memoryview(cells), memoryview(state)
        for cb in self._on_grow:          # threads re-cache their views
            cb()


class VecThreadCtx:
    """Per-thread view handed to algorithm code (vec backend).

    Drop-in for :class:`repro_torch.core.sim.engine.ThreadCtx`: same memory-op
    methods (all usable as ``yield from t.op(...)``), same ``local`` dict
    for scheme-private thread-local state, same ``stats``/``clock``/
    ``done``/``pending_neutralize`` attributes.  Ops execute inline; the
    generator protocol is only exercised to give the scheduler bounded
    preemption points (every ``engine.quantum`` ops, and wherever an op
    needs to return a value).
    """

    __slots__ = (
        "engine", "tid", "clock", "done", "crashed", "frames", "pending_signal_at",
        "signal_handler", "neutralizable", "pending_neutralize",
        "stalled_until", "stats", "local", "rng", "_budget",
        "_cells", "_state", "_cells_np", "_state_np",
        "_buf", "_fwd", "_fwd_dirty",
        "_c_load", "_c_store", "_c_local", "_c_fence", "_c_cas", "_c_faa",
        "_c_atomic", "_c_membarrier", "_c_sigsend", "_c_spin", "_drain_lat",
    )

    def __init__(self, engine: "VecEngine", tid: int):
        self.engine = engine
        self.tid = tid
        self.clock = 0.0
        self.done = False
        self.crashed = False              # killed by fault injection
        self.frames: List[list] = []      # [generator, is_handler] pairs
        self.pending_signal_at: Optional[float] = None
        self.signal_handler: Optional[Callable] = None
        self.neutralizable = False
        self.pending_neutralize = False
        self.stalled_until = 0.0
        self.stats = Stats()
        self.local: Dict[str, Any] = {}
        self.rng = random.Random((engine.seed << 8) ^ tid)
        self._budget = _BIG_BUDGET
        mem = engine.mem
        self._cells = mem.cells
        self._state = mem.state
        self._cells_np = mem.cells_np
        self._state_np = mem.state_np
        # TSO store buffer: FIFO of (addr, val, visibility_time) + an O(1)
        # store-to-load forwarding map (addr -> latest buffered value).  The
        # map goes stale when a partial drain retracts entries; it is then
        # rebuilt lazily on the next forwarded load (stores never pay for it)
        self._buf: deque = deque()
        self._fwd: Dict[int, int] = {}
        self._fwd_dirty = False
        c = engine.costs_of[tid]
        self._c_load = float(c.load)
        self._c_store = float(c.store)
        self._c_local = float(c.local)
        self._c_fence = float(c.fence)
        self._c_cas = float(c.cas)
        self._c_faa = float(c.faa)
        self._c_atomic = float(c.atomic_store)
        self._c_membarrier = float(c.membarrier)
        self._c_sigsend = float(c.signal_send)
        self._c_spin = float(c.spin)
        self._drain_lat = float(c.drain_latency)

    # ---- store-buffer plumbing ----

    def _drain_own(self) -> None:
        """Full drain (fence / RMW / thread exit): apply FIFO, clear maps.

        Stores whose target was freed while they sat in the buffer are
        dropped instead of applied, so the poison pattern (the vec
        backend's use-after-free tripwire) survives in freed cells.
        """
        cells, state = self._cells, self._state
        for a, v, _ in self._buf:
            if state[a] == 1:
                cells[a] = v
        self._buf.clear()
        self._fwd.clear()
        self._fwd_dirty = False

    def _drain_due(self) -> None:
        """Apply buffered stores whose visibility time has come."""
        buf = self._buf
        clk = self.clock
        cells, state = self._cells, self._state
        drained = False
        while buf and buf[0][2] <= clk:
            a, v, _ = buf.popleft()
            if state[a] == 1:
                cells[a] = v
            drained = True
        if drained:
            if buf:
                self._fwd_dirty = True
            else:
                self._fwd.clear()
                self._fwd_dirty = False

    def _fwd_map(self) -> Dict[int, int]:
        """The store-to-load forwarding map, rebuilt if a partial drain
        left it stale.  Single home of the _fwd_dirty protocol."""
        if self._fwd_dirty:
            self._fwd = {a: v for a, v, _ in self._buf}
            self._fwd_dirty = False
        return self._fwd

    # ---- memory operations (inline execution) ----

    def load(self, addr: int):
        self.clock += self._c_load
        self.stats.loads += 1
        v = self._fwd_map().get(addr) if self._buf else None
        if v is None:
            v = self._cells[addr]
            if v >= POISON:
                self.engine._bad(self, addr, "load")
        elif self._state[addr] != 1:
            # forwarded from own buffer, but the cell was freed since the
            # store was issued -- still a use-after-free
            self.engine._bad(self, addr, "load")
        self._budget -= 1
        if self._budget <= 0:
            yield
        return v

    def store(self, addr: int, val: int):
        if self._state[addr] != 1:
            self.engine._bad(self, addr, "store")
        c = self.clock + self._c_store
        self.clock = c
        self.stats.stores += 1
        self._buf.append((addr, val, c + self._drain_lat))
        if not self._fwd_dirty:
            self._fwd[addr] = val
        self._budget -= 1
        return _EMPTY if self._budget > 0 else _YIELD

    def atomic_store(self, addr: int, val: int):
        if self._state[addr] != 1:
            self.engine._bad(self, addr, "store")
        self.clock += self._c_atomic
        self.stats.stores += 1
        if self._buf:
            self._drain_own()
        self._cells[addr] = val
        self._budget -= 1
        return _EMPTY if self._budget > 0 else _YIELD

    def cas(self, addr: int, expected: int, new: int):
        self.clock += self._c_cas
        self.stats.cas += 1
        if self._buf:
            self._drain_own()             # RMW is a full barrier on x86
        cells = self._cells
        old = cells[addr]
        if old >= POISON:
            self.engine._bad(self, addr, "cas")
        ok = old == expected
        if ok:
            cells[addr] = new
        self._budget -= 1
        if self._budget <= 0:
            yield
        return ok

    def faa(self, addr: int, delta: int):
        self.clock += self._c_faa
        self.stats.cas += 1
        if self._buf:
            self._drain_own()
        cells = self._cells
        old = cells[addr]
        if old >= POISON:
            self.engine._bad(self, addr, "faa")
        cells[addr] = old + delta
        self._budget -= 1
        if self._budget <= 0:
            yield
        return old

    def fence(self):
        self.clock += self._c_fence
        self.stats.fences += 1
        if self._buf:
            self._drain_own()
        self._budget -= 1
        return _EMPTY if self._budget > 0 else _YIELD

    def membarrier(self):
        self.clock += self._c_membarrier
        self.stats.membarriers += 1
        self.engine._drain_all_threads()
        self._budget -= 1
        return _EMPTY if self._budget > 0 else _YIELD

    def local_op(self, cost: Optional[float] = None):
        self.clock += self._c_local if cost is None else cost
        self._budget -= 1
        return _EMPTY if self._budget > 0 else _YIELD

    def spin(self):
        self.clock += self._c_spin
        self._budget -= 1
        return _EMPTY if self._budget > 0 else _YIELD

    def work(self, cycles: float):
        self.clock += cycles
        self._budget -= 1
        return _EMPTY if self._budget > 0 else _YIELD

    def alloc(self, nfields: int):
        self.clock += self._c_store
        addr = self.engine.mem.alloc.alloc(nfields)
        self._budget -= 1
        if self._budget <= 0:
            yield
        return addr

    def free(self, addr: int):
        self.clock += self._c_store
        self.engine.mem.alloc.free(addr)
        self.stats.freed += 1
        self._budget -= 1
        return _EMPTY if self._budget > 0 else _YIELD

    def send_signal(self, target_tid: int):
        self.clock += self._c_sigsend
        self.engine._signal(self, target_tid)
        self._budget -= 1
        return _EMPTY if self._budget > 0 else _YIELD

    def now(self) -> float:
        return self.clock

    # ---- vectorized batch ops (the serving runtime's touch path) ----

    def load_many(self, addrs: Sequence[int]):
        """Protected batch load: ONE numpy gather + a vectorized
        use-after-free sweep over the whole working set, instead of one
        engine round trip per block."""
        n = len(addrs)
        if n == 0:
            self._budget -= 1
            if self._budget <= 0:
                yield
            return []
        if self._buf:
            self._drain_due()
        arr = np.asarray(addrs, np.int64)
        raw = self._cells_np[arr]
        if raw.max() >= POISON:
            bad = int(arr[int(np.argmax(raw >= POISON))])
            self.engine._bad(self, bad, "load")
        vals = raw.tolist()
        self.clock += self._c_load * n
        self.stats.loads += n
        if self._buf:
            fwd = self._fwd_map()
            for i, a in enumerate(addrs):
                v = fwd.get(a)
                if v is not None:
                    vals[i] = v
        self._budget -= 1
        if self._budget <= 0:
            yield
        return vals


class VecEngine:
    """Batch-stepped lockstep scheduler over inline-executing threads.

    Constructor-compatible with :class:`repro_torch.core.sim.engine.Engine`
    (``nthreads, costs, seed, preempt_prob, preempt_cycles``) plus the
    vec knobs ``quantum`` (ops per thread per round) and ``horizon``
    (max simulated-cycle lead over the laggard thread).
    """

    backend = "vec"

    def __init__(self, nthreads: int, costs: Optional[Costs] = None,
                 seed: int = 0, preempt_prob: float = 0.0,
                 preempt_cycles: int = 20000, quantum: int = 32,
                 horizon: float = 4096.0, faults=None):
        self.n = nthreads
        self.costs = costs or Costs()
        self.costs.validate_for(nthreads)
        self.costs_of = [self.costs.for_thread(i) for i in range(nthreads)]
        self.seed = seed
        self.rng = random.Random(seed)
        self.preempt_prob = preempt_prob
        self.preempt_cycles = preempt_cycles
        self.quantum = quantum
        self.horizon = float(horizon)
        self.time = 0.0
        self.uaf_check = True
        #: API compat with the gen backend; vec costs are deterministic and
        #: per-op jitter is intentionally not applied (see module docstring)
        self.jitter = 0.0
        self._driving = False
        # fault injection (core/sim/faults.py); None => zero overhead
        self.faults = faults
        self._crash_at = faults.crash_times() if faults else {}
        self._stall_wins = faults.stall_windows() if faults else {}
        self.mem = VecMemory(nthreads)
        # per-thread state mirrored as numpy arrays (round granularity)
        self.clocks_np = np.zeros(nthreads, np.float64)
        self.signal_at_np = np.full(nthreads, np.inf, np.float64)
        self.done_np = np.zeros(nthreads, np.bool_)
        self._clocks_mv = memoryview(self.clocks_np)
        self._signal_mv = memoryview(self.signal_at_np)
        self.threads = [VecThreadCtx(self, i) for i in range(nthreads)]
        self.mem._on_grow.append(self._refresh_views)
        self.cost_table = np.array(
            [[float(getattr(self.costs_of[i], f)) for f in _COST_FIELDS]
             for i in range(nthreads)], np.float64)

    # ---- setup ----

    def spawn(self, tid: int, body: Callable[[VecThreadCtx], Generator]) -> None:
        t = self.threads[tid]
        t.frames = [[body(t), False]]
        t.done = False
        self.done_np[tid] = False

    def set_signal_handler(self, handler: Callable) -> None:
        for t in self.threads:
            t.signal_handler = handler

    def alloc_shared(self, n: int) -> int:
        return self.mem.alloc.alloc(n)

    # ---- plumbing shared by the op fast paths ----

    def _refresh_views(self) -> None:
        mem = self.mem
        for t in self.threads:
            t._cells = mem.cells
            t._state = mem.state
            t._cells_np = mem.cells_np
            t._state_np = mem.state_np

    def _bad(self, t: VecThreadCtx, addr: int, what: str) -> None:
        if not self.uaf_check:
            return
        raise UseAfterFree(t.tid, addr, what)

    def _drain_all_threads(self) -> None:
        """membarrier: conservatively make every thread's buffered stores
        visible (a superset of the gen backend's issued-before-now cut --
        still a legal TSO execution, stores just drain early)."""
        for t in self.threads:
            if t._buf:
                t._drain_own()

    # ---- signal machinery ----

    def deliver_signal(self, sender: VecThreadCtx, target_tid: int) -> None:
        tgt = self.threads[target_tid]
        if tgt.done:
            return  # ESRCH
        lat = self.costs_of[target_tid].signal_latency
        at = sender.clock + lat * (1 + self.rng.random() * 0.5)
        if self.faults is not None:
            at += self.faults.draw_signal_delay(self.rng)
        cur = tgt.pending_signal_at
        if cur is None or at < cur:       # POSIX: coalesce per signo
            tgt.pending_signal_at = at
            self._signal_mv[target_tid] = at
        sender.stats.signals_sent += 1

    def kill_thread(self, tid: int) -> None:
        """Hard-crash a thread (same contract as Engine.kill_thread): frames
        dropped, signals to it henceforth ESRCH-dropped, and its store
        buffer drained -- the hardware buffer outlives the thread."""
        t = self.threads[tid]
        if t.done:
            return
        t.done = True
        t.crashed = True
        t.frames = []
        t.pending_signal_at = None
        self._signal_mv[tid] = np.inf
        self.done_np[tid] = True
        t._drain_own()
        self._clocks_mv[tid] = t.clock
        if t.clock > self.time:
            self.time = t.clock

    def _signal(self, sender: VecThreadCtx, target_tid: int) -> None:
        if not self._driving:
            self.deliver_signal(sender, target_tid)
            return
        # synchronous external driving: inline delivery (zero scheduling
        # delay), exactly like Engine.drive
        tgt = self.threads[target_tid]
        if not tgt.done:
            sender.stats.signals_sent += 1
        self._drive_handler(target_tid)

    def _drive_handler(self, tid: int) -> None:
        tgt = self.threads[tid]
        if tgt.done or tgt.signal_handler is None:
            return
        tgt.pending_signal_at = None
        self._signal_mv[tid] = np.inf
        tgt.clock += self.costs_of[tid].handler_overhead
        save = tgt._budget
        tgt._budget = _BIG_BUDGET
        h = tgt.signal_handler(tgt)
        try:
            while True:
                next(h)
        except StopIteration:
            pass
        finally:
            tgt._budget = save
        tgt.stats.signals_handled += 1

    # ---- synchronous external driving (serving runtime) ----

    def drive(self, tid: int, gen: Generator) -> Any:
        """Run ``gen`` to completion on thread ``tid`` without the
        scheduler; ops execute inline and never yield (unbounded budget),
        signals are delivered inline.  Same contract as
        :meth:`repro_torch.core.sim.engine.Engine.drive`."""
        t = self.threads[tid]
        t.pending_neutralize = False
        t._budget = _BIG_BUDGET
        prev = self._driving
        self._driving = True
        # ops without a return value execute inline at CALL time and hand
        # back a plain iterable (not a generator); iter() covers both
        it = iter(gen)
        try:
            while True:
                next(it)
        except StopIteration as stop:
            return stop.value
        finally:
            self._driving = prev
            self._clocks_mv[tid] = t.clock
            if t.clock > self.time:
                self.time = t.clock

    # ---- run loop ----

    def run(self, max_steps: int = 50_000_000) -> None:
        threads = self.threads
        q = self.quantum
        horizon = self.horizon
        costs_of = self.costs_of
        clocks_mv = self._clocks_mv
        signal_mv = self._signal_mv
        rng = self.rng
        pp = self.preempt_prob
        faults = self.faults
        crash_at = self._crash_at
        stall_wins = self._stall_wins
        # stochastic stalls: one coin per round with the quantum-compounded
        # probability (same equalization as the preempt coin below)
        stall_pq = (1.0 - (1.0 - faults.stall_prob) ** q) if (
            faults is not None and faults.stall_prob) else 0.0
        runnable = [t for t in threads if t.frames and not t.done]
        steps = 0
        while runnable:
            cut = min(t.clock for t in runnable) + horizon
            i = 0
            n = len(runnable)
            while i < n:
                t = runnable[i]
                if t.clock > cut:
                    i += 1
                    continue
                if faults is not None:
                    ca = crash_at.get(t.tid)
                    if ca is not None and t.clock >= ca:
                        self.kill_thread(t.tid)
                        runnable[i] = runnable[n - 1]
                        runnable.pop()
                        n -= 1
                        continue
                    wins = stall_wins.get(t.tid)
                    stalled = False
                    while wins and t.clock >= wins[0][0]:
                        t.clock += wins.pop(0)[1]
                        stalled = True
                    if (stall_pq and faults.stall_eligible(t.tid)
                            and rng.random() < stall_pq):
                        t.clock += faults.stall_cycles * (0.5 + rng.random())
                        stalled = True
                    if stalled:
                        # descheduled: no ops, no signal handling this round
                        clocks_mv[t.tid] = t.clock
                        if t.clock > self.time:
                            self.time = t.clock
                        i += 1
                        continue
                buf = t._buf
                if buf and buf[0][2] <= t.clock:
                    t._drain_due()
                # bounded signal delivery at quantum boundary
                at = t.pending_signal_at
                if (at is not None and at <= t.clock
                        and t.signal_handler is not None
                        and not t.frames[-1][1]):
                    t.pending_signal_at = None
                    signal_mv[t.tid] = np.inf
                    t.clock += costs_of[t.tid].handler_overhead
                    t.frames.append([t.signal_handler(t), True])
                    t.stats.signals_handled += 1
                gen, is_handler = t.frames[-1]
                t._budget = q
                try:
                    if t.pending_neutralize and not is_handler:
                        t.pending_neutralize = False
                        t.stats.restarts += 1
                        gen.throw(Neutralized())
                    else:
                        gen.send(None)
                except StopIteration:
                    t.frames.pop()
                    if not t.frames:
                        t.done = True
                        self.done_np[t.tid] = True
                        t._drain_own()    # final stores become visible
                        clocks_mv[t.tid] = t.clock
                        if t.clock > self.time:
                            self.time = t.clock
                        runnable[i] = runnable[n - 1]
                        runnable.pop()
                        n -= 1
                        continue
                used = q - t._budget
                if used <= 0:
                    used = 1
                steps += used
                if steps > max_steps:
                    raise SimError(
                        "simulation step budget exceeded (deadlock/livelock?)")
                # gen draws the preemption coin once per OP; one draw per
                # quantum with the compounded probability keeps the expected
                # descheduling pressure comparable at equal preempt_prob
                if pp and rng.random() < 1.0 - (1.0 - pp) ** used:
                    t.clock += self.preempt_cycles * (0.5 + rng.random())
                clocks_mv[t.tid] = t.clock
                if t.clock > self.time:
                    self.time = t.clock
                i += 1
