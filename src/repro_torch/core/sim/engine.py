"""Deterministic TSO weak-memory simulator with POSIX-like signals.

This is the substrate on which the paper's algorithms (HazardPtrPOP,
HazardEraPOP, EpochPOP) and all baselines (HP, HPAsym, HE, EBR, IBR, NBR+)
run.  CPython's GIL makes native threads sequentially consistent, so the
store-load reordering that hazard pointers must fence against -- and that
publish-on-ping elides -- cannot be expressed with real threads.  Here it can:

* every simulated thread owns a FIFO **store buffer**; a plain ``store``
  becomes globally visible only after a drain latency (jittered), a
  ``fence``, an atomic RMW, or a process-wide ``membarrier``;
* ``load`` forwards from the issuing thread's own buffer (store-to-load
  forwarding) and otherwise reads globally-visible memory -- exactly x86-TSO;
* **signals** are delivered at instruction boundaries within a bounded number
  of simulated cycles (the paper's Assumption 1), and run a handler frame on
  top of the interrupted computation -- or neutralize it (NBR);
* an instrumented allocator raises :class:`UseAfterFree` the moment any
  thread touches a freed cell, and recycles addresses LIFO so ABA is live.

Threads are written as Python generators: every memory operation is a
``yield`` to the scheduler, which advances the thread with the smallest local
clock (discrete-event simulation).  Simulated-cycle throughput is the
figure of merit reported by the benchmarks; wall time is irrelevant.
"""

from __future__ import annotations

import heapq
import random
from collections import deque
from dataclasses import dataclass, fields, replace
from typing import (Any, Callable, Deque, Dict, Generator, List, Mapping,
                    Optional, Sequence, Tuple)

NULL = 0


class SimError(Exception):
    pass


class UseAfterFree(SimError):
    """A thread touched memory that had been freed (the bug class SMR prevents)."""

    def __init__(self, tid: int, addr: int, op: str):
        super().__init__(f"use-after-free: t{tid} {op} addr={addr}")
        self.tid, self.addr, self.op = tid, addr, op


class Neutralized(SimError):
    """Raised inside a thread's operation when an NBR-style signal restarts it."""


class DoubleFree(SimError):
    pass


@dataclass
class Costs:
    """Cycle costs, calibrated to the ratios on the paper's CascadeLake box.

    A store-load fence on x86 is ~30-50 cycles when the store buffer is hot;
    a signal round trip is a few microseconds (~10^4 cycles at 2.2GHz).  The
    absolute numbers only matter relative to each other.
    """

    load: float = 2
    store: float = 4          # shared store (coherence traffic)
    local: float = 1          # thread-local reservation bookkeeping (POP READ)
    fence: float = 40         # store-load fence (drain store buffer)
    cas: float = 30
    faa: float = 30
    atomic_store: float = 8   # store + immediate drain of that entry
    membarrier: float = 4000  # sys_membarrier() on the reclaimer (HPAsym)
    signal_send: float = 800  # pthread_kill per target
    signal_latency: float = 6000  # deliver + schedule handler (bounded, Asm. 1)
    handler_overhead: float = 400  # kernel frame setup/teardown
    spin: float = 12          # one iteration of a wait loop (incl. pause)
    work: float = 1
    drain_latency: float = 90  # store buffer residency before async drain
    drain_jitter: float = 60
    #: Optional per-thread cost vector: entry ``i`` is a mapping of field
    #: overrides for thread ``i`` (or None to use the base costs).  This is
    #: how the serving grid models N engine workers on distinct "sockets":
    #: remote readers pay higher memory latency / fence cost / ping delivery
    #: latency than local ones.  The vector length must equal the engine's
    #: thread count -- engines validate it (no silent broadcasting).
    overrides: Optional[Sequence[Optional[Mapping[str, float]]]] = None

    def validate_for(self, nthreads: int) -> None:
        """Reject a per-thread override vector whose length is not exactly
        the thread count.  Broadcasting a short vector would silently give
        the unlisted threads base costs -- the asymmetric-cost experiments
        depend on knowing exactly which thread pays what."""
        ov = self.overrides
        if ov is not None and len(ov) != nthreads:
            raise ValueError(
                f"per-thread costs vector has {len(ov)} entries but the "
                f"engine has {nthreads} threads; pass exactly one override "
                f"(or None) per thread -- short vectors are not broadcast")

    def for_thread(self, tid: int) -> "Costs":
        """The effective cost table for thread ``tid`` (self when uniform)."""
        ov = self.overrides
        if not ov:
            return self
        if not 0 <= tid < len(ov):
            raise ValueError(
                f"thread {tid} outside per-thread costs vector of "
                f"length {len(ov)}")
        o = ov[tid]
        if not o:
            return self
        known = {f.name for f in fields(self)} - {"overrides"}
        bad = set(o) - known
        if bad:
            raise ValueError(
                f"unknown cost fields in per-thread override: {sorted(bad)}")
        return replace(self, overrides=None, **o)

    @classmethod
    def asymmetric(cls, nthreads: int, remote: Sequence[int] = (),
                   ping_factor: float = 4.0, mem_factor: float = 1.0,
                   fence_factor: float = 1.0,
                   base: Optional["Costs"] = None) -> "Costs":
        """Two-socket NUMA-style model: threads in ``remote`` pay scaled
        memory latency, fence cost, and ping/signal delivery latency."""
        base = base or cls()
        rs = set(remote)
        ov: List[Optional[Dict[str, float]]] = []
        for tid in range(nthreads):
            if tid not in rs:
                ov.append(None)
                continue
            ov.append({
                "load": base.load * mem_factor,
                "store": base.store * mem_factor,
                "atomic_store": base.atomic_store * mem_factor,
                "cas": base.cas * mem_factor,
                "faa": base.faa * mem_factor,
                "fence": base.fence * fence_factor,
                "signal_send": base.signal_send * ping_factor,
                "signal_latency": base.signal_latency * ping_factor,
            })
        return replace(base, overrides=ov)


@dataclass
class Stats:
    ops: int = 0
    reads: int = 0
    loads: int = 0
    stores: int = 0
    fences: int = 0
    cas: int = 0
    signals_sent: int = 0
    signals_handled: int = 0
    membarriers: int = 0
    retired: int = 0
    freed: int = 0
    restarts: int = 0
    reclaim_events: int = 0
    garbage_peak: int = 0     # max total unreclaimed retired nodes
    publishes: int = 0


class Allocator:
    """Bump + LIFO-recycling allocator with use-after-free tripwires.

    States per cell: 0 = unallocated, 1 = live, 2 = freed.  ``free`` keeps the
    cell contents (so racy readers observe stale values, as on real hardware)
    but flips state so the engine can detect the touch.
    """

    LIVE, FREED = 1, 2

    def __init__(self, mem: "Memory"):
        self.mem = mem
        self.freelist: Dict[int, List[int]] = {}   # size -> [addr] (LIFO => ABA)
        self.sizes: Dict[int, int] = {}            # live/freed block -> size
        self.live_count = 0
        self.freed_count = 0
        # When False, freed addresses are never handed out again, so every
        # stale touch trips the FREED state check deterministically (no ABA
        # masking).  Externally-driven harnesses (runtime/reclaim.py) disable
        # recycling to turn the tripwire into a hard litmus.
        self.recycle = True

    def alloc(self, nfields: int) -> int:
        fl = self.freelist.get(nfields) if self.recycle else None
        if fl:
            addr = fl.pop()          # LIFO: maximizes ABA / recycling pressure
        else:
            addr = self.mem.brk
            self.mem.brk += nfields
            self.mem._grow(self.mem.brk)
        self.sizes[addr] = nfields
        for i in range(nfields):
            self.mem.state[addr + i] = self.LIVE
            self.mem.cells[addr + i] = 0
        self.live_count += 1
        return addr

    def free(self, addr: int) -> None:
        size = self.sizes.get(addr)
        if size is None or self.mem.state[addr] != self.LIVE:
            raise DoubleFree(f"double/invalid free at {addr}")
        for i in range(size):
            self.mem.state[addr + i] = self.FREED
        self.freelist.setdefault(size, []).append(addr)
        self.live_count -= 1
        self.freed_count += 1


class Memory:
    """Globally-visible cells + per-thread store buffers (x86-TSO).

    Each buffer is a FIFO (a deque) beside an index of the addresses it
    holds -- address -> [entries, newest value] -- so store-to-load
    forwarding and a drain from the front cost O(1) however long the
    buffer grows.  A thread driven only through stores (a serving engine's
    empty steps under HP, whose ``clear`` stores every slot) never loads,
    so nothing drains its buffer, and a scan of it at every load would
    grow with the run.  The visible semantics are the plain FIFO's."""

    def __init__(self, nthreads: int):
        self.cells: List[int] = []
        self.state: bytearray = bytearray()
        self.brk = 1                      # address 0 is NULL
        self._grow(1)
        self.alloc = Allocator(self)
        # per-thread store buffer: [addr, value, issue_time, vis_time] FIFO
        self.buffers: List[Deque[List]] = [deque() for _ in range(nthreads)]
        self._fwd: List[Dict[int, List[int]]] = [{} for _ in range(nthreads)]

    def _grow(self, n: int) -> None:
        if n > len(self.cells):
            extra = n - len(self.cells) + 256
            self.cells.extend([0] * extra)
            self.state.extend(b"\x00" * extra)

    # -- raw accessors used by the engine (state checks live there) --

    def buffer_store(self, tid: int, entry: List) -> None:
        """Append ``[addr, value, issue_time, vis_time]`` to the buffer."""
        self.buffers[tid].append(entry)
        ix = self._fwd[tid].get(entry[0])
        if ix is None:
            self._fwd[tid][entry[0]] = [1, entry[1]]
        else:
            ix[0] += 1
            ix[1] = entry[1]

    def _pop_front(self, tid: int) -> None:
        addr, val, _, _ = self.buffers[tid].popleft()
        self.cells[addr] = val
        fwd = self._fwd[tid]
        ix = fwd[addr]
        ix[0] -= 1
        if not ix[0]:
            del fwd[addr]

    def drain_until(self, tid: int, now: float) -> None:
        """Apply this thread's buffered stores whose visibility time has come."""
        buf = self.buffers[tid]
        while buf and buf[0][3] <= now:
            self._pop_front(tid)

    def drain_all(self, tid: int) -> None:
        for addr, val, _, _ in self.buffers[tid]:
            self.cells[addr] = val
        self.buffers[tid].clear()
        self._fwd[tid].clear()

    def drain_issued_before(self, tid: int, t: float) -> None:
        """membarrier: make all stores *issued* before time t visible."""
        buf = self.buffers[tid]
        keep = []
        for e in buf:
            if e[2] <= t:
                self.cells[e[0]] = e[1]
            else:
                keep.append(e)
        buf.clear()
        self._fwd[tid].clear()
        for e in keep:
            self.buffer_store(tid, e)

    def forwarded(self, tid: int, addr: int) -> Optional[int]:
        """Store-to-load forwarding from the issuing thread's own buffer."""
        ix = self._fwd[tid].get(addr)
        return None if ix is None else ix[1]


@dataclass
class _Frame:
    gen: Generator
    is_handler: bool = False


class ThreadCtx:
    """Per-thread view handed to algorithm code.

    All memory operations are generators (``yield from t.load(a)``); every
    yield is a scheduling point where signals may be delivered and other
    threads may run.  Thread-LOCAL algorithm state (retire lists, POP's
    localReservations) is plain Python state on this object -- visible to the
    same thread's signal handler without any memory-model ceremony, exactly
    like the paper.
    """

    def __init__(self, engine: "Engine", tid: int):
        self.engine = engine
        self.tid = tid
        self.clock = 0.0
        self.frames: List[_Frame] = []
        self.done = False
        self.crashed = False               # killed by fault injection
        self.pending_signal_at: Optional[float] = None
        self.signal_handler: Optional[Callable[["ThreadCtx"], Generator]] = None
        self.neutralizable = False         # NBR: restartable region?
        self.pending_neutralize = False
        self.stalled_until = 0.0
        self.stats = Stats()
        self.local: Dict[str, Any] = {}    # scheme-private thread-local state
        self.rng = random.Random((engine.seed << 8) ^ tid)

    # ---- memory operations (each is one scheduling point) ----

    def load(self, addr: int):
        v = yield ("load", addr)
        return v

    def store(self, addr: int, val: int):
        yield ("store", addr, val)

    def atomic_store(self, addr: int, val: int):
        yield ("atomic_store", addr, val)

    def cas(self, addr: int, expected: int, new: int):
        ok = yield ("cas", addr, expected, new)
        return ok

    def faa(self, addr: int, delta: int):
        old = yield ("faa", addr, delta)
        return old

    def fence(self):
        yield ("fence",)

    def membarrier(self):
        yield ("membarrier",)

    def local_op(self, cost: Optional[int] = None):
        """Thread-local work (e.g. POP's local reservation store)."""
        yield ("local", cost)

    def spin(self):
        yield ("spin",)

    def work(self, cycles: int):
        yield ("work", cycles)

    def alloc(self, nfields: int):
        addr = yield ("alloc", nfields)
        return addr

    def free(self, addr: int):
        yield ("free", addr)

    def send_signal(self, target_tid: int):
        yield ("signal", target_tid)

    def now(self) -> float:
        return self.clock


class Engine:
    """Discrete-event scheduler over generator threads."""

    def __init__(
        self,
        nthreads: int,
        costs: Optional[Costs] = None,
        seed: int = 0,
        preempt_prob: float = 0.0,
        preempt_cycles: int = 20000,
        faults: Optional["FaultPlan"] = None,
    ):
        self.n = nthreads
        self.costs = costs or Costs()
        # per-thread cost vectors (asymmetric sockets); length-validated so a
        # short override list errors instead of silently broadcasting
        self.costs.validate_for(nthreads)
        self.costs_of = [self.costs.for_thread(i) for i in range(nthreads)]
        self.seed = seed
        self.rng = random.Random(seed)
        self.mem = Memory(nthreads)
        self.threads = [ThreadCtx(self, i) for i in range(nthreads)]
        self.preempt_prob = preempt_prob
        self.preempt_cycles = preempt_cycles
        self.time = 0.0
        self._drains: List[Tuple[float, int]] = []
        self.uaf_check = True
        self.trace: Optional[List] = None
        # monotonically jittered per-op cost adds scheduling diversity
        self.jitter = 0.25
        # fault injection (core/sim/faults.py); None => zero overhead
        self.faults = faults
        self._crash_at = faults.crash_times() if faults else {}
        self._stall_wins = faults.stall_windows() if faults else {}

    # ---- setup ----

    def spawn(self, tid: int, body: Callable[[ThreadCtx], Generator]) -> None:
        t = self.threads[tid]
        t.frames = [_Frame(body(t))]
        t.done = False

    def set_signal_handler(self, handler: Callable[[ThreadCtx], Generator]) -> None:
        for t in self.threads:
            t.signal_handler = handler

    def alloc_shared(self, n: int) -> int:
        """Allocate engine-lifetime shared cells (reservation arrays etc.)."""
        return self.mem.alloc.alloc(n)

    # ---- signal machinery ----

    def deliver_signal(self, sender: ThreadCtx, target_tid: int) -> None:
        tgt = self.threads[target_tid]
        if tgt.done:
            return  # pthread_kill returns ESRCH; reclaimer skips dead threads
        # delivery latency is a property of the TARGET's socket (the ping has
        # to cross to wherever the reader lives)
        lat = self.costs_of[target_tid].signal_latency
        at = sender.clock + lat * (1 + self.rng.random() * 0.5)
        if self.faults is not None:
            at += self.faults.draw_signal_delay(self.rng)
        # coalesce: POSIX keeps at most one pending instance per signo
        if tgt.pending_signal_at is None or at < tgt.pending_signal_at:
            tgt.pending_signal_at = at
        sender.stats.signals_sent += 1

    def kill_thread(self, tid: int) -> None:
        """Hard-crash a thread: frames dropped, no handler will ever run
        again, subsequent signals to it are dropped (ESRCH).  Its store
        buffer still drains -- the hardware's buffer outlives the thread --
        via the global drain heap.  Its private (thread-local, unpublished)
        state dies with it: a dead reader can never touch memory again, so
        schemes may safely reclaim around it once they observe ``done``."""
        t = self.threads[tid]
        if t.done:
            return
        t.done = True
        t.crashed = True
        t.frames = []
        t.pending_signal_at = None

    # ---- synchronous external driving ----

    def drive(self, tid: int, gen: Generator) -> Any:
        """Run ``gen`` to completion on thread ``tid`` without the scheduler.

        This is the host-adaptation entry point used by the serving runtime
        (runtime/reclaim.py): real OS threads drive scheme generators one at a
        time (the caller serializes), so signals sent during the drive are
        delivered *inline* -- the target's handler runs to completion at the
        send point.  That realizes Assumption 1 (bounded delivery) with a zero
        scheduling delay; the faithful asynchronous semantics remain covered
        by :meth:`run`.  Returns the generator's return value.
        """
        t = self.threads[tid]
        t.pending_neutralize = False       # driven code is never restartable
        result: Any = None
        try:
            op = next(gen)
            while True:
                result = self._exec(t, op)
                if op[0] == "signal":
                    self._drive_handler(op[1])
                op = gen.send(result)
        except StopIteration as stop:
            return stop.value

    def _drive_handler(self, tid: int) -> None:
        tgt = self.threads[tid]
        if tgt.done or tgt.signal_handler is None:
            return
        tgt.pending_signal_at = None
        tgt.clock += self.costs_of[tgt.tid].handler_overhead
        h = tgt.signal_handler(tgt)
        try:
            op = next(h)
            while True:
                op = h.send(self._exec(tgt, op))
        except StopIteration:
            pass
        tgt.stats.signals_handled += 1

    # ---- core step ----

    def _cost(self, c: float) -> float:
        return c * (1.0 + self.rng.random() * self.jitter)

    def _exec(self, t: ThreadCtx, op: Tuple) -> Any:
        mem, costs = self.mem, self.costs_of[t.tid]
        kind = op[0]
        now = t.clock
        if kind == "load":
            addr = op[1]
            self._check(t, addr, "load")
            t.clock += self._cost(costs.load)
            t.stats.loads += 1
            fwd = mem.forwarded(t.tid, addr)
            if fwd is not None:
                return fwd
            self._apply_drains(t.clock)
            return mem.cells[addr]
        if kind == "store":
            addr, val = op[1], op[2]
            self._check(t, addr, "store")
            t.clock += self._cost(costs.store)
            t.stats.stores += 1
            vis = t.clock + costs.drain_latency + self.rng.random() * costs.drain_jitter
            mem.buffer_store(t.tid, [addr, val, t.clock, vis])
            heapq.heappush(self._drains, (vis, t.tid))
            return None
        if kind == "atomic_store":
            addr, val = op[1], op[2]
            self._check(t, addr, "store")
            t.clock += self._cost(costs.atomic_store)
            t.stats.stores += 1
            mem.drain_all(t.tid)
            mem.cells[addr] = val
            return None
        if kind == "cas":
            addr, exp, new = op[1], op[2], op[3]
            self._check(t, addr, "cas")
            t.clock += self._cost(costs.cas)
            t.stats.cas += 1
            mem.drain_all(t.tid)              # RMW is a full barrier on x86
            self._apply_drains(t.clock)
            if mem.cells[addr] == exp:
                mem.cells[addr] = new
                return True
            return False
        if kind == "faa":
            addr, delta = op[1], op[2]
            self._check(t, addr, "faa")
            t.clock += self._cost(costs.faa)
            t.stats.cas += 1
            mem.drain_all(t.tid)
            self._apply_drains(t.clock)
            old = mem.cells[addr]
            mem.cells[addr] = old + delta
            return old
        if kind == "fence":
            t.clock += self._cost(costs.fence)
            t.stats.fences += 1
            mem.drain_all(t.tid)
            return None
        if kind == "membarrier":
            t.clock += self._cost(costs.membarrier)
            t.stats.membarriers += 1
            issue_cut = now
            for other in range(self.n):
                mem.drain_issued_before(other, issue_cut)
            return None
        if kind == "local":
            t.clock += self._cost(op[1] if op[1] is not None else costs.local)
            return None
        if kind == "spin":
            t.clock += self._cost(costs.spin)
            self._apply_drains(t.clock)
            return None
        if kind == "work":
            t.clock += self._cost(op[1])
            return None
        if kind == "alloc":
            t.clock += self._cost(costs.store)
            return mem.alloc.alloc(op[1])
        if kind == "free":
            t.clock += self._cost(costs.store)
            mem.alloc.free(op[1])
            t.stats.freed += 1
            return None
        if kind == "signal":
            t.clock += self._cost(costs.signal_send)
            self.deliver_signal(t, op[1])
            return None
        raise SimError(f"unknown op {op!r}")

    def _check(self, t: ThreadCtx, addr: int, what: str) -> None:
        if not self.uaf_check:
            return
        st = self.mem.state[addr] if addr < len(self.mem.state) else 0
        if st != Allocator.LIVE:
            raise UseAfterFree(t.tid, addr, what)

    def _apply_drains(self, now: float) -> None:
        """Make asynchronous store-buffer drains visible up to global time."""
        dr = self._drains
        mem = self.mem
        while dr and dr[0][0] <= now:
            _, tid = heapq.heappop(dr)
            mem.drain_until(tid, now)

    # ---- run loop ----

    def run(self, max_steps: int = 50_000_000) -> None:
        self._drains: List[Tuple[float, int]] = []
        live = [t for t in self.threads if t.frames and not t.done]
        steps = 0
        heap = [(t.clock, t.tid) for t in live]
        heapq.heapify(heap)
        while heap:
            steps += 1
            if steps > max_steps:
                raise SimError("simulation step budget exceeded (deadlock/livelock?)")
            _, tid = heapq.heappop(heap)
            t = self.threads[tid]
            if t.done:
                continue
            if self.faults is not None:
                ca = self._crash_at.get(tid)
                if ca is not None and t.clock >= ca:
                    self.kill_thread(tid)
                    self._apply_drains(t.clock)  # its buffered stores land
                    continue
                wins = self._stall_wins.get(tid)
                stalled = False
                while wins and t.clock >= wins[0][0]:
                    t.clock += wins.pop(0)[1]    # descheduled: clock jumps
                    stalled = True
                if (self.faults.stall_prob
                        and self.faults.stall_eligible(tid)
                        and self.rng.random() < self.faults.stall_prob):
                    t.clock += self.faults.stall_cycles * (0.5 + self.rng.random())
                    stalled = True
                if stalled:
                    # while descheduled the thread handles no signals; it
                    # re-enters the ready queue at its wake-up time
                    heapq.heappush(heap, (t.clock, t.tid))
                    self.time = max(self.time, t.clock)
                    continue
            # signal delivery at instruction boundary
            if (
                t.pending_signal_at is not None
                and t.pending_signal_at <= t.clock
                and t.signal_handler is not None
                and not (t.frames and t.frames[-1].is_handler)
            ):
                t.pending_signal_at = None
                t.clock += self.costs_of[t.tid].handler_overhead
                # The handler itself decides whether to publish (POP) or to
                # request a neutralizing unwind (NBR) by setting
                # ``t.pending_neutralize`` -- the unwind is performed when the
                # *body* frame is next resumed, mirroring a longjmp out of a
                # POSIX handler.
                t.frames.append(_Frame(t.signal_handler(t), is_handler=True))
                t.stats.signals_handled += 1
            self._step_frame(t)
            if not t.done:
                # random preemption (descheduling) pressure
                if self.preempt_prob and self.rng.random() < self.preempt_prob:
                    t.clock += self.preempt_cycles * (0.5 + self.rng.random())
                heapq.heappush(heap, (t.clock, t.tid))
            self.time = max(self.time, t.clock)

    def _step_frame(self, t: ThreadCtx) -> None:
        frame = t.frames[-1]
        send_val = getattr(frame, "_pending", None)
        frame._pending = None
        try:
            if t.pending_neutralize and not frame.is_handler:
                t.pending_neutralize = False
                t.stats.restarts += 1
                op = frame.gen.throw(Neutralized())
            else:
                op = frame.gen.send(send_val)
        except StopIteration:
            t.frames.pop()
            if not t.frames:
                t.done = True
            return
        result = self._exec(t, op)
        frame._pending = result


def run_threads(
    nthreads: int,
    bodies: List[Callable[[ThreadCtx], Generator]],
    seed: int = 0,
    costs: Optional[Costs] = None,
    handler: Optional[Callable] = None,
    preempt_prob: float = 0.0,
) -> Engine:
    eng = Engine(nthreads, costs=costs, seed=seed, preempt_prob=preempt_prob)
    if handler is not None:
        eng.set_signal_handler(handler)
    for i, b in enumerate(bodies):
        eng.spawn(i, b)
    eng.run()
    return eng
