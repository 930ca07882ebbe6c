"""Pluggable block-reclamation policies for the paged serving runtime.

The :class:`~repro_torch.runtime.block_pool.BlockPool` owns the *mechanism*
(free list, ownership ledger, retired list, reader sessions); a
``ReclaimPolicy`` owns the *decision* of when a retired block is safe to
hand back.  Three families ship here:

* :class:`EpochPOPPolicy` -- the native real-thread adaptation of the paper's
  EpochPOP (Algorithm 3): epoch fast path, publish-on-ping fallback under
  pressure.  This is the default and preserves the pool's historical
  behavior bit-for-bit.
* :class:`SimulatedSMRPolicy` -- plugs **any** scheme from
  ``repro_torch.core.smr.registry`` (HP, HPAsym, HE, EBR, IBR, NBR+,
  HazardPtrPOP, HazardEraPOP, EpochPOP, ...) into the pool by mirroring every block as a
  node on the discrete-event simulator.  Real engine threads drive the
  scheme's generators synchronously (``Engine.drive``); the simulator's
  instrumented allocator turns any premature free into a hard
  :class:`UseAfterFree` (recycling disabled, so detection is deterministic).
* :class:`UnsafeEagerPolicy` -- frees retired blocks immediately, ignoring
  reader sessions.  Exists so the litmus tests can demonstrate that the
  tripwires actually fire for the bug class SMR prevents.

Every policy sees the same seam:

    attach(pool)                    -- wire up, allocate side state
    on_start_step / on_end_step     -- engine step brackets (EBR announce)
    safepoint(engine)               -- bounded-time ping delivery point
    on_allocate / on_retire         -- ownership transitions
    on_reserve / on_clear_session   -- batched reader sessions (reserve-many)
    touch(engine, blocks)           -- scheme-level use-after-free tripwire
    reclaim(engine) -> freed        -- explicit scan (OutOfBlocks pressure)

Physical consequences of a free: every policy's decision funnels through
``BlockPool._return_blocks_if``, which notifies the pool's block listeners
-- in paged-KV serving that is the :class:`~repro_torch.runtime.kv_store.
PagedKVStore`, which poisons the freed block's K/V pages so a
freed-then-gathered page raises :class:`UseAfterFree` even outside the
simulator.  A policy that frees too early (``UnsafeEagerPolicy``, or a
buggy scheme) therefore trips hard at BOTH layers: the pool's
generation/free-set check in ``touch`` and the store's page-poison check
in ``assert_alive``.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Dict, List, Optional, Sequence, Set

from repro_torch.core.sim import make_engine
from repro_torch.core.sim.engine import Allocator, Costs, UseAfterFree
from repro_torch.obs import PID_SIM, Tracer

MAX_EPOCH = 1 << 60


class ReclaimPolicy:
    """Base seam: no-op hooks, pool-agnostic."""

    name = "base"

    def __init__(self) -> None:
        self.pool = None  # set by attach()
        self.crashed: Set[int] = set()

    def attach(self, pool) -> None:
        self.pool = pool

    def on_tracer(self, tracer: Tracer) -> None:
        """A tracer was attached to the pool
        (:meth:`~repro_torch.runtime.block_pool.BlockPool.attach_tracer`).
        Policies that can narrate their reclamation emit spans through it:
        the native POP pass draws its ping->publish->ack tree, the
        sim-backed policy hooks the scheme's ping seam for cycle-domain
        spans.  Base: no-op."""

    def on_engine_crash(self, engine: int) -> None:
        """A reader engine died mid-step (the gauntlet's reader-crash fault,
        pool edition).  The policy must stop waiting on it -- the ESRCH
        analogue -- and may recover whatever the dead reader's stale
        reservations no longer protect.  Idempotent."""
        self.crashed.add(engine)

    # -- engine step brackets / ping delivery --

    def on_start_step(self, engine: int) -> None:
        pass

    def on_end_step(self, engine: int) -> None:
        pass

    def safepoint(self, engine: int) -> None:
        pass

    # -- ownership --

    def on_allocate(self, engine: int, blocks: Sequence[int]) -> None:
        pass

    def on_adopt(self, src: int, dst: int, blocks: Sequence[int],
                 shared: Sequence[int] = ()) -> None:
        """Ownership of ``blocks`` (plus one shared request reference per
        block in ``shared``) moved ``src`` -> ``dst`` -- the prefill->decode
        handoff or a scheduler migration.  Called AFTER the pool's ledger
        update, outside the pool lock.

        Base: no-op, and deliberately so for the shipped policies too.
        Every policy reads ownership through the pool's live-set ledger,
        which the pool updates atomically (dst gains before src loses)
        under the same lock the publish snapshot copies under -- so there
        is no per-policy shadow state to migrate.  The native POP pass is
        additionally safe against the publish-before-adopt interleaving
        because in-flight blocks are never on the retired list and a
        post-adopt retire lands at an epoch >= the pass's cut.  The hook
        exists so a future policy that DOES keep per-engine reservation
        state (e.g. per-thread hazard slots pinned to block ids) has a
        seam to move it through, and so tests can observe transfers."""

    def on_retire(self, engine: int, blocks: Sequence[int]) -> None:
        pass

    # -- reader sessions --

    def on_reserve(self, engine: int, session: Sequence[int]) -> None:
        pass

    def on_clear_session(self, engine: int) -> None:
        pass

    def touch(self, engine: int, blocks: Sequence[int]) -> None:
        pass

    # -- reclamation --

    def reclaim(self, engine: Optional[int] = None) -> int:
        return 0

    def flush(self) -> int:
        """Drain everything reclaimable at shutdown (best effort)."""
        return self.reclaim(None)


class EpochPOPPolicy(ReclaimPolicy):
    """The paper's EpochPOP adapted to real threads (DESIGN.md §2.3/§8).

    Fast path: a block retired in epoch e is freed once every engine has
    announced an epoch > e.  Under pressure (an engine stalled mid-step),
    the reclaimer PINGS all engines; each publishes its live+session set at
    the next safe point; the reclaimer frees the complement.  CPython cannot
    deliver POSIX signals to a chosen thread, so the ping is a flag checked
    at engine safe points; delivery is bounded because steps are bounded.
    """

    name = "EpochPOP"

    def __init__(self, ping_timeout_s: Optional[float] = None,
                 pop_every: Optional[int] = None) -> None:
        super().__init__()
        self._ping_timeout_s = ping_timeout_s
        # run the POP fallback on every Nth reclaim() call even without
        # retired-list pressure -- observability knob (a traced run is
        # guaranteed ping spans without having to manufacture pressure),
        # never the default
        self.pop_every = pop_every
        self._reclaim_calls = 0

    def attach(self, pool) -> None:
        super().attach(pool)
        n = pool.n_engines
        if self._ping_timeout_s is None:
            self._ping_timeout_s = pool.ping_timeout_s
        self._announced = [MAX_EPOCH] * n               # MAX = quiescent
        # POP state (per-engine, SWMR)
        self._live_published: List[Set[int]] = [set() for _ in range(n)]
        self._publish_counter = [0] * n
        self._ping_flags = [threading.Event() for _ in range(n)]

    # -- reader side --

    def on_start_step(self, engine: int) -> None:
        self._announced[engine] = self.pool._epoch
        self.safepoint(engine)

    def on_end_step(self, engine: int) -> None:
        self._announced[engine] = MAX_EPOCH
        self.safepoint(engine)

    def safepoint(self, engine: int) -> None:
        """Bounded-time ping delivery point: publish-on-ping."""
        ev = self._ping_flags[engine]
        if ev.is_set():
            self._publish(engine)
            ev.clear()

    def _publish(self, engine: int) -> None:
        # copy under the pool lock: live sets are no longer single-writer
        # (BlockPool.adopt moves blocks between engines on the prefill ->
        # decode handoff), and copying a set mid-mutation is an error; the
        # published-set swap itself is atomic under the GIL
        pool = self.pool
        with pool._lock:
            published = (set(pool._live_local[engine])
                         | set(pool._session[engine]))
        self._live_published[engine] = published
        self._publish_counter[engine] += 1
        pool.stats.publishes += 1

    def on_engine_crash(self, engine: int) -> None:
        """Dead engines leave the protocol: their stale announcement no
        longer pins the epoch minimum, their published set is dropped (a
        dead reader never touches again), and reclaim passes stop pinging
        them -- otherwise every POP pass would burn the full ping timeout
        waiting for a publish that can never come."""
        super().on_engine_crash(engine)
        self._announced[engine] = MAX_EPOCH
        self._live_published[engine] = set()
        self._ping_flags[engine].clear()

    # -- reclaimer side --

    def on_retire(self, engine: int, blocks: Sequence[int]) -> None:
        with self.pool._lock:
            over = len(self.pool._retired) >= self.pool.reclaim_threshold
        if over:
            self.reclaim(engine)

    def reclaim(self, engine: Optional[int] = None) -> int:
        """Epoch fast path; POP fallback under pressure.  Returns # freed.

        ``engine``: the calling engine's id (paper: pingAllToPublish skips
        self -- a reclaimer reads its own reservations directly and must not
        wait for its own publish counter)."""
        pool = self.pool
        pool.bump_epoch()
        self._reclaim_calls += 1
        freed = self._reclaim_epoch()
        with pool._lock:
            pressure = len(pool._retired) >= (pool.pressure_factor
                                              * pool.reclaim_threshold)
        if pressure or (self.pop_every
                        and self._reclaim_calls % self.pop_every == 0):
            freed += self._reclaim_pop(engine)
        return freed

    def _reclaim_epoch(self) -> int:
        pool = self.pool
        min_epoch = min(self._announced)
        freed = pool._return_blocks_if(lambda b, e: e < min_epoch)
        if freed:
            pool.stats.epoch_reclaims += 1
        return freed

    def _reclaim_pop(self, engine: Optional[int] = None) -> int:
        """Ping all OTHER engines, wait for publishes, free the complement;
        the caller's own live set is read directly (paper Alg. 2 line 37).

        Only blocks retired BEFORE this pass (epoch < cut) are eligible --
        the paper's reclaimer scans its retire-buffer snapshot, not retires
        that race with the pass.  A reader that published after our ping may
        legitimately reserve a block that is still cached/reachable at that
        point; such a block's retire necessarily lands at an epoch >= cut,
        so excluding it closes the publish-then-reserve window (reachable
        since prefix-shared blocks can be reserved without an ownership
        reference)."""
        pool = self.pool
        pool.stats.pings += 1
        with pool._lock:
            cut = pool._epoch
        snap = list(self._publish_counter)
        others = [i for i in range(pool.n_engines)
                  if i != engine and i not in self.crashed]
        t_ping = time.monotonic()
        for i in others:
            self._ping_flags[i].set()
        deadline = t_ping + self._ping_timeout_s
        pending = set(others)
        published_at: Dict[int, float] = {}
        while pending and time.monotonic() < deadline:
            if engine is not None:
                # service our own ping while waiting: two concurrent POP
                # passes would otherwise deadlock on each other's publish
                # counters until timeout (signals interrupt anything)
                self.safepoint(engine)
            landed = {i for i in pending
                      if self._publish_counter[i] > snap[i]}
            if landed:
                now = time.monotonic()
                for i in landed:
                    published_at[i] = now
                pending -= landed
            if pending:
                time.sleep(0.0005)
        # the ping-delivery window this pass actually experienced: how long
        # the slowest reader took to reach a safepoint and publish (the
        # chunked-prefill bound the serve_reclaim grid reports per scheme)
        stall = time.monotonic() - t_ping
        pool.record_ping_stall(stall)
        self._trace_pop_pass(t_ping, stall, others, published_at, pending)
        if pending:
            # Assumption 1 violated (engine died?): stay safe, free nothing
            # beyond what epochs allow.
            return 0
        reserved: Set[int] = set()
        for i in others:
            reserved |= self._live_published[i]
        if engine is not None:
            with pool._lock:
                # same adopt-vs-read race as _publish: our own live set may
                # be mid-handoff on another thread
                reserved |= set(pool._live_local[engine])
                reserved |= set(pool._session[engine])
        freed = pool._return_blocks_if(
            lambda b, e: e < cut and b not in reserved)
        if freed:
            pool.stats.pop_reclaims += 1
        return freed

    def _trace_pop_pass(self, t_ping: float, stall: float,
                        others: Sequence[int],
                        published_at: Dict[int, float],
                        pending: Set[int]) -> None:
        """Draw one ping->publish->ack span tree in the wall-clock domain:
        a ``pop_pass`` parent on the reclaiming thread's track, one
        ``publish`` child per pinged reader slot on its own synthetic track
        (``smr reader e<i>``, so the per-reader windows stack visually in
        Perfetto), and a closing ``pop_ack`` instant.  Spans are linked by a
        shared ``pass`` id in args."""
        tr = getattr(self.pool, "tracer", None)
        if tr is None or not tr.enabled:
            return
        ts0 = tr.wall_ts(t_ping)
        aid = tr.next_async_id()
        tr.complete("pop_pass", ts0, stall * 1e6, cat="smr",
                    args={"pass": aid, "readers": len(others),
                          "timed_out": sorted(pending)})
        t_end = t_ping + stall
        for i in others:
            t_pub = published_at.get(i, t_end)
            tr.complete("publish", ts0, (t_pub - t_ping) * 1e6, cat="smr",
                        tid=tr.tid_named(f"smr reader e{i}"),
                        args={"pass": aid, "reader": i,
                              "published": i in published_at})
        tr.instant("pop_ack", ts_us=ts0 + stall * 1e6, cat="smr",
                   args={"pass": aid, "acked": len(published_at),
                         "pinged": len(others)})


class UnsafeEagerPolicy(ReclaimPolicy):
    """DELIBERATELY BROKEN: frees retired blocks immediately, ignoring every
    reservation.  A reader session holding a retired block will observe
    :class:`UseAfterFree` on its next touch -- exactly the bug class the SMR
    policies exist to prevent.  Test/demo only."""

    name = "unsafe-eager"

    def on_retire(self, engine: int, blocks: Sequence[int]) -> None:
        self.pool._return_blocks_if(lambda b, e: True)

    def reclaim(self, engine: Optional[int] = None) -> int:
        return self.pool._return_blocks_if(lambda b, e: True)


class SimulatedSMRPolicy(ReclaimPolicy):
    """Drive any registry SMR scheme over block addresses.

    Every pool block is mirrored by a one-cell node on the discrete-event
    simulator; a shared *block table* cell per block holds the current node
    address (exactly the indirection the serving block table provides).  Real
    engine threads map 1:1 onto simulated threads and drive the scheme's
    generators synchronously under a policy-wide lock (``Engine.drive``);
    signals are delivered inline, which realizes the paper's Assumption 1
    with zero scheduling delay.

    Safety instrumentation: address recycling is disabled in the simulated
    allocator, so the node of a freed block stays in the FREED state forever
    and **any** stale touch raises :class:`UseAfterFree` deterministically.
    """

    name = "sim-smr"

    def __init__(self, scheme: str = "HazardPtrPOP", *, seed: int = 0,
                 reclaim_freq: Optional[int] = None, epoch_freq: int = 4,
                 costs: Optional[Costs] = None,
                 backend: str = "gen") -> None:
        super().__init__()
        self.scheme_name = scheme
        self.seed = seed
        self.reclaim_freq = reclaim_freq
        self.epoch_freq = epoch_freq
        self.costs = costs
        self.backend = backend
        self.name = f"sim-{scheme}"

    def attach(self, pool) -> None:
        from repro_torch.core.smr.registry import make_scheme

        super().attach(pool)
        n = pool.n_engines
        # Per-thread (asymmetric-socket) cost vectors are sized for the
        # pool's engine slots; the backend selects gen (discrete-event
        # reference) or vec (batch-stepped numpy arrays, ~5-10x faster --
        # what lets the serve_reclaim grid sweep past 4 engines)
        self.sim = make_engine(n, backend=self.backend, costs=self.costs,
                               seed=self.seed)
        self.sim.mem.alloc.recycle = False      # deterministic UAF tripwire
        # a session may reserve every block in the pool
        self.smr = make_scheme(
            self.scheme_name, self.sim, max_hp=pool.num_blocks,
            reclaim_freq=self.reclaim_freq or pool.reclaim_threshold,
            epoch_freq=self.epoch_freq)
        self.sim.set_signal_handler(self.smr.handler)
        for t in self.sim.threads:
            self.smr.thread_init(t)
        self.table = self.sim.alloc_shared(pool.num_blocks)  # block -> node ptr
        self._node_of: Dict[int, int] = {}
        self._retired_nodes: Dict[int, int] = {}             # node -> block
        self._mtx = threading.RLock()                        # serializes drives
        # the simulator's host cost, as the serving threads pay it: seconds
        # spent holding the lock (drives, plus the frees they complete) and
        # waiting for it, over ``drives`` outermost hook calls
        self.host_s = 0.0
        self.wait_s = 0.0
        self.drives = 0
        self._depth = 0

    @contextmanager
    def _held(self):
        t0 = time.perf_counter()
        with self._mtx:
            self._depth += 1
            t1 = time.perf_counter()
            try:
                yield
            finally:
                self._depth -= 1
                if not self._depth:
                    self.host_s += time.perf_counter() - t1
                    self.wait_s += t1 - t0
                    self.drives += 1

    # -- step brackets --

    def on_start_step(self, engine: int) -> None:
        if engine in self.crashed:
            return
        with self._held():
            t = self.sim.threads[engine]
            self.sim.drive(engine, self.smr.start_op(t))

    def on_end_step(self, engine: int) -> None:
        if engine in self.crashed:
            return
        with self._held():
            t = self.sim.threads[engine]
            self.sim.drive(engine, self.smr.end_op(t))
            self._collect_freed()

    # -- crash recovery --

    def on_engine_crash(self, engine: int) -> None:
        """Kill the dead engine's mirrored simulated thread.  From here on
        the scheme sees exactly what a real reclaimer would: pings to the
        dead thread return ESRCH, wait loops skip it, era/epoch scans treat
        whatever it last announced by each scheme's own crash rules (POP
        frees past the dead thread's unpublished reservations; EBR's pinned
        announcement leaks by design).  Retires the dead thread deferred in
        its simulated retire list are stranded -- a bounded leak, the same
        one a real crashed reclaimer causes."""
        super().on_engine_crash(engine)
        with self._held():
            self.sim.kill_thread(engine)

    # -- ownership --

    def on_allocate(self, engine: int, blocks: Sequence[int]) -> None:
        with self._held():
            t = self.sim.threads[engine]
            for b in blocks:
                addr = self.sim.drive(engine, self.smr.alloc_node(t, 1))
                self._node_of[b] = addr
                self.sim.drive(engine, t.atomic_store(self.table + b, addr))

    def on_retire(self, engine: int, blocks: Sequence[int]) -> None:
        if engine in self.crashed:
            # a dead thread's generators cannot be driven: the first
            # surviving engine adopts the retire (BlockPool.crash_engine
            # routes the dead reader's last-reference blocks here); with no
            # survivor the blocks stay on the pool's retired list -- nobody
            # is left to free them anyway
            live = [i for i in range(self.pool.n_engines)
                    if i not in self.crashed]
            if not live:
                return
            engine = live[0]
        with self._held():
            t = self.sim.threads[engine]
            for b in blocks:
                addr = self._node_of[b]
                self._retired_nodes[addr] = b
                self.sim.drive(engine, self.smr.retire(t, addr))
            self._collect_freed()

    # -- reader sessions (the batched reserve-many path) --

    def on_reserve(self, engine: int, session: Sequence[int]) -> None:
        if engine in self.crashed:
            return
        with self._held():
            t = self.sim.threads[engine]
            addrs = [self.table + b for b in sorted(session)]
            self.sim.drive(engine, self.smr.reserve_many(t, addrs))

    def on_clear_session(self, engine: int) -> None:
        if engine in self.crashed:
            return
        with self._held():
            t = self.sim.threads[engine]
            self.sim.drive(engine, self.smr.clear_many(t))

    def touch(self, engine: int, blocks: Sequence[int]) -> None:
        with self._held():
            t = self.sim.threads[engine]
            addrs = []
            for b in blocks:
                addr = self._node_of.get(b)
                if addr is None:
                    raise UseAfterFree(engine, b, "touch")
                addrs.append(addr)
            # the load IS the check: freed node cells raise in the sim.
            # The vec backend turns the whole working set into ONE numpy
            # gather with a vectorized use-after-free sweep.
            load_many = getattr(t, "load_many", None)
            if load_many is not None:
                self.sim.drive(engine, load_many(addrs))
            else:
                for addr in addrs:
                    self.sim.drive(engine, t.load(addr))

    # -- reclamation --

    def reclaim(self, engine: Optional[int] = None) -> int:
        """Drain every sim thread's retired list regardless of caller.
        Retired nodes live with the thread that retired them, so a dedicated
        reclaimer thread (which retires nothing itself) must flush its peers;
        the policy-wide lock makes cross-thread drives safe."""
        t0 = time.monotonic()
        with self._held():
            before = self.pool.stats.freed
            for tid in range(self.pool.n_engines):
                if tid in self.crashed:
                    continue   # a dead thread's generators cannot be driven
                t = self.sim.threads[tid]
                self.sim.drive(tid, self.smr.flush(t))
            self._collect_freed()
            # pings are delivered inline while the drive runs, so the wall
            # time of the pass IS the reclaimer's ping stall here (it also
            # includes waiting on the policy lock behind a mid-prefill
            # drive -- exactly the contention the chunk bound caps)
            stall = time.monotonic() - t0
            self.pool.record_ping_stall(stall)
            return self.pool.stats.freed - before

    def flush(self) -> int:
        return self.reclaim(None)

    def on_tracer(self, tracer: Tracer) -> None:
        """Hook the scheme's ping-timing seam: every timed
        ping->all-acks window any simulated reclaimer experiences becomes a
        ``ping_pass`` span in the cycle-clock domain (``PID_SIM``), on a
        track named after the simulated thread -- so a sim-backed serve run
        shows both domains side by side in one trace."""
        scheme = self.scheme_name

        def hook(t, t0: float, t1: float) -> None:
            tracer.complete(
                "ping_pass", Tracer.sim_ts(t0), Tracer.sim_ts(t1 - t0),
                cat="smr", pid=PID_SIM,
                tid=tracer.tid_named(f"sim t{t.tid}", PID_SIM),
                args={"scheme": scheme})

        self.smr.ping_hook = hook

    # -- plumbing --

    def _collect_freed(self) -> None:
        """Blocks whose sim node reached FREED go back to the pool."""
        state = self.sim.mem.state
        done = [a for a in self._retired_nodes if state[a] == Allocator.FREED]
        if done:
            blocks = set()
            for a in done:
                b = self._retired_nodes.pop(a)
                blocks.add(b)
                if self._node_of.get(b) == a:
                    del self._node_of[b]
            self.pool._return_blocks_if(lambda b, e: b in blocks)
        self._sync_stats()

    def _sync_stats(self) -> None:
        s = self.pool.stats
        s.pings = sum(t.stats.signals_sent for t in self.sim.threads)
        s.publishes = sum(t.stats.publishes for t in self.sim.threads)
        s.epoch_reclaims = getattr(self.smr, "epoch_reclaims",
                                   self.smr.reclaim_calls)
        s.pop_reclaims = getattr(self.smr, "pop_reclaims", 0)

    @property
    def unreclaimed(self) -> int:
        """Retired-but-unfreed blocks the scheme is still holding."""
        return len(self._retired_nodes)


#: schemes that are safe to plug into the pool (HP-broken is a deliberately
#: unsafe demo of the simulator's bug-finding power; NR leaks by design but
#: never frees early, so it stays in the safe set)
def supported_schemes() -> List[str]:
    from repro_torch.core.smr.registry import SCHEMES
    return [s for s in SCHEMES if s != "HP-broken"]


#: keyword arguments that only make sense for SimulatedSMRPolicy; the
#: native/unsafe policies drop them so callers can thread --sim-backend and
#: per-thread costs through uniformly
_SIM_ONLY_KW = ("backend", "costs", "seed", "reclaim_freq", "epoch_freq")

#: policy names make_policy resolves WITHOUT a simulator (the native pool
#: adaptation and the deliberately-broken demo); the single source of truth
#: for callers that must know whether sim-backend/cost knobs apply
NATIVE_POLICY_NAMES = (None, "", "EpochPOP-pool", "pool",
                       "unsafe", "unsafe-eager")


def is_simulated(name: Optional[str]) -> bool:
    """True when ``make_policy(name)`` builds a SimulatedSMRPolicy (so the
    simulator backend and cost-model kwargs actually take effect)."""
    return name not in NATIVE_POLICY_NAMES


def make_policy(name: Optional[str], **kw) -> ReclaimPolicy:
    """'EpochPOP-pool'/None -> native policy; 'unsafe' -> the broken demo;
    any registry scheme name -> SimulatedSMRPolicy over that scheme.
    Simulator-only kwargs (backend, costs, ...) are ignored by the
    simulator-free policies."""
    if name in (None, "", "EpochPOP-pool", "pool"):
        for k in _SIM_ONLY_KW:
            kw.pop(k, None)
        return EpochPOPPolicy(**kw)
    if name in ("unsafe", "unsafe-eager"):
        for k in _SIM_ONLY_KW:
            kw.pop(k, None)
        return UnsafeEagerPolicy()
    safe = supported_schemes()
    if name not in safe:
        # HP-broken exists in the registry as a simulator demo but must not
        # resolve here: it is unsafe by construction.  Tests that want it
        # can build SimulatedSMRPolicy("HP-broken") directly.
        raise ValueError(
            f"unknown or unsafe SMR scheme {name!r}; choose from "
            f"EpochPOP-pool, unsafe, {', '.join(safe)}")
    return SimulatedSMRPolicy(name, **kw)
