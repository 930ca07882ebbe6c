"""SMR-managed KV-cache block pool -- the paper's techniques as first-class
features of the serving runtime (DESIGN.md §2.3).

Actors:
  * **engines** (readers): per-engine threads building batches out of pool
    blocks.  An engine brackets each step with start_step/end_step, owns the
    blocks it allocates, and may additionally open a *reader session* over
    any blocks it traverses (reserve/touch/clear) -- the batched analogue of
    the paper's per-read reservations, paid once per step instead of once
    per block.
  * **reclaimer**: frees blocks of finished requests.  WHEN a retired block
    is freed is delegated to a pluggable :class:`ReclaimPolicy`
    (runtime/reclaim.py).  The default :class:`EpochPOPPolicy` keeps the
    historical behavior: epoch fast path, publish-on-ping fallback under
    pressure, no engine ever restarts or blocks on reclamation.
    :class:`SimulatedSMRPolicy` instead drives any scheme from
    ``core/smr/registry.py`` over block addresses and turns premature frees
    into hard :class:`UseAfterFree` errors.

Host adaptation (DESIGN.md §8): CPython cannot deliver POSIX signals to a
chosen thread, so the ping is a flag checked at engine safe points (step
boundaries); delivery is bounded because steps are bounded.  The faithful
async-signal semantics are exercised in core/sim.

Prefix-shared blocks: the pool additionally owns a content-keyed *prefix
cache* mapping a prompt-prefix key to the blocks (plus an opaque payload,
e.g. a prefilled KV snapshot) that hold it.  Shared blocks carry refcounts
-- one reference per cache entry holding them plus one per engine request
using them -- and when the last reference drops they are **retired, not
freed**: SMR, not refcounting, decides when recycling is safe, so a reader
session that still spans a just-released prefix block keeps it alive until
the session closes (the robustness-under-reader-stall scenario epoch
schemes handle poorly and the paper's POP fallback is built for).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import (Any, Callable, Dict, Hashable, List, Optional, Sequence,
                    Set, Tuple)

from repro_torch.core.sim.engine import UseAfterFree
from repro_torch.obs import MetricsRegistry, Tracer
from repro_torch.runtime.reclaim import EpochPOPPolicy, ReclaimPolicy


class OutOfBlocks(RuntimeError):
    pass


class StaleHandoff(RuntimeError):
    """An :meth:`BlockPool.adopt` was refused because the source engine no
    longer owns the blocks being handed off -- the source crashed (or
    otherwise unwound) after the handoff was queued, so the blocks were
    already recovered onto a survivor and may be retired, freed, or even
    REALLOCATED to another request by now.  Completing the adopt would
    resurrect them into the destination's live set and a later retire
    would free them under their new owner: a use-after-free by protocol.
    The pool raises without mutating any ledger; the caller must rebuild
    the request's state from scratch (re-admit, re-prefill) instead of
    adopting."""


@dataclass
class PoolStats:
    allocated: int = 0
    freed: int = 0
    # ownership transfers (prefill->decode handoffs + scheduler migrations)
    # and the stale handoffs the crash-consistency check refused
    adopts: int = 0
    adopted_blocks: int = 0
    stale_handoffs: int = 0
    epoch_reclaims: int = 0
    pop_reclaims: int = 0
    pings: int = 0
    publishes: int = 0
    free_watermark_min: int = 1 << 30
    retired_peak: int = 0
    touches: int = 0
    reserves: int = 0
    # worst wall-clock wait a publish-on-ping pass spent between pinging
    # the readers and seeing every publish land (the ping-delivery window
    # the async prefill pipeline bounds by one chunk)
    max_ping_stall_s: float = 0.0
    # prefix-sharing counters
    prefix_hits: int = 0
    prefix_misses: int = 0
    prefix_inserts: int = 0
    prefix_evictions: int = 0
    blocks_saved: int = 0          # allocations avoided via prefix reuse
    shared_peak: int = 0           # peak # of distinct shared blocks


class _BlockTraceListener:
    """Block-listener adapter: lifecycle events -> trace instants.  The
    ``on_free`` callback fires inside ``_return_blocks_if`` under the pool
    lock, but an instant only appends to the tracer's thread-local buffer
    (publish-on-flush), so no lock ordering is introduced."""

    def __init__(self, tracer: Tracer) -> None:
        self._tr = tracer

    def on_alloc(self, blocks: Sequence[int]) -> None:
        if self._tr.enabled:
            self._tr.instant("block_alloc", cat="blocks",
                             args={"n": len(blocks),
                                   "blocks": list(blocks)[:8]})

    def on_free(self, blocks: Sequence[int]) -> None:
        if self._tr.enabled:
            self._tr.instant("block_free", cat="blocks",
                             args={"n": len(blocks),
                                   "blocks": list(blocks)[:8]})


class BlockPool:
    """Thread-safe paged block pool with pluggable SMR reclamation.

    The pool owns the mechanism -- free list, ownership ledger
    (``_live_local``), retired list, reader sessions, and a per-block
    allocation-generation counter that makes use-after-free detection
    deterministic even for real threads.  The attached policy owns the
    decision of when retired blocks are safe to free.
    """

    def __init__(self, num_blocks: int, n_engines: int,
                 reclaim_threshold: int = 32, pressure_factor: int = 2,
                 ping_timeout_s: float = 5.0,
                 policy: Optional[ReclaimPolicy] = None,
                 metrics: Optional[MetricsRegistry] = None,
                 tracer: Optional[Tracer] = None):
        self.num_blocks = num_blocks
        self.n_engines = n_engines
        self.reclaim_threshold = reclaim_threshold
        self.pressure_factor = pressure_factor
        self.ping_timeout_s = ping_timeout_s

        self._lock = threading.Lock()
        self._free: List[int] = list(range(num_blocks))
        self._freeset: Set[int] = set(self._free)
        # (block, retire_epoch) pairs not yet freed
        self._retired: List[tuple] = []
        self._epoch = 1
        # allocation generation per block: bumped on every allocate, so a
        # stale session handle to a recycled block is detectable
        self._gen = [0] * num_blocks

        # engine-local live sets: engine-owned (the "localReservations" of
        # the paper); read by the policy's safe-point publish
        self._live_local: List[Set[int]] = [set() for _ in range(n_engines)]
        # reader sessions: block -> generation observed at reserve time
        self._session: List[Dict[int, int]] = [dict() for _ in range(n_engines)]

        # prefix cache: key -> (blocks, payload); LRU = dict insertion order.
        # _shared_ref counts every holder of a shared block (one per cache
        # entry containing it + one per engine request using it);
        # _engine_shared[e] tracks per-engine request refs so _live_local
        # membership survives two requests on the same engine sharing a block.
        self._prefix_cache: Dict[Hashable, Tuple[List[int], Any]] = {}
        self._shared_ref: Dict[int, int] = {}
        self._engine_shared: List[Dict[int, int]] = [dict()
                                                     for _ in range(n_engines)]

        # block listeners: objects with on_alloc(blocks)/on_free(blocks),
        # called when a block id leaves the free list and when the policy
        # actually returns it.  The paged KV store registers here so its
        # physical pages are poisoned exactly when the SMR decision frees
        # the id -- under ANY policy, including the deliberately broken one
        # (every policy funnels frees through _return_blocks_if).
        self._listeners: List[Any] = []

        self.stats = PoolStats()
        # pool-side observability: ping stall + reclaim-pass histograms live
        # here (one registry per pool), the tracer is shared with the serve
        # engine when one is attached
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.tracer: Optional[Tracer] = None
        self.policy = policy or EpochPOPPolicy()
        self.policy.attach(self)
        if tracer is not None:
            self.attach_tracer(tracer)

    def add_block_listener(self, listener: Any) -> None:
        """Register for on_alloc/on_free block lifecycle callbacks (e.g. a
        :class:`~repro_torch.runtime.kv_store.PagedKVStore`)."""
        self._listeners.append(listener)

    def attach_tracer(self, tracer: Tracer) -> None:
        """Attach a :class:`~repro_torch.obs.trace.Tracer`: block lifecycle
        instants flow through the listener seam, the attached policy gets
        its :meth:`~repro_torch.runtime.reclaim.ReclaimPolicy.on_tracer` hook (the
        native POP pass emits its ping->publish->ack span tree, sim-backed
        policies emit cycle-domain ping spans).  Idempotent per tracer."""
        if self.tracer is tracer:
            return
        self.tracer = tracer
        self.policy.on_tracer(tracer)
        self.add_block_listener(_BlockTraceListener(tracer))

    def record_ping_stall(self, seconds: float) -> None:
        """The ONE recorder both reclaim families report their ping-delivery
        window through.  Records into the locked (immediately merged) path
        of the pool's ``ping_stall_s`` histogram and derives the
        ``max_ping_stall_s`` scalar from the merged max -- so the scalar can
        never split-brain across the reclaimer and engine threads that used
        to race plain ``max()`` read-modify-writes on it."""
        vmax = self.metrics.histogram("ping_stall_s").record_locked(seconds)
        self.stats.max_ping_stall_s = vmax

    # ------------------------------------------------------------------
    # engine (reader) API
    # ------------------------------------------------------------------

    def start_step(self, engine: int) -> None:
        """Engine enters a step (policy announce + safepoint)."""
        self.policy.on_start_step(engine)

    def end_step(self, engine: int) -> None:
        """Engine leaves a step: the reader session ends implicitly."""
        if self._session[engine]:
            self.clear_session(engine)
        self.policy.on_end_step(engine)

    def allocate(self, engine: int, n: int) -> List[int]:
        """Allocate n blocks into the engine's private live set (no global
        bookkeeping beyond the free list pop)."""
        with self._lock:
            if len(self._free) < n:
                raise OutOfBlocks(f"need {n}, have {len(self._free)}")
            blocks = [self._free.pop() for _ in range(n)]
            for b in blocks:
                self._freeset.discard(b)
                self._gen[b] += 1
            self.stats.allocated += n
            self.stats.free_watermark_min = min(self.stats.free_watermark_min,
                                                len(self._free))
        for lis in self._listeners:
            lis.on_alloc(blocks)
        self._live_local[engine].update(blocks)
        self.policy.on_allocate(engine, blocks)
        return blocks

    def release_local(self, engine: int, blocks: Sequence[int]) -> None:
        """Engine stops using blocks it still owns (request handed off or
        aborted before retire)."""
        self._live_local[engine].difference_update(blocks)

    def adopt(self, src: int, dst: int, blocks: Sequence[int],
              shared: Sequence[int] = ()) -> None:
        """Transfer a request's block ownership from engine ``src`` to
        ``dst`` -- the prefill->decode handoff of the async prefill
        pipeline.  ``blocks`` (request-private) move between the engines'
        live sets; ``shared`` (prefix-cache) blocks move one *request
        reference* each, so a shared block stays in ``src``'s live set when
        another of ``src``'s requests still uses it.

        Safety against reclamation: only blocks of an in-flight request are
        ever adopted, and such blocks are never on the retired list (retire
        happens at request finish / last shared reference drop), so no
        policy free decision can race the move.  The ledger update runs
        under the pool lock -- and ``dst`` gains membership before ``src``
        loses it -- so a concurrent publish-on-ping snapshot (which copies
        live sets under the same lock) always sees the block in at least
        one set.  A retire by the new owner that races an in-flight POP
        pass lands at an epoch >= the pass's cut and is excluded from it
        (see ``EpochPOPPolicy._reclaim_pop``), closing the
        publish-before-adopt window on that side too.

        Safety against crashes: the in-flight invariant breaks exactly when
        ``src`` crashed after the handoff was queued --
        :meth:`crash_engine` already recovered its blocks onto a survivor,
        so they may be retired, freed, or reallocated.  The transfer
        therefore VALIDATES, atomically under the same lock, that ``src``
        still owns every private block and holds a request reference on
        every shared one; any miss raises :class:`StaleHandoff` with no
        ledger mutation, and the caller re-admits the request from scratch.
        """
        if src == dst or (not blocks and not shared):
            return
        with self._lock:
            own = self._live_local[src]
            er_s = self._engine_shared[src]
            stale = [b for b in blocks if b not in own]
            stale += [b for b in shared if er_s.get(b, 0) < 1]
            if stale:
                self.stats.stale_handoffs += 1
                raise StaleHandoff(
                    f"adopt {src}->{dst}: engine {src} no longer owns "
                    f"blocks {stale[:8]}{'...' if len(stale) > 8 else ''} "
                    f"(source crashed after handoff?); the request must be "
                    f"re-admitted, not adopted")
            self._live_local[dst].update(blocks)
            own.difference_update(blocks)
            er_d = self._engine_shared[dst]
            for b in shared:
                self._live_local[dst].add(b)
                er_d[b] = er_d.get(b, 0) + 1
                n = er_s.get(b, 0)
                if n <= 1:
                    er_s.pop(b, None)
                    self._live_local[src].discard(b)
                else:
                    er_s[b] = n - 1
            self.stats.adopts += 1
            self.stats.adopted_blocks += len(blocks) + len(shared)
        self.policy.on_adopt(src, dst, blocks, shared)
        tr = self.tracer
        if tr is not None and tr.enabled:
            tr.instant("adopt", cat="smr",
                       args={"src": src, "dst": dst,
                             "blocks": len(blocks) + len(shared)})

    def safepoint(self, engine: int) -> None:
        """Bounded-time ping delivery point: publish-on-ping."""
        self.policy.safepoint(engine)

    # ---- reader sessions (batched reserve-many / clear-many) ----

    def reserve(self, engine: int, blocks: Sequence[int]) -> None:
        """Open/extend this engine's reader session over ``blocks``: the
        engine may touch them until clear_session/end_step, and the policy
        must keep them allocated even if their owner retires them."""
        with self._lock:
            ses = self._session[engine]
            for b in blocks:
                ses[b] = self._gen[b]
        self.stats.reserves += 1
        self.policy.on_reserve(engine, list(self._session[engine]))

    def touch(self, engine: int, blocks: Sequence[int]) -> None:
        """Assert the engine may still use ``blocks``; raises
        :class:`UseAfterFree` if any was freed or recycled under it.
        Touching a block that is neither owned nor session-reserved is
        itself the bug class SMR prevents (an unprotected access that a
        recycle would silently corrupt), so it raises too."""
        ses = self._session[engine]
        own = self._live_local[engine]
        with self._lock:
            for b in blocks:
                g = ses.get(b)
                if g is not None:
                    if b in self._freeset or self._gen[b] != g:
                        raise UseAfterFree(engine, b, "touch")
                elif b not in own:
                    raise UseAfterFree(engine, b, "unreserved-touch")
        self.stats.touches += 1
        self.policy.touch(engine, blocks)

    def clear_session(self, engine: int) -> None:
        with self._lock:
            self._session[engine] = {}
        self.policy.on_clear_session(engine)

    # ------------------------------------------------------------------
    # prefix sharing (content-keyed shared blocks; SMR decides recycling)
    # ------------------------------------------------------------------

    def share_prefix(self, engine: int, key: Hashable,
                     blocks: Sequence[int], payload: Any = None) -> bool:
        """Publish ``blocks`` (engine-owned, or already shared) as the cached
        image of prompt-prefix ``key``.  The cache takes one reference per
        block; blocks that were engine-private additionally gain the caller's
        request reference (they stay in the engine's live set until
        :meth:`release_shared`).  Returns False if ``key`` is already cached
        (a concurrent insert won the race; the caller keeps its blocks
        private and retires them normally)."""
        with self._lock:
            if key in self._prefix_cache:
                return False
            self._prefix_cache[key] = (list(blocks), payload)
            er = self._engine_shared[engine]
            for b in blocks:
                if b not in self._shared_ref:
                    # private -> shared: the caller's request reference plus
                    # the cache entry's own reference
                    er[b] = er.get(b, 0) + 1
                    self._shared_ref[b] = 2
                else:
                    # already shared (a reused shorter prefix): the caller
                    # holds its request ref from acquire; add the cache's
                    self._shared_ref[b] += 1
            self.stats.prefix_inserts += 1
            self.stats.shared_peak = max(self.stats.shared_peak,
                                         len(self._shared_ref))
        return True

    def acquire_prefix(self, engine: int, key: Hashable, *,
                       count_miss: bool = True):
        """Cache lookup: on a hit, take one request reference per block for
        ``engine`` (blocks join its live set, so the policy protects them
        like any owned block) and return ``(blocks, payload)``; on a miss
        return None.  Callers probing several candidate keys for one
        logical lookup pass ``count_miss=False`` and call
        :meth:`count_prefix_miss` once themselves, so hit-rate stats stay
        per-lookup, not per-probe."""
        with self._lock:
            entry = self._prefix_cache.get(key)
            if entry is None:
                if count_miss:
                    self.stats.prefix_misses += 1
                return None
            blocks, payload = entry
            del self._prefix_cache[key]             # LRU: move to MRU end
            self._prefix_cache[key] = entry
            er = self._engine_shared[engine]
            for b in blocks:
                self._shared_ref[b] += 1
                er[b] = er.get(b, 0) + 1
            self._live_local[engine].update(blocks)
            self.stats.prefix_hits += 1
            self.stats.blocks_saved += len(blocks)
        return list(blocks), payload

    def release_shared(self, engine: int, blocks: Sequence[int]) -> int:
        """Drop ``engine``'s request references on shared ``blocks``.  A
        block whose LAST reference (cache entries included) drops here is
        retired -- never freed directly: the attached SMR policy decides
        when it is safe to recycle, which keeps it alive for any reader
        session still spanning it.  Returns the number retired."""
        dead: List[int] = []
        with self._lock:
            er = self._engine_shared[engine]
            for b in blocks:
                if b not in self._shared_ref:
                    # not (or no longer) shared: a double release must not
                    # push the refcount negative and spuriously re-retire a
                    # block that may already be free or reallocated
                    continue
                n = er.get(b, 0)
                if n <= 1:
                    er.pop(b, None)
                    self._live_local[engine].discard(b)
                else:
                    er[b] = n - 1
                r = self._shared_ref[b] - 1
                if r <= 0:
                    del self._shared_ref[b]
                    dead.append(b)
                else:
                    self._shared_ref[b] = r
        if dead:
            self.retire(engine, dead)
        return len(dead)

    def _entries_with_live_readers(self) -> Set[Hashable]:
        """Keys of cache entries at least one of whose blocks is currently
        referenced by an active request (refcount above what the cache
        entries themselves hold).  Caller holds ``_lock``."""
        holders: Dict[int, int] = {}
        for blocks, _ in self._prefix_cache.values():
            for b in blocks:
                holders[b] = holders.get(b, 0) + 1
        live: Set[Hashable] = set()
        for key, (blocks, _) in self._prefix_cache.items():
            if any(self._shared_ref.get(b, 0) > holders.get(b, 0)
                   for b in blocks):
                live.add(key)
        return live

    def evict_prefixes(self, engine: int,
                       max_entries: Optional[int] = None, *,
                       policy: str = "lru") -> int:
        """Drop up to ``max_entries`` cache entries (all when None).
        Blocks whose last reference was the evicted entry go to the retired
        list -- recycled only once the SMR policy proves no reader session
        or live set still spans them.  Returns the number of entries
        evicted.

        ``policy``:
          * ``"lru"`` (default) -- oldest entries first, regardless of use;
            an entry evicted under active readers stays safe (the readers'
            request refs keep its blocks alive, then SMR guards recycling)
            but the next request for that prefix re-prefills it.
          * ``"refcount-aware"`` -- LRU over entries with NO live request
            references; hot entries survive the sweep, so eviction sheds
            only capacity that will not immediately be refaulted.
        """
        if policy not in ("lru", "refcount-aware"):
            raise ValueError(f"unknown eviction policy {policy!r}")
        dead: List[int] = []
        with self._lock:
            keys = list(self._prefix_cache)
            if policy == "refcount-aware":
                live = self._entries_with_live_readers()
                keys = [k for k in keys if k not in live]
            if max_entries is not None:
                keys = keys[:max_entries]
            for key in keys:
                blocks, _ = self._prefix_cache.pop(key)
                for b in blocks:
                    r = self._shared_ref.get(b, 0) - 1
                    if r <= 0:
                        self._shared_ref.pop(b, None)
                        dead.append(b)
                    else:
                        self._shared_ref[b] = r
            self.stats.prefix_evictions += len(keys)
            evicted = len(keys)
        if dead:
            self.retire(engine, dead)
        return evicted

    def count_prefix_miss(self) -> None:
        with self._lock:
            self.stats.prefix_misses += 1

    def rollback_prefix_hit(self, n_blocks: int) -> None:
        """Un-count one hit whose admission was rolled back (the caller
        released the acquired blocks without using them), so hit/saved
        stats reflect admissions that actually went through."""
        with self._lock:
            self.stats.prefix_hits -= 1
            self.stats.blocks_saved -= n_blocks

    @property
    def prefix_entries(self) -> int:
        with self._lock:
            return len(self._prefix_cache)

    @property
    def shared_blocks(self) -> int:
        with self._lock:
            return len(self._shared_ref)

    # ------------------------------------------------------------------
    # reclaimer API
    # ------------------------------------------------------------------

    def retire(self, engine: int, blocks: Sequence[int]) -> None:
        """Blocks of a finished request: logically dead, freed when safe."""
        self._live_local[engine].difference_update(blocks)
        with self._lock:
            e = self._epoch
            self._retired.extend((b, e) for b in blocks)
            self.stats.retired_peak = max(self.stats.retired_peak,
                                          len(self._retired))
        self.policy.on_retire(engine, blocks)

    def crash_engine(self, engine: int) -> int:
        """Reader-crash teardown (the gauntlet's reader-crash fault, pool
        edition): ``engine`` died mid-request, session and references in
        hand.  The policy hears first -- the ESRCH analogue
        (:meth:`ReclaimPolicy.on_engine_crash`): it drops the dead reader's
        stale announcement/publishes so reclaim passes stop waiting on it,
        and the sim-backed policy kills the mirrored simulated thread.  Then
        the pool unwinds the dead engine's footprint like an aborted
        request: the reader session is discarded (a dead reader never
        touches again), shared-prefix request references drain through the
        normal refcount path, and whatever blocks it still owned are
        retired on behalf of a surviving engine -- retired, never freed
        directly, because another engine's session may span prefix blocks
        the dead engine published.  With no survivor the orphans go
        straight to the retired list; nobody is left to recycle them.
        Idempotent.  Returns the number of owned blocks recovered."""
        if engine in self.policy.crashed:
            return 0
        self.policy.on_engine_crash(engine)
        with self._lock:
            self._session[engine] = {}
            shared = dict(self._engine_shared[engine])
        for b, n in shared.items():
            self.release_shared(engine, [b] * n)
        with self._lock:
            orphans = sorted(self._live_local[engine])
            self._live_local[engine].clear()
        if not orphans:
            return 0
        survivor = next((i for i in range(self.n_engines)
                         if i not in self.policy.crashed), None)
        if survivor is None:
            with self._lock:
                e = self._epoch
                self._retired.extend((b, e) for b in orphans)
                self.stats.retired_peak = max(self.stats.retired_peak,
                                              len(self._retired))
            return len(orphans)
        self.retire(survivor, orphans)
        return len(orphans)

    def bump_epoch(self) -> None:
        with self._lock:
            self._epoch += 1

    def reclaim(self, engine: Optional[int] = None) -> int:
        """Ask the policy for a reclamation pass.  Returns # blocks freed.
        Every pass is timed into the pool's ``reclaim_pass_s`` histogram;
        passes that freed something additionally leave a trace span."""
        t0 = time.monotonic()
        freed = self.policy.reclaim(engine)
        dur = time.monotonic() - t0
        self.metrics.record("reclaim_pass_s", dur)
        tr = self.tracer
        if tr is not None and tr.enabled and freed:
            tr.complete("reclaim_pass", tr.wall_ts(t0), dur * 1e6, cat="smr",
                        args={"freed": freed, "engine": engine})
        return freed

    def _return_blocks_if(self, pred: Callable[[int, int], bool]) -> int:
        """Policy callback: free every retired (block, epoch) with
        ``pred(block, epoch)`` true.  Returns the number freed.

        This is the single choke point every policy's free decision flows
        through, so it is where block listeners learn a physical page died
        (the paged KV store poisons it here).  Listeners fire BEFORE the
        ids re-enter the free list: a block must be poisoned while it is
        still unallocatable, otherwise a racing allocate could un-poison
        and write it only to have the late poison corrupt the new life."""
        with self._lock:
            keep, free_now = [], []
            for b, e in self._retired:
                (free_now if pred(b, e) else keep).append((b, e))
            self._retired = keep
            if free_now:
                freed_ids = [b for b, _ in free_now]
                for lis in self._listeners:
                    lis.on_free(freed_ids)
            for b, _ in free_now:
                self._free.append(b)
                self._freeset.add(b)
            self.stats.freed += len(free_now)
        return len(free_now)

    # ------------------------------------------------------------------

    @property
    def free_blocks(self) -> int:
        with self._lock:
            return len(self._free)

    @property
    def retired_blocks(self) -> int:
        with self._lock:
            return len(self._retired)

    def check_no_leaks(self) -> bool:
        """All blocks accounted for: free + retired + held, where held =
        engine live sets ∪ shared blocks (a cached prefix block with zero
        active requests is held by the cache, not leaked)."""
        live = set()
        for s in self._live_local:
            live |= s
        with self._lock:
            held = live | set(self._shared_ref)
            total = len(self._free) + len(self._retired) + len(held)
            dup = (set(self._free) & held) | (
                {b for b, _ in self._retired} & set(self._free))
        return total == self.num_blocks and not dup
