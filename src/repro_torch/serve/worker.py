"""Engine workers, prefill workers, and the reclaimer: the thread-level
actors of the sharded serving runtime.

Each :class:`EngineWorker` is an independent SMR *reader* over the shared
:class:`~repro_torch.runtime.block_pool.BlockPool`: it owns one engine id, brackets
every decode step with start_step/end_step, and opens one batched reader
session per step over the KV blocks of all its in-flight requests.  With N
workers plus the dedicated :class:`Reclaimer`, a publish-on-ping reclamation
pass genuinely fans out to N concurrent readers -- the paper's signal-cost
scaling scenario -- instead of the single hard-coded reader the monolithic
engine had.

Prefill is a pipeline stage of its own: with ``prefill_workers >= 1`` on the
engine facade, N :class:`PrefillWorker` threads -- each ALSO a first-class
SMR reader with its own engine id and slots -- drain the scheduler's shared
prefill queue, run **chunked** prefill (`serve/paged_model.py
prefill_kv_chunked`: one batched forward per ``prefill_chunk`` tokens with a
``pool.safepoint()`` between chunks), and hand completed -- or partially
prefilled, resumable -- requests to decode workers through the scheduler.
Decode admission then only ever installs ready pages.  The point is the
publish-on-ping delivery window: a full-prompt prefill inside the decode
loop stretches the window a reclaimer ping waits on to an entire prompt
(the paper's "delayed thread" regime, where EpochPOP degrades toward its HP
fallback); per-chunk safepoints bound it by ``prefill_chunk`` tokens, and
the dedicated stage keeps co-batched decodes flowing while long prompts
prefill.  Without prefill workers the decode worker runs the same chunked
prefill inline at admission, so the chunk bound holds either way.

Prefix sharing: when enabled, admitting a request first asks the pool's
content-keyed prefix cache for the longest page-aligned prompt prefix
already prefilled by any worker.  A hit reuses the shared blocks (refcounted
by the pool) AND the prefilled KV state, so the worker skips both the
allocation and the prefill compute for those tokens.  On finish, shared
blocks are *released*, not retired; the pool retires them only when the
last holder (cache entry included) lets go, and the SMR policy decides when
recycling is actually safe.

KV storage is the physically paged path: K/V live ONLY in the shared
:class:`~repro_torch.runtime.kv_store.PagedKVStore` pages keyed by the
pool's block ids, and a decode step batches every running request into one
``(table, lens, q)`` launch of the paged-attention kernel per layer
(serve/paged_model.py).  A prefix hit installs *no copies at all*: the
shared physical pages enter the request's block table directly, and the
prefix-cache payload is just the prefilled length.  The pages are
device-resident by default (``kv_storage="device"``), so a steady-state
decode step moves zero host->device KV bytes.  The dense per-request cache
path of the reference package comes with the ``models/`` slice of the
port; until then ``kv_store=None`` raises.

GPU ordering is an SMR safety rule here.  Every page read, write and fill
is issued on the one current CUDA stream (no side streams, no CUDA
graphs), so stream order is issue order.  A decode step reads its logits
back to the host (a stream sync) before ``end_step`` closes its reader
session, and a prefill chunk's writes are issued before its pages are
published.  A freed page is therefore never recycled while a kernel still
reads it; any later overlap work must keep that condition, e.g. by
waiting on a recorded event before the session closes.
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

from repro_torch.obs import MetricsRegistry, Tracer
from repro_torch.runtime.block_pool import BlockPool, OutOfBlocks, StaleHandoff
from repro_torch.runtime.kv_store import PagedKVStore


@dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new: int = 16
    out: List[int] = field(default_factory=list)
    blocks: List[int] = field(default_factory=list)         # private
    shared_blocks: List[int] = field(default_factory=list)  # prefix-shared
    # prefill pipeline state: how many prompt tokens have materialized KV
    # (pages), whether admission was a prefix-cache hit
    # (the bytes-copied classification), how many prefix tokens are
    # already published to the cache (hit_len -- also advanced when WE
    # publish, so it cannot double-insert), which engine id currently
    # owns the blocks (handoff transfers via BlockPool.adopt)
    prefilled: int = 0
    cache_hit: bool = False
    hit_len: int = 0
    owner: Optional[int] = None
    # scheduling state: absolute monotonic deadline (None = best-effort,
    # sorts last under the deadline policy) and how often the scheduler
    # preempted/migrated this request (observability + test oracles)
    deadline_s: Optional[float] = None
    preemptions: int = 0
    migrations: int = 0
    # observability timeline (time.monotonic seconds; 0.0 = not yet):
    # submit -> first pickup (queue wait) -> first token (TTFT) -> per-token
    # cadence, plus the async-span id linking this request's trace events
    # across threads
    t_submit: float = 0.0
    t_admitted: float = 0.0
    t_first_tok: float = 0.0
    t_last_tok: float = 0.0
    aid: Optional[int] = None
    done: threading.Event = field(default_factory=threading.Event)

    @property
    def all_blocks(self) -> List[int]:
        return self.shared_blocks + self.blocks

    def reset_admission(self) -> None:
        """Forget everything admission built (blocks, prefix hit, prefill
        progress) so the request can be re-admitted from
        scratch.  The one caller is stale-handoff recovery: the pool
        refused an adopt because the source engine crashed and its blocks
        were already recovered, so this request's references to them are
        dangling by definition -- dropping them leaks nothing."""
        self.blocks, self.shared_blocks = [], []
        self.owner = None
        self.prefilled = self.hit_len = 0
        self.cache_hit = False


def finalize_request(pool: Optional[BlockPool], r: Request,
                     tracer: Optional[Tracer] = None) -> None:
    """Fail/stop-path completion of a stranded request, independent of any
    worker instance: give its blocks back to the pool under the owning
    engine id (retire private, release shared), close its trace tree, and
    release its waiter.  This is the shared seam every stranded-request
    path funnels through -- worker error paths and ``Scheduler.stop``'s
    queue drain -- so cleanup never depends on a particular worker (or any
    prefill worker at all) still existing.  Best-effort: it runs on error
    paths where the pool itself may be the thing that failed."""
    try:
        if pool is not None and r.owner is not None:
            pool.retire(r.owner, r.blocks)
            if r.shared_blocks:
                pool.release_shared(r.owner, r.shared_blocks)
            r.blocks, r.shared_blocks = [], []
    except Exception:  # noqa: BLE001 -- teardown best effort
        pass
    if tracer is not None and tracer.enabled and r.aid is not None:
        tracer.instant("retire", cat="request",
                       args={"rid": r.rid, "tokens": len(r.out),
                             "finalized": True})
        tracer.async_end("request", r.aid, cat="request")
        r.aid = None
    r.done.set()


class _PoolActor:
    """Shared behavior of every pool actor that admits and prefills
    requests (decode workers and prefill workers): prefix-cache lookup,
    pressure-aware allocation, and the CHUNKED prefill loop itself --
    identical whether it runs in the dedicated prefill stage or inline at
    decode admission."""

    def __init__(self, engine_id: int, cfg, params, pool: BlockPool,
                 *, page_size: int = 16,
                 prefix_cache: bool = False,
                 kv_store: Optional[PagedKVStore] = None,
                 kernel_impl: Optional[str] = None,
                 evict_policy: str = "lru", prefill_chunk: int = 16,
                 tracer: Optional[Tracer] = None,
                 metrics: Optional[MetricsRegistry] = None):
        self.engine_id = engine_id
        self.cfg = cfg
        self.params = params
        self.pool = pool
        self.page = page_size
        self.prefix_cache = prefix_cache
        self.evict_policy = evict_policy
        self.prefill_chunk = prefill_chunk
        self.tracer = tracer
        self.metrics = metrics
        if kv_store is None:
            raise NotImplementedError(
                "dense KV storage (one private cache per request) comes with "
                "the models/ slice of the port; pass a PagedKVStore")
        self.kv_store = kv_store
        if kernel_impl is None:
            from repro_torch.serve.paged_model import paged_impl
            kernel_impl = paged_impl(kv_store.device)
        self.kernel_impl = kernel_impl
        self._stop = threading.Event()
        self.prefill_tokens = 0
        self.prefill_tokens_skipped = 0
        # bytes of KV written into the pages at admission, split by
        # prefix-cache outcome (the benchmark's bytes-copied-per-request
        # axis): only freshly written pages count
        self.kv_bytes_copied_hit = 0
        self.kv_bytes_copied_miss = 0
        self.admitted_hit = 0
        self.admitted_miss = 0
        # voluntary chunk-level preemption: when set (by the scheduler, on
        # prefill workers ONLY -- an inline decode admission has no shared
        # queue to yield back to), consulted at every chunk boundary; a
        # True return re-queues the request as a resumable partial
        self.preempt_check = None
        self.preemptions = 0
        self.error: Optional[BaseException] = None
        self._thread: Optional[threading.Thread] = None

    # -- admission (prefix-cache aware) --

    @staticmethod
    def _prefix_key(tokens: List[int]):
        return ("kv-prefix", tuple(tokens))

    def _lookup_prefix(self, r: Request):
        """Longest cached page-aligned prefix of r.prompt; returns
        (shared_blocks, prefilled_len).  One logical lookup = one hit or one
        miss in the stats, however many lengths it probes.  The payload of
        an entry is only ``plen``: the physical pages ARE the KV, already
        named by the entry's block ids."""
        n_full = len(r.prompt) // self.page
        for k in range(n_full, 0, -1):
            hit = self.pool.acquire_prefix(
                self.engine_id, self._prefix_key(r.prompt[:k * self.page]),
                count_miss=False)
            if hit is not None:
                return hit
        if n_full:
            self.pool.count_prefix_miss()
        return [], 0

    def _allocate(self, n_blocks: int) -> List[int]:
        """Allocate with pressure fallbacks: reclaim, then (when the prefix
        cache is on) evict prefixes under the configured policy -- a small
        batch first, so hot entries survive a transient spike -- and
        reclaim again.  The last resort is an unconditional LRU sweep of
        everything: refcount-aware eviction may legitimately find nothing
        evictable (every entry has live readers), and shedding hot cache
        capacity beats failing the allocation outright."""
        eid = self.engine_id
        try:
            return self.pool.allocate(eid, n_blocks)
        except OutOfBlocks:
            self.pool.reclaim(eid)
        try:
            return self.pool.allocate(eid, n_blocks)
        except OutOfBlocks:
            if not self.prefix_cache:
                raise
        for batch, policy in ((4, self.evict_policy), (None, "lru")):
            self.pool.evict_prefixes(eid, batch, policy=policy)
            self.pool.reclaim(eid)
            try:
                return self.pool.allocate(eid, n_blocks)
            except OutOfBlocks:
                if batch is None:
                    raise
        raise AssertionError("unreachable")

    def _admit_blocks(self, r: Request) -> bool:
        """First-touch admission: prefix lookup + block allocation.  Returns
        False -- with the request rolled back untouched -- when the pool is
        out of blocks.  On success the caller's engine owns the request's
        blocks (``r.owner``) and ``r.prefilled`` reflects the prefix hit."""
        shared: List[int] = []
        plen = 0
        if self.prefix_cache:
            shared, plen = self._lookup_prefix(r)
        n_total = (len(r.prompt) + r.max_new + self.page - 1) // self.page
        try:
            r.blocks = self._allocate(n_total - len(shared))
        except OutOfBlocks:
            if shared:
                self.pool.release_shared(self.engine_id, shared)
                self.pool.rollback_prefix_hit(len(shared))
            return False
        r.shared_blocks = shared
        r.prefilled = r.hit_len = plen
        r.cache_hit = plen > 0
        r.owner = self.engine_id
        self.prefill_tokens_skipped += plen
        if plen:
            self.admitted_hit += 1
        else:
            self.admitted_miss += 1
        return True

    def _adopt(self, r: Request) -> None:
        """Take ownership of a handed-off request's blocks (prefill ->
        decode, a resumable partial picked up by a peer, or a scheduler
        migration).  If the source engine crashed after the handoff was
        queued its blocks were already recovered onto a survivor, and the
        pool refuses the transfer (:class:`StaleHandoff`): reset the
        request to un-admitted so the caller re-admits it from scratch --
        re-running a prefill is always safe, resurrecting recovered blocks
        never is."""
        if r.owner is None or r.owner == self.engine_id:
            return
        try:
            self.pool.adopt(r.owner, self.engine_id, r.blocks,
                            r.shared_blocks)
            r.owner = self.engine_id
        except StaleHandoff:
            r.reset_admission()

    # -- observability (publish-on-flush: thread-local buffers/shards) --

    def _note_pickup(self, r: Request, now: float, metric: str) -> None:
        """First pickup of a submitted request: close its queue-wait phase
        and record the wait.  Later pickups (prefill->decode handoff, a
        resumed partial prefill) are not queue waits and no-op."""
        if r.t_admitted:
            return
        r.t_admitted = now
        if self.metrics is not None and r.t_submit:
            self.metrics.record(metric, now - r.t_submit)
        tr = self.tracer
        if tr is not None and tr.enabled and r.aid is not None:
            tr.async_end("queue_wait", r.aid, cat="request")

    def _note_token(self, r: Request, now: float) -> None:
        """Token cadence: TTFT on the first generated token, inter-token
        latency afterwards."""
        m = self.metrics
        if len(r.out) == 1:
            r.t_first_tok = now
            if m is not None and r.t_submit:
                m.record("ttft_s", now - r.t_submit)
            tr = self.tracer
            if tr is not None and tr.enabled and r.aid is not None:
                tr.instant("first_token", cat="request",
                           args={"rid": r.rid})
        elif m is not None and r.t_last_tok:
            m.record("tok_latency_s", now - r.t_last_tok)
        r.t_last_tok = now

    def _note_preempt(self, r: Request) -> None:
        """Voluntary chunk-boundary preemption: the request stays resumable
        (blocks owned, ``r.prefilled`` partial) and goes back to the shared
        queue -- the scheduler's policy decided someone else should run
        first.  Count it on the request, the actor, and the metrics
        registry; leave a trace instant."""
        r.preemptions += 1
        self.preemptions += 1
        if self.metrics is not None:
            self.metrics.counter("preemption").inc()
        tr = self.tracer
        if tr is not None and tr.enabled:
            tr.instant("preempt", cat="sched",
                       args={"rid": r.rid, "prefilled": r.prefilled,
                             "remaining": len(r.prompt) - r.prefilled})

    def _finish_trace(self, r: Request, *, finalized: bool = False) -> None:
        """Close the request's async span tree (retire instant + request
        end).  ``finalized`` marks the fail/stop path."""
        tr = self.tracer
        if tr is None or not tr.enabled or r.aid is None:
            return
        tr.instant("retire", cat="request",
                   args={"rid": r.rid, "tokens": len(r.out),
                         "finalized": finalized})
        tr.async_end("request", r.aid, cat="request")
        r.aid = None

    # -- chunked prefill (the bounded ping-delivery window) --

    def _run_prefill(self, r: Request) -> bool:
        """Materialize r's prompt KV from ``r.prefilled`` to the end, with a
        ``pool.safepoint`` between chunks so a reclaimer ping that lands
        mid-prefill is serviced within ONE chunk of forward work.  Returns
        False if stopped mid-prompt -- the request is left resumable
        (``r.prefilled`` partial, blocks still owned) for a peer or a later
        admission to continue from."""
        if r.prefilled >= len(r.prompt):
            self._publish_prefix(r)          # full-hit: nothing to prefill
            return True
        return self._prefill_paged(r)

    def _publish_prefix(self, r: Request) -> None:
        """Insert the full page-aligned prompt prefix into the pool's cache
        once its KV is materialized -- at the boundary crossing, so a long
        tail never delays publication (and a partial handoff publishes at
        most once: ``hit_len`` records what is already covered)."""
        n_full = len(r.prompt) // self.page
        boundary = n_full * self.page
        if (not self.prefix_cache or not n_full or r.hit_len >= boundary
                or r.prefilled < boundary):
            return
        self._insert_prefix(r, n_full, payload=boundary)
        r.hit_len = boundary

    def _prefill_paged(self, r: Request) -> bool:
        """Chunked paged prefill: one batched forward per chunk through the
        paged kernel (prefix-shared and earlier-chunk pages gathered in
        place), pages written incrementally via write_prefill(start=).

        SMR safety: ``_publish_prefix`` runs after the chunk's page writes
        were issued, on the same stream every reader's kernels use, so a
        peer that gathers the published pages is ordered after the writes.
        Keep that order in any overlap work (side streams, CUDA graphs)."""
        from repro_torch.serve.paged_model import prefill_kv_chunked

        store = self.kv_store
        hit = r.cache_hit
        tr = self.tracer
        t_chunk = time.monotonic()
        for end, _ in prefill_kv_chunked(
                self.params, self.cfg, store, r.all_blocks, r.prompt,
                self.prefill_chunk, start=r.prefilled,
                impl=self.kernel_impl):
            written = (end - r.prefilled) * store.token_bytes
            self.prefill_tokens += end - r.prefilled
            if tr is not None and tr.enabled:
                now = time.monotonic()
                tr.complete("prefill_chunk", tr.wall_ts(t_chunk),
                            (now - t_chunk) * 1e6, cat="serve",
                            args={"rid": r.rid, "start": r.prefilled,
                                  "end": end})
                t_chunk = now
            r.prefilled = end
            if hit:
                self.kv_bytes_copied_hit += written
            else:
                self.kv_bytes_copied_miss += written
            self._publish_prefix(r)
            # per-chunk safepoint: THE bounded ping-delivery point
            self.pool.safepoint(self.engine_id)
            if self._stop.is_set() and r.prefilled < len(r.prompt):
                return False
            # voluntary preemption at the same boundary (prefill workers
            # only); the loop body already ran once, so every pickup makes
            # at least one chunk of progress -- no preemption livelock
            if (r.prefilled < len(r.prompt) and self.preempt_check is not None
                    and self.preempt_check(r)):
                self._note_preempt(r)
                return False
        return True

    def _finalize(self, r: Request) -> None:
        """Fail/stop-path completion (see :func:`finalize_request`)."""
        finalize_request(self.pool, r, self.tracer)

    def _insert_prefix(self, r: Request, n_full: int, payload) -> None:
        """Publish the full page-aligned prompt prefix: blocks 0..n_full-1
        of the request (cached-shared first, then private) with payload
        ``plen`` -- the pages themselves are the KV."""
        k = len(r.shared_blocks)
        converts = r.blocks[:n_full - k]
        prefix_blocks = r.shared_blocks + converts
        key = self._prefix_key(r.prompt[:n_full * self.page])
        if self.pool.share_prefix(self.engine_id, key, prefix_blocks,
                                  payload=payload):
            # converted blocks are now shared: release (not retire) on finish
            r.blocks = r.blocks[n_full - k:]
            r.shared_blocks = prefix_blocks

    # -- lifecycle --

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name=self._thread_name())
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=30)

    def _thread_name(self) -> str:
        return f"actor-{self.engine_id}"

    def _loop(self) -> None:  # pragma: no cover -- subclasses override
        raise NotImplementedError


class EngineWorker(_PoolActor):
    """One engine id of the pool: continuous-batching decode loop, SMR
    reader sessions, optional prefix-cache admission.  With prefill workers
    upstream it only ever installs ready pages; without them it runs the
    same chunked prefill inline."""

    def __init__(self, engine_id: int, cfg, params, pool: BlockPool,
                 *, max_batch: int = 8, page_size: int = 16,
                 prefix_cache: bool = False,
                 kv_store: Optional[PagedKVStore] = None,
                 kernel_impl: Optional[str] = None,
                 evict_policy: str = "lru", prefill_chunk: int = 16,
                 tracer: Optional[Tracer] = None,
                 metrics: Optional[MetricsRegistry] = None,
                 stall_every: int = 0, stall_s: float = 0.0):
        super().__init__(engine_id, cfg, params, pool,
                         page_size=page_size,
                         prefix_cache=prefix_cache, kv_store=kv_store,
                         kernel_impl=kernel_impl, evict_policy=evict_policy,
                         prefill_chunk=prefill_chunk, tracer=tracer,
                         metrics=metrics)
        self.max_batch = max_batch
        self.queue: "queue.Queue[Request]" = queue.Queue()
        self.running: Dict[int, Request] = {}
        self.max_abs_logit = 0.0          # largest |logit| decoded so far
        self.steps = 0
        # fault injection: every Nth decode step, sleep mid-step for
        # stall_s -- AFTER reserving the step's reader session and BEFORE
        # any safepoint, i.e. exactly the descheduled-reader window the
        # paper's "not frequently delayed" condition is about.  A POP ping
        # that lands during the stall waits the full sleep for this
        # reader's publish; an EBR-style pass pins the epoch and garbage
        # accumulates instead.  (FaultPlan can't produce this: driven sim
        # code is exempt from plan faults -- this knob stalls the REAL
        # worker thread.)
        self.stall_every = stall_every
        self.stall_s = stall_s
        self.injected_stalls = 0

    # -- scheduler-facing API --

    @property
    def load(self) -> int:
        """Outstanding work (queued + in flight); placement key."""
        return self.queue.qsize() + len(self.running)

    def enqueue(self, r: Request) -> None:
        self.queue.put(r)
        if self.error is not None:
            # worker already failed: it will never drain the queue again
            self.drain_queue()

    def drain_queue(self) -> None:
        while True:
            try:
                self.queue.get_nowait().done.set()
            except queue.Empty:
                return

    def _thread_name(self) -> str:
        return f"engine-{self.engine_id}"

    # -- admission --

    def _admit(self) -> None:
        while len(self.running) < self.max_batch:
            try:
                r = self.queue.get_nowait()
            except queue.Empty:
                return
            self._note_pickup(r, time.monotonic(), "queue_wait_s")
            if not r.prompt:
                # empty request: nothing to decode from; finish immediately
                # (the kernel-level empty-row case is exercised directly in
                # the block-table raggedness tests)
                self._finish_trace(r)
                r.done.set()
                continue
            if r.owner is not None:
                # handed-off request: adopt its blocks (may reset the
                # request to un-admitted on a stale handoff -- source
                # engine crashed, blocks already recovered)
                self._adopt(r)
            if r.owner is None:
                # inline admission: the no-prefill-worker path, the
                # fallback when the prefill stage has failed, and
                # stale-handoff re-admission
                if not self._admit_blocks(r):
                    self.queue.put(r)   # out of blocks: retry later
                    return
            if not self._run_prefill(r):
                # stopping mid-inline-prefill: no peer can resume a
                # request on OUR private queue (unlike the shared prefill
                # queue), so finalize it -- blocks back to the pool,
                # waiter released -- instead of stranding it
                self._finalize(r)
                return
            self.running[r.rid] = r

    # -- decode step (POP reader) --

    def _step(self) -> None:
        if not self.running:
            time.sleep(0.001)
            return
        t_step = time.monotonic()
        batch = len(self.running)
        # one batched reader session over the whole step's working set: the
        # paper's traversal-retention argument at serving granularity (one
        # publish on ping instead of a fence per block)
        session = [b for r in self.running.values() for b in r.all_blocks]
        self.pool.reserve(self.engine_id, session)
        if self.stall_every and self.steps % self.stall_every == \
                self.stall_every - 1:
            self.injected_stalls += 1
            tr = self.tracer
            if tr is None or not tr.enabled:
                time.sleep(self.stall_s)
            else:
                t0 = time.monotonic()
                time.sleep(self.stall_s)
                tr.complete("desched_stall", tr.wall_ts(t0),
                            (time.monotonic() - t0) * 1e6, cat="fault",
                            args={"engine": self.engine_id})
        finished = self._step_paged()
        for rid in finished:
            r = self.running.pop(rid)
            self.pool.retire(self.engine_id, r.blocks)      # -> SMR
            if r.shared_blocks:
                self.pool.release_shared(self.engine_id, r.shared_blocks)
            r.blocks, r.shared_blocks = [], []
            self._finish_trace(r)
            r.done.set()
        self.steps += 1
        tr = self.tracer
        if tr is not None and tr.enabled:
            tr.complete("decode_step", tr.wall_ts(t_step),
                        (time.monotonic() - t_step) * 1e6, cat="serve",
                        args={"batch": batch, "finished": len(finished)})

    def _step_paged(self) -> List[int]:
        """ONE batched (table, lens, q) decode through the paged kernel:
        every running request becomes a block-table row over the shared
        physical pages -- ragged lengths, prefix pages included in place.

        SMR safety: the argmax is copied to the host (a sync on the one
        stream all page reads, writes and fills use) before the caller's
        ``end_step`` closes this step's reader session, so no page this
        step's kernels read can be freed and refilled while they run.  Any
        overlap work (side streams, CUDA graphs) must keep that condition."""
        from repro_torch.serve.paged_model import paged_decode_step

        rs = list(self.running.values())
        gather = [b for r in rs for b in r.all_blocks]
        self.pool.touch(self.engine_id, gather)             # pool tripwire
        self.kv_store.assert_alive(self.engine_id, gather)  # page tripwire
        blocks = [r.all_blocks for r in rs]
        lens = [len(r.prompt) + len(r.out) for r in rs]
        last = [r.out[-1] if r.out else r.prompt[-1] for r in rs]
        logits = paged_decode_step(self.params, self.cfg, self.kv_store,
                                   blocks, lens, last,
                                   impl=self.kernel_impl)
        nxt = logits.argmax(dim=-1).cpu().numpy()
        # health gauge: a logit beyond the page poison scale (or a NaN,
        # which nan_to_num turns into inf) means junk was read
        peak = float(torch.nan_to_num(logits.float().abs().amax(),
                                      nan=float("inf")))
        self.max_abs_logit = max(self.max_abs_logit, peak)
        now = time.monotonic()
        finished = []
        for r, tok in zip(rs, nxt):
            r.out.append(int(tok))
            self._note_token(r, now)
            if len(r.out) >= r.max_new:
                finished.append(r.rid)
        return finished

    def _loop(self) -> None:
        try:
            while not self._stop.is_set():
                self.pool.start_step(self.engine_id)  # announce + safepoint
                self._admit()
                self._step()
                self.pool.end_step(self.engine_id)    # closes the session
        except BaseException as e:  # noqa: BLE001 -- UseAfterFree et al.
            # fail FAST: record the error and release every waiter instead
            # of dying silently and leaving clients to hit done.wait timeouts
            self.error = e
            for r in list(self.running.values()):
                r.done.set()
            self.drain_queue()


class PrefillWorker(_PoolActor):
    """Dedicated prefill stage: drains the scheduler's shared prefill queue,
    runs chunked prefill under its OWN engine id (a first-class SMR reader:
    its allocations, prefix refs, and safepoints are its own slots in every
    reclaim policy's fan-out), and hands requests to decode workers through
    the scheduler.

    The step bracket is one REQUEST (the epoch announce pins for the whole
    prefill -- deliberately the paper's delayed-reader regime), while the
    safepoint cadence is one CHUNK: a publish-on-ping pass that lands
    mid-prefill completes within one chunk of forward work instead of one
    prompt.  A worker stopped mid-request re-queues it partially prefilled;
    whoever picks it up adopts the blocks and resumes from ``r.prefilled``.
    """

    def __init__(self, engine_id: int, cfg, params, pool: BlockPool, **kw):
        super().__init__(engine_id, cfg, params, pool, **kw)
        self._scheduler = None            # bound by Scheduler.__init__
        self.requests = 0                 # completed prefills

    def bind(self, scheduler) -> None:
        self._scheduler = scheduler
        self.queue = scheduler.prefill_queue

    def _thread_name(self) -> str:
        return f"prefill-{self.engine_id}"

    def prefill_one(self, r: Request) -> bool:
        """Admit (or adopt) and prefill one request; returns True when its
        prompt KV is fully materialized.  False means either allocation
        pressure (request untouched) or a stop mid-prefill (request
        partially prefilled, resumable) -- in both cases the caller
        re-queues it."""
        if r.owner is not None:
            self._adopt(r)   # may reset to un-admitted on a stale handoff
        if r.owner is None:
            if not self._admit_blocks(r):
                return False
        return self._run_prefill(r)

    def _loop(self) -> None:
        r: Optional[Request] = None
        try:
            while not self._stop.is_set():
                # idle safepoint: an idle prefill reader must still service
                # ping fan-outs promptly (its slot is part of every pass)
                self.pool.safepoint(self.engine_id)
                try:
                    r = self.queue.get(timeout=0.002)
                except queue.Empty:
                    continue
                self._note_pickup(r, time.monotonic(),
                                  "prefill_queue_wait_s")
                tr = self.tracer
                traced = (tr is not None and tr.enabled
                          and r.aid is not None)
                if traced:
                    tr.async_begin("prefill", r.aid, cat="request",
                                   args={"resume_from": r.prefilled})
                self.pool.start_step(self.engine_id)
                before_pre = r.preemptions
                try:
                    done = self.prefill_one(r)
                finally:
                    self.pool.end_step(self.engine_id)
                    if traced:
                        tr.async_end("prefill", r.aid, cat="request")
                if done:
                    self.requests += 1
                    self._scheduler.place_ready(r)
                else:
                    # allocation pressure, preemption, or stop: back on the
                    # shared queue (resumable -- a peer adopts the blocks
                    # and continues).  Read the preempted flag BEFORE the
                    # re-put: afterwards a peer may already be mutating r.
                    preempted = r.preemptions > before_pre
                    self.queue.put(r)
                    if not self._stop.is_set() and not preempted:
                        time.sleep(0.002)   # don't spin on an empty pool
                r = None
        except BaseException as e:  # noqa: BLE001
            self.error = e
            if r is not None:
                # the in-flight request's state is suspect (the error may
                # have struck mid-chunk): fail fast -- blocks back to the
                # pool so capacity is not leaked while the rest of the
                # system keeps serving, waiter released
                self._finalize(r)
            # if the whole prefill stage is dead, hand the still-untouched
            # queued requests to the decode fleet -- inline chunked prefill
            # serves them (the promised graceful degradation; the scheduler
            # stops routing here once no worker is alive)
            sched = self._scheduler
            if sched is not None and not any(
                    pw.error is None for pw in sched.prefill_workers):
                sched.reroute_prefill_queue()


class Reclaimer:
    """First-class reclaimer thread: owns its own engine id in the pool
    (announced quiescent, never a reader), periodically bumps the epoch and
    runs the policy's reclamation pass -- under pressure the EpochPOP
    fallback pings ALL worker engines concurrently (decode AND prefill
    workers: prefill readers join the ping fan-out), the fan-out the paper
    measures.  When the free list runs low it also evicts LRU prefix-cache
    entries, whose blocks then flow retire -> SMR -> free."""

    def __init__(self, pool: BlockPool, engine_id: int, *,
                 interval_s: float = 0.002,
                 low_watermark: Optional[int] = None, evict_batch: int = 4,
                 evict_policy: str = "lru"):
        self.pool = pool
        self.engine_id = engine_id
        self.interval_s = interval_s
        self.low_watermark = (max(2, pool.num_blocks // 8)
                              if low_watermark is None else low_watermark)
        self.evict_batch = evict_batch
        self.evict_policy = evict_policy
        self.passes = 0
        self.error: Optional[BaseException] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="reclaimer")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=30)

    def _loop(self) -> None:
        try:
            while not self._stop.wait(self.interval_s):
                # service pings aimed at OUR engine slot: a worker-initiated
                # publish-on-ping pass pings every other slot, and this one
                # holds no reservations -- publish the (empty) set promptly
                # instead of stalling that worker until its ping timeout
                self.pool.safepoint(self.engine_id)
                if (self.pool.free_blocks <= self.low_watermark
                        and self.pool.prefix_entries):
                    self.pool.evict_prefixes(self.engine_id, self.evict_batch,
                                             policy=self.evict_policy)
                self.pool.reclaim(self.engine_id)
                self.passes += 1
        except BaseException as e:  # noqa: BLE001
            self.error = e
