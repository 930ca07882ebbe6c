"""Scheduler: admission, the policy-ordered prefill queue, preemption, and
request->engine placement (with cross-engine migration) for the sharded
serving runtime.

The scheduler is the single client-facing entry point.  It hands out
request ids under a lock (clients submit from many threads), routes fresh
requests either into the shared **prefill queue** (when dedicated
:class:`~repro_torch.serve.worker.PrefillWorker` threads are configured) or
straight onto a live decode worker, and owns the lifecycle of both worker
fleets, the dedicated reclaimer, and the optional migration monitor.

Three scheduling axes, each independently switchable:

* **Ordering** (``sched_policy``): the shared prefill queue is a
  :class:`PrefillQueue` -- a priority queue drained by every prefill worker
  (work stealing; partially prefilled requests a peer re-queued included).
  ``fifo`` preserves arrival order; ``sjf`` is shortest-*remaining*-prompt
  first (a resumed partial sorts by what is LEFT, not by its full prompt);
  ``deadline`` is earliest-deadline-first with best-effort (no deadline)
  requests sorting last.  Every pop that overtakes an older entry counts as
  a ``queue_reorder``.
* **Preemption** (``preempt_prefill``): prefill workers consult the
  scheduler at every chunk boundary -- the SAME ``pool.safepoint()`` cadence
  that bounds the publish-on-ping delivery window.  When a queued request's
  remaining work is shorter (by ``preempt_margin`` tokens) than the running
  one's, the runner re-queues itself as a resumable partial
  (``r.prefilled`` kept, blocks still owned) and whoever picks either up
  adopts the blocks via :meth:`BlockPool.adopt`.  Preemption is voluntary
  and chunk-aligned, so it never stretches the ping window.
* **Migration** (``migrate``): a monitor thread watches per-engine load and
  moves queued requests from the hottest live decode worker to the coolest
  when the spread exceeds ``migrate_threshold``.  Moving a request whose
  blocks live on another engine is a :meth:`BlockPool.adopt` -- atomic
  against a concurrent publish-on-ping pass (destination gains before
  source loses, so a publish snapshot never misses the blocks) and
  validated against crashed sources (a stale handoff resets the request to
  un-admitted instead of resurrecting recovered blocks).

Placement (``place_policy``) is ``least-loaded`` (round-robin among ties)
or ``static`` (rid-hash, deliberately skew-prone -- the benchmark profile
migration has to rescue).  When a prefill worker finishes a request it
calls :meth:`place_ready`, so decode load balancing is identical whether
prefill happened upstream or will happen inline.  If every prefill worker
has failed, ``submit`` degrades gracefully to direct decode placement
(decode workers still run chunked prefill inline).

Continuous batching itself stays in the decode workers: each admits from
its own queue up to ``max_batch`` at every step boundary, so admission
never blocks a decode step on another engine's queue lock.

Shutdown (:meth:`Scheduler.stop`) finalizes whatever is stranded on the
prefill queue through the worker-independent
:func:`~repro_torch.serve.worker.finalize_request` seam -- blocks back to the
pool under the owning engine id, waiters released -- so the pool stays
leak-free even when there are zero prefill workers left (or none were ever
configured) while partials sit queued.
"""

from __future__ import annotations

import heapq
import queue
import threading
import time
from typing import List, Optional, Sequence, Tuple

from repro_torch.obs import MetricsRegistry, Tracer
from repro_torch.runtime.block_pool import BlockPool, StaleHandoff
from repro_torch.serve.worker import (EngineWorker, PrefillWorker, Reclaimer,
                                Request, finalize_request, join_stopped)

#: prefill-queue ordering policies
SCHED_POLICIES = ("fifo", "sjf", "deadline")
#: decode placement policies
PLACE_POLICIES = ("least-loaded", "static")


class PrefillQueue:
    """Policy-ordered shared prefill queue (heap + condition variable).

    Drop-in for the ``queue.Queue`` surface the prefill workers and tests
    use (``put`` / ``get(timeout=)`` / ``get_nowait`` / ``empty`` /
    ``qsize``), plus :meth:`peek_remaining` for the preemption comparator.
    Keys are computed at put time -- a re-queued partial re-sorts by its
    updated remaining length -- and a unique monotone sequence number
    breaks ties, preserving FIFO among equals and keeping ``Request``
    itself out of comparisons.  ``reorders`` counts pops that overtook an
    older entry (i.e. decisions where the policy changed the order FIFO
    would have produced).
    """

    def __init__(self, policy: str = "fifo",
                 metrics: Optional[MetricsRegistry] = None):
        if policy not in SCHED_POLICIES:
            raise ValueError(f"unknown sched_policy {policy!r}; "
                             f"expected one of {SCHED_POLICIES}")
        self.policy = policy
        self.metrics = metrics
        self.reorders = 0
        self._heap: List[Tuple] = []
        self._seq = 0
        self._cond = threading.Condition()

    @staticmethod
    def _remaining(r: Request) -> int:
        return max(len(r.prompt) - r.prefilled, 0)

    def _key(self, r: Request) -> Tuple:
        if self.policy == "sjf":
            return (self._remaining(r),)
        if self.policy == "deadline":
            # best-effort requests sort after every deadline-bearing one;
            # remaining length breaks deadline ties toward short jobs
            if r.deadline_s is not None:
                return (0, r.deadline_s, self._remaining(r))
            return (1, 0.0, self._remaining(r))
        return ()                                        # fifo: seq only

    def put(self, r: Request) -> None:
        with self._cond:
            self._seq += 1
            heapq.heappush(self._heap, (*self._key(r), self._seq, r))
            self._cond.notify()

    def _pop(self) -> Request:
        entry = heapq.heappop(self._heap)
        seq = entry[-2]
        if any(e[-2] < seq for e in self._heap):
            # this pop overtook at least one older entry: the policy
            # actively reordered relative to arrival order
            self.reorders += 1
            if self.metrics is not None:
                self.metrics.counter("queue_reorder").inc()
        return entry[-1]

    def get(self, block: bool = True, timeout: Optional[float] = None
            ) -> Request:
        with self._cond:
            if not block:
                if not self._heap:
                    raise queue.Empty
                return self._pop()
            deadline = None if timeout is None else time.monotonic() + timeout
            while not self._heap:
                remaining = None if deadline is None \
                    else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    raise queue.Empty
                self._cond.wait(remaining)
            return self._pop()

    def get_nowait(self) -> Request:
        return self.get(block=False)

    def empty(self) -> bool:
        with self._cond:
            return not self._heap

    def qsize(self) -> int:
        with self._cond:
            return len(self._heap)

    def peek_remaining(self) -> Optional[int]:
        """Remaining prompt length of the head entry (None when empty):
        what the preemption comparator weighs a running prefill against."""
        with self._cond:
            if not self._heap:
                return None
            return self._remaining(self._heap[0][-1])


class Scheduler:
    """Admission + placement over N decode workers, optional prefill
    workers, one reclaimer, and an optional migration monitor."""

    def __init__(self, workers: Sequence[EngineWorker],
                 reclaimer: Optional[Reclaimer] = None,
                 prefill_workers: Sequence[PrefillWorker] = (),
                 tracer: Optional[Tracer] = None,
                 metrics: Optional[MetricsRegistry] = None,
                 pool: Optional[BlockPool] = None,
                 sched_policy: str = "fifo",
                 preempt: bool = False, preempt_margin: int = 0,
                 place_policy: str = "least-loaded",
                 migrate: bool = False, migrate_interval_s: float = 0.02,
                 migrate_threshold: int = 4):
        if place_policy not in PLACE_POLICIES:
            raise ValueError(f"unknown place_policy {place_policy!r}; "
                             f"expected one of {PLACE_POLICIES}")
        self.workers: List[EngineWorker] = list(workers)
        self.reclaimer = reclaimer
        self.prefill_workers: List[PrefillWorker] = list(prefill_workers)
        self.tracer = tracer
        self.metrics = metrics
        self.pool = pool if pool is not None \
            else (self.workers[0].pool if self.workers else None)
        self.sched_policy = sched_policy
        self.prefill_queue = PrefillQueue(sched_policy, metrics=metrics)
        self.preempt = preempt
        self.preempt_margin = preempt_margin
        self.place_policy = place_policy
        self.migrate = migrate
        self.migrate_interval_s = migrate_interval_s
        self.migrate_threshold = migrate_threshold
        self.migrations = 0
        for pw in self.prefill_workers:
            pw.bind(self)
            if preempt:
                # chunk-boundary preemption hook: prefill workers ONLY (an
                # inline decode admission has no shared queue to yield to)
                pw.preempt_check = self._preempt_check
        self._rid = 0
        self._rid_lock = threading.Lock()
        self._place = 0         # round-robin tiebreak cursor
        self._mig_stop = threading.Event()
        self._mig_thread: Optional[threading.Thread] = None
        self._mig_error: Optional[BaseException] = None

    # -- client API --

    def submit(self, prompt: Sequence[int], max_new: int = 16,
               deadline_s: Optional[float] = None) -> Request:
        with self._rid_lock:
            self._rid += 1
            rid = self._rid
        r = Request(rid, list(prompt), max_new)
        r.t_submit = time.monotonic()
        if deadline_s is not None:
            r.deadline_s = r.t_submit + deadline_s
        tr = self.tracer
        if tr is not None and tr.enabled:
            # the request's async span tree starts on the client thread;
            # every later phase (queue wait / prefill / decode) nests under
            # the same id wherever it runs
            r.aid = tr.next_async_id()
            tr.async_begin("request", r.aid, cat="request",
                           args={"rid": rid, "prompt_len": len(r.prompt),
                                 "max_new": max_new})
            tr.async_begin("queue_wait", r.aid, cat="request")
        # empty prompts skip the prefill stage (nothing to prefill; decode
        # admission finishes them immediately)
        if r.prompt and any(pw.error is None for pw in self.prefill_workers):
            self.prefill_queue.put(r)
            if not any(pw.error is None for pw in self.prefill_workers):
                # the last prefill worker died between the liveness check
                # and the put: its dead-stage reroute may already have
                # drained the queue, so reroute again -- otherwise this
                # request would sit unread forever
                self.reroute_prefill_queue()
            return r
        return self.place_ready(r)

    def reroute_prefill_queue(self) -> None:
        """Hand every queued prefill request -- partially prefilled ones
        included -- to the decode fleet, whose admission runs the same
        chunked prefill inline (and adopts any blocks a dead prefill
        worker still owns).  Called when the prefill stage has failed;
        queue.get exclusivity guarantees each request is placed once even
        if several threads reroute concurrently."""
        while True:
            try:
                r = self.prefill_queue.get_nowait()
            except queue.Empty:
                return
            self.place_ready(r)

    def place_ready(self, r: Request) -> Request:
        """Place a prefilled (or inline-admissible) request onto a live
        decode worker.  Entry point for both fresh submissions (no prefill
        stage) and prefill-worker handoffs of ready/partial requests.
        ``least-loaded`` breaks ties round-robin; ``static`` hashes the rid
        (skew-prone by design -- falls back to least-loaded only when the
        static target is dead)."""
        with self._rid_lock:
            self._place += 1
            tiebreak = self._place
        alive = [w for w in self.workers if w.error is None]
        if not alive:
            # whole fleet failed: release the waiter immediately
            r.done.set()
            return r
        n = len(self.workers)
        if self.place_policy == "static":
            w = self.workers[r.rid % n]
            if w.error is None:
                w.enqueue(r)
                return r
        w = min(alive, key=lambda w: (w.load, (w.engine_id + tiebreak) % n))
        w.enqueue(r)
        return r

    # -- preemption (consulted by prefill workers at chunk boundaries) --

    def _preempt_check(self, r: Request) -> bool:
        """Should the worker running ``r`` yield?  Yes iff the queue head
        has strictly less remaining work than ``r`` (by at least
        ``preempt_margin`` tokens) -- i.e. continuing ``r`` would make a
        shorter job wait behind it.  Progress is guaranteed by the callers:
        a pickup always completes at least one chunk before asking."""
        head = self.prefill_queue.peek_remaining()
        return (head is not None
                and head + self.preempt_margin
                < len(r.prompt) - r.prefilled)

    # -- migration --

    def rebalance(self) -> int:
        """One load-balance pass: if the hottest live decode worker leads
        the coolest by at least ``migrate_threshold`` queued+running
        requests, move up to half the spread from its queue.  Returns the
        number of requests moved."""
        alive = [w for w in self.workers if w.error is None]
        if len(alive) < 2:
            return 0
        hot = max(alive, key=lambda w: w.load)
        cool = min(alive, key=lambda w: w.load)
        spread = hot.load - cool.load
        if spread < self.migrate_threshold:
            return 0
        return self.migrate_queued(hot, cool, max_n=spread // 2)

    def migrate_queued(self, src: EngineWorker, dst: EngineWorker,
                       max_n: int = 1) -> int:
        """Move up to ``max_n`` queued requests from ``src`` to ``dst``,
        adopting each one's blocks onto ``dst``'s engine id.  Only QUEUED
        requests move -- a running request's blocks are inside ``src``'s
        current reader session, and queue.get exclusivity means nobody
        else is mutating what we pop."""
        moved = 0
        for _ in range(max_n):
            try:
                r = src.queue.get_nowait()
            except queue.Empty:
                break
            self._transfer(r, src.engine_id, dst.engine_id)
            dst.enqueue(r)
            moved += 1
        return moved

    def _transfer(self, r: Request, src_id: int, dst_id: int) -> None:
        """Re-home ``r``'s blocks onto ``dst_id`` via the pool's atomic
        adopt -- safe against a concurrent publish-on-ping pass by
        construction (the destination's live set gains the blocks before
        the source's loses them, under the pool lock).  A stale handoff
        (source engine crashed; its blocks were already recovered) resets
        the request to un-admitted: the destination re-admits and re-runs
        prefill from scratch rather than resurrect recovered blocks."""
        if (self.pool is not None and r.owner is not None
                and r.owner != dst_id):
            try:
                self.pool.adopt(r.owner, dst_id, r.blocks, r.shared_blocks)
                r.owner = dst_id
            except StaleHandoff:
                r.reset_admission()
        r.migrations += 1
        self.migrations += 1
        if self.metrics is not None:
            self.metrics.counter("migration").inc()
        tr = self.tracer
        if tr is not None and tr.enabled:
            tr.instant("migration", cat="sched",
                       args={"rid": r.rid, "src": src_id, "dst": dst_id,
                             "owner": r.owner})

    def _migrate_loop(self) -> None:
        try:
            while not self._mig_stop.wait(self.migrate_interval_s):
                self.rebalance()
        except BaseException as e:  # noqa: BLE001 -- surfaced via .error
            self._mig_error = e

    # -- lifecycle --

    def start(self) -> None:
        for w in self.workers:
            w.start()
        for pw in self.prefill_workers:
            pw.start()
        if self.reclaimer is not None:
            self.reclaimer.start()
        if self.migrate and len(self.workers) > 1:
            self._mig_thread = threading.Thread(
                target=self._migrate_loop, daemon=True, name="migrator")
            self._mig_thread.start()

    def stop(self) -> None:
        """Stop every actor; return once each one's thread has ended, else
        raise (the first actor's error, after trying to stop the rest)."""
        errors: List[RuntimeError] = []

        def attempt(fn, *args) -> None:
            try:
                fn(*args)
            except RuntimeError as e:
                errors.append(e)
        # prefill first: a worker stopped mid-request re-queues it
        # (resumable) instead of handing work to decoders that are about
        # to stop
        for pw in self.prefill_workers:
            attempt(pw.stop)
        # migration monitor next, so nothing shuffles queues mid-teardown
        self._mig_stop.set()
        attempt(join_stopped, self._mig_thread)
        # finalize whatever is stranded on the prefill queue, including
        # partially prefilled requests the stopping workers re-queued:
        # release their waiters and give their blocks back to the pool
        # (retire/release under the owning engine id), so shutdown leaves
        # the pool leak-free and no client hangs on done.wait.  This runs
        # through the worker-independent finalize_request seam: it must
        # work with zero live prefill workers (or none configured at all)
        while True:
            try:
                r = self.prefill_queue.get_nowait()
            except queue.Empty:
                break
            finalize_request(self.pool, r, self.tracer)
        for w in self.workers:
            attempt(w.stop)
        if self.reclaimer is not None:
            attempt(self.reclaimer.stop)
        if errors:
            raise errors[0]

    # -- aggregate views --

    @property
    def steps(self) -> int:
        return sum(w.steps for w in self.workers)

    @property
    def steps_per_engine(self) -> List[int]:
        return [w.steps for w in self.workers]

    @property
    def preemptions(self) -> int:
        return (sum(pw.preemptions for pw in self.prefill_workers)
                + sum(w.preemptions for w in self.workers))

    @property
    def queue_reorders(self) -> int:
        return self.prefill_queue.reorders

    @property
    def error(self) -> Optional[BaseException]:
        for w in self.workers:
            if w.error is not None:
                return w.error
        for pw in self.prefill_workers:
            if pw.error is not None:
                return pw.error
        if self._mig_error is not None:
            return self._mig_error
        if self.reclaimer is not None:
            return self.reclaimer.error
        return None
