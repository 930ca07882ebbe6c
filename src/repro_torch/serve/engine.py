"""ServeEngine facade over the sharded serving runtime.

Three layers (the reference package's topology):

* :class:`~repro_torch.serve.scheduler.Scheduler` -- admission, thread-safe
  request ids, request->engine placement, preemption and migration;
* N :class:`~repro_torch.serve.worker.EngineWorker` threads -- each an
  independent SMR reader with its own engine id and reader session over ONE
  shared :class:`~repro_torch.runtime.block_pool.BlockPool`, plus optional
  :class:`~repro_torch.serve.worker.PrefillWorker` threads;
* a :class:`~repro_torch.serve.worker.Reclaimer` thread -- retires/frees
  through the pluggable ReclaimPolicy, so publish-on-ping passes fan out to
  all readers concurrently.

Both KV stores of the reference are served: ``"dense"`` (one private
cache per request, decoded through ``apply_model``) and ``"paged"`` (K/V
in a shared :class:`~repro_torch.runtime.kv_store.PagedKVStore`,
attention and page writes through the CUDA kernels of ``kernels/``).  It
runs on ``cuda`` unless the caller passes ``device=``; without CUDA and
without a device it raises rather than carry on on the CPU.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.model import apply_model
from repro_torch.obs import MetricsRegistry, Tracer
from repro_torch.runtime.block_pool import BlockPool
from repro_torch.runtime.kv_store import PagedKVStore
from repro_torch.serve.scheduler import Scheduler
from repro_torch.serve.worker import (EngineWorker, PrefillWorker, Reclaimer,
                                Request)

__all__ = ["PagedKVStore", "Request", "ServeEngine"]


class ServeEngine:
    """Facade: Scheduler + N EngineWorkers + optional PrefillWorkers +
    Reclaimer over one BlockPool.

    ``kv_store`` selects the KV storage layer: ``"dense"`` keeps one
    private decode cache of ``max_seq`` positions per request (any
    architecture ``models/`` has), prefilled and decoded through
    ``apply_model(mode="decode")``; ``"paged"`` stores K/V physically in a
    shared :class:`~repro_torch.runtime.kv_store.PagedKVStore` keyed by the
    pool's block ids and decodes through the paged-attention kernel (GQA
    configs; see serve/paged_model.py).
    ``kv_storage`` picks where the pages live: ``"device"`` (the default:
    resident tensors updated in place by the scatter kernel, zero
    host->device bytes per steady-state decode step) or ``"host"`` (host
    tensors re-uploaded per layer per step -- kept for A/B measurement).
    ``device`` is where the model and kernels run: ``cuda`` unless given.
    ``kernel_impl`` ("torch" | "cuda" | None) overrides the kernels' choice
    (None: the CUDA kernels on a CUDA device, plain PyTorch on the CPU).
    ``sim_backend``/``sim_costs`` configure the simulator-backed SMR
    schemes (``smr`` naming any scheme of ``runtime.reclaim.
    supported_schemes()``): the backend (``"gen"`` or ``"vec"``) and the
    cost model.

    ``prefill_workers``/``prefill_chunk`` configure the async prefill
    pipeline: N dedicated prefill threads (each its own SMR reader slot in
    the pool) run chunked prefill -- one batched forward per
    ``prefill_chunk`` tokens, a pool safepoint between chunks -- and hand
    ready requests to the decode workers.  With ``prefill_workers=0``
    decode admission runs the same chunked prefill inline, so the
    ping-delivery window is chunk-bounded either way; the dedicated stage
    additionally keeps co-batched decodes flowing while long prompts
    prefill.

    Scheduling knobs (see serve/scheduler.py and docs/SERVING.md):
    ``sched_policy`` orders the shared prefill queue (``fifo`` | ``sjf`` |
    ``deadline``); ``preempt_prefill`` lets long prefills yield to shorter
    queued work at chunk boundaries (``preempt_margin`` tokens of
    hysteresis); ``place_policy`` picks decode placement (``least-loaded``
    | ``static``); ``migrate`` starts the load-balance monitor that moves
    queued requests off hot engines (every ``migrate_interval_s`` seconds
    when the load spread reaches ``migrate_threshold``), adopting their KV
    blocks across engine ids via the pool.
    """

    def __init__(self, cfg: ArchConfig, params, *, max_batch: int = 8,
                 page_size: int = 16, num_pages: int = 256,
                 max_seq: int = 256, pool: Optional[BlockPool] = None,
                 smr: Optional[str] = None, n_engines: int = 1,
                 prefix_cache: bool = False,
                 reclaim_interval_s: float = 0.002,
                 sim_backend: str = "gen", sim_costs=None,
                 kv_store: str = "dense", kv_storage: str = "device",
                 kernel_impl: Optional[str] = None,
                 device=None,
                 evict_policy: str = "lru",
                 prefill_workers: int = 0, prefill_chunk: int = 16,
                 trace: Optional[Tracer] = None,
                 metrics: Optional[MetricsRegistry] = None,
                 stall_every: int = 0, stall_s: float = 0.0,
                 stall_workers: Optional[Sequence[int]] = None,
                 sched_policy: str = "fifo",
                 preempt_prefill: bool = False, preempt_margin: int = 0,
                 place_policy: str = "least-loaded",
                 migrate: bool = False, migrate_interval_s: float = 0.02,
                 migrate_threshold: int = 4):
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "ServeEngine runs on CUDA and no CUDA device is "
                    "available; pass device='cpu' to run on the CPU")
            device = "cuda"
        self.device = torch.device(device)
        self.cfg = cfg
        self.params = params
        # observability: an engine-level registry always exists (recording
        # into unmerged thread-local shards is the cheap default); the
        # tracer is opt-in and is shared with the pool so SMR ping spans
        # land in the same trace as the request lifecycle
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.tracer = trace
        if kv_store not in ("dense", "paged"):
            raise ValueError(f"kv_store must be 'dense' or 'paged', "
                             f"got {kv_store!r}")
        if kv_storage not in ("host", "device"):
            raise ValueError(f"kv_storage must be 'host' or 'device', "
                             f"got {kv_storage!r}")
        if evict_policy not in ("lru", "refcount-aware"):
            # fail at construction, not asynchronously in a worker or the
            # reclaimer thread mid-run
            raise ValueError(f"evict_policy must be 'lru' or "
                             f"'refcount-aware', got {evict_policy!r}")
        if prefill_workers < 0 or prefill_chunk < 1:
            raise ValueError(
                f"need prefill_workers >= 0 and prefill_chunk >= 1, got "
                f"{prefill_workers}/{prefill_chunk}")
        n_actors = n_engines + prefill_workers
        if pool is None:
            from repro_torch.runtime.reclaim import make_policy
            # one engine slot per decode worker AND per prefill worker
            # (prefill readers join the ping fan-out as first-class slots)
            # + one for the dedicated reclaimer; sim_backend/sim_costs
            # select the simulator backend and the (possibly per-engine
            # asymmetric) cost model when ``smr`` names a simulated scheme
            # -- the native pool policy ignores them
            pool = BlockPool(num_pages, n_engines=n_actors + 1,
                             reclaim_threshold=16,
                             policy=make_policy(smr, backend=sim_backend,
                                                costs=sim_costs))
        elif sim_backend != "gen" or sim_costs is not None:
            # a caller-supplied pool carries its own policy: the sim knobs
            # would be dead letters, so refuse rather than mismeasure
            raise ValueError(
                "sim_backend/sim_costs only apply when ServeEngine builds "
                "the pool; configure them on the supplied pool's policy "
                "instead")
        if pool.n_engines < n_actors:
            raise ValueError(
                f"pool has {pool.n_engines} engine slots, need {n_actors} "
                f"({n_engines} decode + {prefill_workers} prefill)")
        self.pool = pool
        if trace is not None:
            pool.attach_tracer(trace)
        self.n_engines = n_engines
        # paged KV mode: ONE physical page store shared by every worker,
        # registered as a pool block listener so frees poison pages and
        # (re)allocations clear them -- under whichever SMR policy decides
        self.kv_store: Optional[PagedKVStore] = None
        if kv_store == "paged":
            from repro_torch.serve.paged_model import check_paged_support
            check_paged_support(cfg)
            self.kv_store = PagedKVStore(cfg, pool.num_blocks, page_size,
                                         storage=kv_storage,
                                         device=self.device)
            pool.add_block_listener(self.kv_store)

        # the dense path's decode, shared by every worker: it writes the
        # request's own cache in place, so workers never share a tensor
        def decode(p, c, t):
            return apply_model(p, t, cfg=cfg, mode="decode", cache=c)

        self._decode = decode
        # desched-stall fault injection (the load harness's "frequently
        # delayed threads" cell): afflicted decode workers sleep stall_s
        # every stall_every-th step MID-step, reader session held.  Default
        # victim set when enabled: worker 0 only, so the fleet contrast is
        # one delayed reader vs N-1 healthy ones.
        if stall_every and stall_workers is None:
            stall_workers = (0,)
        stall_set = set(stall_workers or ())
        self.workers: List[EngineWorker] = [
            EngineWorker(i, cfg, params, pool, self._decode,
                         max_batch=max_batch, page_size=page_size,
                         max_seq=max_seq, prefix_cache=prefix_cache,
                         kv_store=self.kv_store, kernel_impl=kernel_impl,
                         device=self.device,
                         evict_policy=evict_policy,
                         prefill_chunk=prefill_chunk,
                         tracer=trace, metrics=self.metrics,
                         stall_every=stall_every if i in stall_set else 0,
                         stall_s=stall_s if i in stall_set else 0.0)
            for i in range(n_engines)]
        # prefill workers take the engine ids right after the decode fleet
        self.prefill_workers: List[PrefillWorker] = [
            PrefillWorker(n_engines + j, cfg, params, pool, self._decode,
                          page_size=page_size, max_seq=max_seq,
                          prefix_cache=prefix_cache, kv_store=self.kv_store,
                          kernel_impl=kernel_impl, device=self.device,
                          evict_policy=evict_policy,
                          prefill_chunk=prefill_chunk,
                          tracer=trace, metrics=self.metrics)
            for j in range(prefill_workers)]
        # dedicated reclaimer only if the pool has a spare engine slot;
        # otherwise workers reclaim on pressure (pre-split behavior)
        self.reclaimer: Optional[Reclaimer] = None
        if pool.n_engines > n_actors:
            self.reclaimer = Reclaimer(pool, engine_id=n_actors,
                                       interval_s=reclaim_interval_s,
                                       evict_policy=evict_policy)
        self.scheduler = Scheduler(self.workers, self.reclaimer,
                                   prefill_workers=self.prefill_workers,
                                   tracer=trace, metrics=self.metrics,
                                   pool=pool, sched_policy=sched_policy,
                                   preempt=preempt_prefill,
                                   preempt_margin=preempt_margin,
                                   place_policy=place_policy,
                                   migrate=migrate,
                                   migrate_interval_s=migrate_interval_s,
                                   migrate_threshold=migrate_threshold)

    # -- client API (unchanged from the monolithic engine) --

    def submit(self, prompt: Sequence[int], max_new: int = 16,
               deadline_s: Optional[float] = None) -> Request:
        return self.scheduler.submit(prompt, max_new, deadline_s=deadline_s)

    def start(self) -> None:
        self.scheduler.start()

    def stop(self) -> None:
        self.scheduler.stop()

    @property
    def steps(self) -> int:
        return self.scheduler.steps

    @property
    def error(self) -> Optional[BaseException]:
        return self.scheduler.error

    def snapshot(self) -> dict:
        """One observability snapshot: the engine-level latency histograms
        (TTFT, per-token latency, queue waits), the pool-level SMR
        histograms (ping stall, reclaim-pass duration), and the pool's
        scalar counters.  Safe to call mid-serve -- histograms merge their
        thread-local shards on read, the publish-on-flush analogue."""
        from dataclasses import asdict

        return {
            "metrics": self.metrics.snapshot(),
            "pool_metrics": self.pool.metrics.snapshot(),
            "pool": asdict(self.pool.stats),
        }

    def latency_summary(self, fields=("p50", "p99", "p999", "max")) -> dict:
        """Flat benchmark-row shape (``ttft_p99_s`` style) combining the
        engine and pool registries."""
        out = self.metrics.flat(fields=fields)
        out.update(self.pool.metrics.flat(fields=fields))
        return out

    @property
    def injected_stalls(self) -> int:
        """Desched stalls injected so far across the decode fleet."""
        return sum(w.injected_stalls for w in self.workers)

    @property
    def prefill_tokens(self) -> int:
        """Prompt tokens prefilled across the whole pipeline (dedicated
        prefill workers + any inline remainder the decode workers ran)."""
        actors = self.workers + self.prefill_workers
        return sum(a.prefill_tokens for a in actors)

    def kv_copy_stats(self) -> dict:
        """Aggregate bytes-copied-per-request accounting across all pool
        actors (decode workers and prefill workers): how many KV bytes
        admission installed into per-request storage, split by prefix-cache
        outcome.  The paged path's headline number is ``bytes_per_hit`` ~ 0
        (shared pages enter the block table, nothing is copied); the dense
        path pays a full cache per request."""
        actors = self.workers + self.prefill_workers
        hit_b = sum(w.kv_bytes_copied_hit for w in actors)
        miss_b = sum(w.kv_bytes_copied_miss for w in actors)
        hits = sum(w.admitted_hit for w in actors)
        misses = sum(w.admitted_miss for w in actors)
        st = self.kv_store
        return {
            "kv_store": "paged" if st is not None else "dense",
            "kv_storage": st.storage if st is not None else None,
            "admitted_hit": hits, "admitted_miss": misses,
            "bytes_hit": hit_b, "bytes_miss": miss_b,
            "bytes_per_hit": hit_b / max(hits, 1),
            "bytes_per_miss": miss_b / max(misses, 1),
            # host<->device KV traffic through the page store: the device-
            # residency headline (device storage: 0 h2d in steady-state
            # decode; host storage: O(pool * layers) per step)
            "bytes_h2d": st.bytes_h2d if st is not None else None,
            "bytes_d2h": st.bytes_d2h if st is not None else None,
            "bytes_h2d_per_step": (st.bytes_h2d / max(self.steps, 1)
                                   if st is not None else None),
        }
