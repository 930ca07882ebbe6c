"""Serving example on the PyTorch/CUDA port, the twin of
``serve_paged.py``: batched requests through the sharded continuous-batching
runtime (scheduler -> N engine workers -> reclaimer) whose KV blocks are
reclaimed by a pluggable SMR policy (the paper's techniques as the framework
feature).  The same flags, defaults, ``serve-demo`` config and output lines;
``--device`` picks where it runs (CUDA unless ``--device cpu``).

    PYTHONPATH=src python examples/serve_paged_torch.py                  # EpochPOP pool
    PYTHONPATH=src python examples/serve_paged_torch.py --engines 2      # sharded runtime
    PYTHONPATH=src python examples/serve_paged_torch.py --kv-store paged --prefix-cache
    PYTHONPATH=src python examples/serve_paged_torch.py --smr HazardPtrPOP --sim-backend vec
    PYTHONPATH=src python examples/serve_paged_torch.py --kv-store paged \
        --prefill-workers 2 --prefill-chunk 16   # async chunked prefill stage
    PYTHONPATH=src python examples/serve_paged_torch.py --engines 2 \
        --trace /tmp/serve.json --metrics        # Perfetto trace + histograms
    PYTHONPATH=src python examples/serve_paged_torch.py --prefill-workers 2 \
        --sched-policy sjf --preempt-prefill     # SJF + chunk preemption
    PYTHONPATH=src python examples/serve_paged_torch.py --engines 4 \
        --place-policy static --migrate          # migration rescues skew
    PYTHONPATH=src python examples/serve_paged_torch.py --device cpu ...

``--kv-store paged`` stores K/V physically in the POP-managed block pool
(runtime/kv_store.py) and decodes through the CUDA paged-attention kernel
(its plain PyTorch version with ``--device cpu``); a prefix-cache hit then
installs NO copies -- the shared pages enter the request's block table
directly.  ``--kv-storage`` picks where those pages live: ``device``
(default -- resident tensors updated in place by the scatter kernel, zero
host->device KV bytes per steady-state decode step) or ``host`` (host
tensors re-uploaded per layer per step; the ``bytes_h2d`` line below shows
the difference).

``--prefill-workers N`` splits prefill out of the decode loop into N
dedicated threads (each a first-class SMR reader slot) running chunked
prefill -- one batched forward per ``--prefill-chunk`` tokens with a pool
safepoint between chunks, so a reclaimer ping landing mid-prefill is
serviced within one chunk instead of one prompt.
"""

import argparse
import time

import torch

from repro_torch.configs.base import ArchConfig, dense_stack
from repro_torch.models.model import init_params
from repro_torch.obs import Tracer
from repro_torch.runtime.block_pool import BlockPool
from repro_torch.runtime.reclaim import make_policy, supported_schemes
from repro_torch.serve.engine import ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--smr", default=None, metavar="SCHEME",
                    help="SMR scheme guarding the block pool: "
                         "'EpochPOP-pool' (native, default) or any of "
                         + ", ".join(supported_schemes()))
    ap.add_argument("--engines", type=int, default=1,
                    help="number of engine worker threads (each its own "
                         "SMR reader; +1 pool slot for the reclaimer)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="share page-aligned prompt prefixes across "
                         "requests/engines (blocks retire through SMR)")
    ap.add_argument("--sim-backend", default="gen", choices=("gen", "vec"),
                    help="simulator backend for --smr schemes: 'gen' "
                         "(discrete-event reference) or 'vec' (batch-stepped "
                         "numpy arrays, ~5-10x faster)")
    ap.add_argument("--kv-store", default="dense", choices=("dense", "paged"),
                    help="KV storage: 'dense' (one private cache per "
                         "request) or 'paged' (physical pages in the "
                         "SMR-managed pool, paged-attention kernel decode)")
    ap.add_argument("--kv-storage", default="device",
                    choices=("host", "device"),
                    help="where the paged pages physically live: 'device' "
                         "(resident tensors, in-place scatter kernel) "
                         "or 'host' (host tensors, O(pool) re-upload per "
                         "decode step)")
    ap.add_argument("--prefill-workers", type=int, default=0, metavar="N",
                    help="dedicated async-prefill threads (0 = prefill runs "
                         "inline in the decode loop, still chunked)")
    ap.add_argument("--prefill-chunk", type=int, default=16, metavar="C",
                    help="prompt tokens per prefill forward; a pool "
                         "safepoint between chunks bounds the ping-delivery "
                         "window during misses")
    ap.add_argument("--sched-policy", default="fifo",
                    choices=("fifo", "sjf", "deadline"),
                    help="prefill-queue ordering: 'fifo' (arrival order), "
                         "'sjf' (shortest remaining prompt first), or "
                         "'deadline' (earliest deadline first, best-effort "
                         "last)")
    ap.add_argument("--preempt-prefill", action="store_true",
                    help="let long prefills yield to shorter queued work at "
                         "chunk boundaries (the same safepoint cadence that "
                         "bounds the ping window); requires "
                         "--prefill-workers >= 1")
    ap.add_argument("--place-policy", default="least-loaded",
                    choices=("least-loaded", "static"),
                    help="decode placement: 'least-loaded' (default) or "
                         "'static' rid-hash (skew-prone; pair with "
                         "--migrate to watch the monitor rescue it)")
    ap.add_argument("--migrate", action="store_true",
                    help="start the migration monitor: queued requests move "
                         "off the hottest engine onto the coolest, their KV "
                         "blocks re-homed across engine ids via "
                         "BlockPool.adopt (atomic vs publish-on-ping passes)")
    ap.add_argument("--migrate-threshold", type=int, default=4, metavar="N",
                    help="minimum hot-cool load spread (queued+running) "
                         "before the monitor moves requests")
    ap.add_argument("--requests", type=int, default=10)
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="write a Chrome-trace/Perfetto JSON of the run: "
                         "request lifecycle spans (queue wait, prefill "
                         "chunks, decode steps, retire) plus SMR ping->"
                         "publish->ack trees and block alloc/free instants; "
                         "open in ui.perfetto.dev")
    ap.add_argument("--metrics", action="store_true",
                    help="print the latency/stall histogram summary "
                         "(TTFT, per-token, queue wait, ping stall)")
    ap.add_argument("--device", default="cuda",
                    help="where the model and kernels run ('cuda' or 'cpu')")
    args = ap.parse_args(argv)

    cfg = ArchConfig(name="serve-demo", d_model=64, n_heads=4, n_kv_heads=2,
                     d_ff=128, vocab=128, groups=dense_stack(2), remat="none",
                     dtype="float32")
    params = init_params(cfg, torch.Generator(device=args.device)
                         .manual_seed(0), device=args.device)
    # when tracing the native pool policy, force a publish-on-ping pass
    # every few reclaims: a short demo run rarely builds real pressure, and
    # a trace without ping->publish->ack trees would show nothing of the
    # paper's mechanism.  Simulated schemes ping on their own cadence.
    policy_kw = {}
    if args.trace and args.smr in (None, "EpochPOP-pool"):
        policy_kw["pop_every"] = 2
    tracer = Tracer() if args.trace else None
    pool = BlockPool(128, n_engines=args.engines + args.prefill_workers + 1,
                     reclaim_threshold=8, pressure_factor=2,
                     policy=make_policy(args.smr, backend=args.sim_backend,
                                        **policy_kw))
    eng = ServeEngine(cfg, params, max_batch=4, page_size=8, max_seq=64,
                      pool=pool, n_engines=args.engines,
                      prefix_cache=args.prefix_cache,
                      kv_store=args.kv_store, kv_storage=args.kv_storage,
                      prefill_workers=args.prefill_workers,
                      prefill_chunk=args.prefill_chunk,
                      sched_policy=args.sched_policy,
                      preempt_prefill=args.preempt_prefill,
                      place_policy=args.place_policy,
                      migrate=args.migrate,
                      migrate_threshold=args.migrate_threshold,
                      trace=tracer, device=args.device)
    eng.start()
    t0 = time.time()
    # a hot shared prefix (page-aligned when --prefix-cache) + a unique tail
    prefix = [1, 9, 42, 7, 3, 5, 2, 8]
    reqs = [eng.submit(prefix + [1 + i % 16], max_new=8)
            for i in range(args.requests)]
    for i, r in enumerate(reqs):
        r.done.wait(timeout=300)
        print(f"req {i}: prompt={r.prompt} -> {r.out}")
    eng.stop()
    pool.evict_prefixes(0)
    pool.policy.flush()
    s = pool.stats
    print(f"\n{len(reqs)} requests in {time.time()-t0:.1f}s | "
          f"engines={args.engines} policy={pool.policy.name} | pool: "
          f"allocated={s.allocated} freed={s.freed} "
          f"retired_peak={s.retired_peak} "
          f"epoch_reclaims={s.epoch_reclaims} pings={s.pings} "
          f"pop_reclaims={s.pop_reclaims} touches={s.touches}")
    if args.prefill_workers:
        print(f"prefill stage: workers={args.prefill_workers} "
              f"chunk={args.prefill_chunk} "
              f"prefilled={sum(pw.requests for pw in eng.prefill_workers)} "
              f"tokens={eng.prefill_tokens} "
              f"max_ping_stall={s.max_ping_stall_s*1e3:.1f}ms")
    sched = eng.scheduler
    if (args.sched_policy != "fifo" or args.preempt_prefill or args.migrate
            or args.place_policy != "least-loaded"):
        print(f"scheduler: policy={args.sched_policy} "
              f"place={args.place_policy} "
              f"reorders={sched.queue_reorders} "
              f"preemptions={sched.preemptions} "
              f"migrations={sched.migrations} "
              f"adopts={s.adopts} stale_handoffs={s.stale_handoffs}")
    if args.prefix_cache:
        actors = eng.workers + eng.prefill_workers
        print(f"prefix cache: hits={s.prefix_hits} misses={s.prefix_misses} "
              f"blocks_saved={s.blocks_saved} evictions={s.prefix_evictions} "
              f"prefill_tokens_skipped="
              f"{sum(w.prefill_tokens_skipped for w in actors)}")
    kv = eng.kv_copy_stats()
    print(f"kv_store={kv['kv_store']}: "
          f"bytes-copied/request hit={kv['bytes_per_hit']:.0f} "
          f"miss={kv['bytes_per_miss']:.0f}"
          + (f" | physical pool={eng.kv_store.nbytes} B (constant), "
             f"pages poisoned={eng.kv_store.poisons}"
             if eng.kv_store is not None else ""))
    if kv["kv_storage"] is not None:
        print(f"kv_storage={kv['kv_storage']}: "
              f"bytes_h2d={kv['bytes_h2d']} "
              f"({kv['bytes_h2d_per_step']:.0f}/step) "
              f"bytes_d2h={kv['bytes_d2h']}")
    if args.metrics:
        print("\nlatency/stall histograms (merged on read):")
        for name, snap in {**eng.snapshot()["metrics"],
                           **eng.snapshot()["pool_metrics"]}.items():
            if snap["count"]:
                print(f"  {name:22s} n={snap['count']:5d} "
                      f"p50={snap['p50']*1e3:8.2f}ms "
                      f"p99={snap['p99']*1e3:8.2f}ms "
                      f"max={snap['max']*1e3:8.2f}ms")
    if tracer is not None:
        obj = tracer.export(args.trace)
        spans = sum(1 for e in obj["traceEvents"]
                    if e.get("name") == "pop_pass")
        print(f"trace: {len(obj['traceEvents'])} events "
              f"({spans} publish-on-ping passes) -> {args.trace} "
              f"(open in ui.perfetto.dev)")
    if eng.error is not None:
        raise SystemExit(f"ENGINE FAILED: {type(eng.error).__name__}: {eng.error}")
    print("use-after-free: none (hard error if one had occurred)")
    print(f"no leaks: {pool.check_no_leaks()}")


if __name__ == "__main__":
    main()
