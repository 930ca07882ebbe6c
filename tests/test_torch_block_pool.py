"""The port's BlockPool and prefix cache, the twins of
``tests/test_block_pool.py`` and ``tests/test_prefix_cache.py``.

The scenarios are host code.  Each single-threaded one runs on the
port's pool and on the reference's with one script, asserts the
reference test's properties of both, and holds the port's counters
(``PoolStats``; wall-clock fields left out), free set and outcome equal
to the reference's outright (a simulated scheme's per-thread ``Stats``
and clocks too).  The threaded ones (a stalled engine that
forces publish-on-ping with bounded garbage, two engines churning under
a reclaimer) are asserted as properties of the port.
"""

import threading
import time
import types
from dataclasses import asdict

import pytest

import repro.core.sim.engine as j_sim
import repro.runtime.block_pool as j_pool
import repro.runtime.reclaim as j_reclaim
import repro_torch.core.sim.engine as t_sim
import repro_torch.runtime.block_pool as t_pool
import repro_torch.runtime.reclaim as t_reclaim
from repro_torch.runtime.block_pool import BlockPool, OutOfBlocks

PACKAGES = {
    "port": types.SimpleNamespace(
        BlockPool=t_pool.BlockPool, Sim=t_reclaim.SimulatedSMRPolicy,
        Unsafe=t_reclaim.UnsafeEagerPolicy, UseAfterFree=t_sim.UseAfterFree),
    "reference": types.SimpleNamespace(
        BlockPool=j_pool.BlockPool, Sim=j_reclaim.SimulatedSMRPolicy,
        Unsafe=j_reclaim.UnsafeEagerPolicy, UseAfterFree=j_sim.UseAfterFree),
}


def _outcome(pool, **extra):
    stats = {k: v for k, v in asdict(pool.stats).items()
             if not k.endswith("_s")}
    sim = getattr(pool.policy, "sim", None)
    if sim is not None:
        stats["sim"] = [(asdict(t.stats), t.clock) for t in sim.threads]
    with pool._lock:
        free = sorted(pool._freeset)
    return dict(stats=stats, free=free, live=[sorted(s) for s in
                                              pool._live_local],
                retired=pool.retired_blocks, **extra)


def _both(scenario):
    """Run ``scenario(pk)`` on both packages' pools: equal outcomes."""
    got = {name: scenario(pk) for name, pk in PACKAGES.items()}
    assert got["port"] == got["reference"]
    return got["port"]


# ----------------------------------------------------------------------------
# tests/test_block_pool.py
# ----------------------------------------------------------------------------


def epoch_fast_path(pk):
    pool = pk.BlockPool(64, n_engines=2, reclaim_threshold=8)
    for _ in range(20):
        pool.start_step(0)
        blocks = pool.allocate(0, 4)
        pool.end_step(0)
        pool.start_step(1)
        pool.end_step(1)
        pool.retire(0, blocks)
    pool.reclaim()
    assert pool.stats.pings == 0, "quiescent engines must never be pinged"
    assert pool.stats.freed > 0
    assert pool.free_blocks + pool.retired_blocks == 64
    assert pool.check_no_leaks()
    return _outcome(pool)


def test_epoch_fast_path_no_pings():
    _both(epoch_fast_path)


def test_stalled_engine_triggers_pop_and_bounded_garbage():
    """Engine 1 stalls mid-step holding 4 blocks but keeps reaching
    safepoints: engine 0's churn forces publish-on-ping passes, the
    garbage stays within two threshold batches, the held blocks are never
    freed."""
    pool = BlockPool(256, n_engines=2, reclaim_threshold=8,
                     pressure_factor=2)
    pool.start_step(1)
    held = pool.allocate(1, 4)
    stop = threading.Event()

    def stalled():
        while not stop.is_set():
            pool.safepoint(1)
            time.sleep(0.001)

    t = threading.Thread(target=stalled, daemon=True)
    t.start()
    for _ in range(40):
        pool.start_step(0)
        b = pool.allocate(0, 4)
        pool.retire(0, b)
        pool.end_step(0)
    stop.set()
    t.join()
    assert pool.stats.pings > 0, "stall should force publish-on-ping"
    assert pool.stats.pop_reclaims > 0
    assert pool.retired_blocks <= 2 * pool.reclaim_threshold
    assert all(b not in pool._free for b in held)
    assert pool.check_no_leaks()


def test_pop_never_frees_published_live_blocks_concurrent():
    pool = BlockPool(128, n_engines=2, reclaim_threshold=4, pressure_factor=1)
    errors = []
    stop = threading.Event()

    def engine(eid):
        held = {}
        n = 0
        while not stop.is_set():
            pool.start_step(eid)
            try:
                b = pool.allocate(eid, 2)
            except OutOfBlocks:
                pool.reclaim()
                pool.end_step(eid)
                continue
            held[n] = b
            if set(b) & pool._live_local[1 - eid]:
                errors.append(f"double allocation {b}")
            if n >= 3:
                pool.retire(eid, held.pop(n - 3))
            n += 1
            pool.end_step(eid)
        for b in held.values():
            pool.retire(eid, b)

    ts = [threading.Thread(target=engine, args=(i,)) for i in range(2)]
    for t in ts:
        t.start()
    time.sleep(1.0)
    stop.set()
    for t in ts:
        t.join(timeout=10)
    pool.reclaim()
    assert not errors, errors
    assert pool.check_no_leaks()
    assert pool.stats.freed > 50


def dead_engine(pk):
    pool = pk.BlockPool(32, n_engines=2, reclaim_threshold=2,
                        pressure_factor=1, ping_timeout_s=0.2)
    pool.start_step(1)            # engine 1 announces then dies
    dead_held = pool.allocate(1, 2)
    for _ in range(4):
        pool.retire(0, pool.allocate(0, 2))
    assert pool.reclaim() == 0    # the ping times out: nothing freed
    assert all(b not in pool._free for b in dead_held)
    return _outcome(pool)


def test_dead_engine_keeps_pool_safe():
    _both(dead_engine)


def crash_unpins(pk):
    pool = pk.BlockPool(32, n_engines=2, reclaim_threshold=2,
                        pressure_factor=1, ping_timeout_s=0.2)
    pool.start_step(1)
    pool.allocate(1, 4)
    for _ in range(4):
        pool.retire(0, pool.allocate(0, 2))
    assert pool.reclaim() == 0    # undetected crash: everything pinned
    t0 = time.monotonic()
    assert pool.crash_engine(1) == 4
    pool.reclaim(0)
    assert time.monotonic() - t0 < 0.2, \
        "reclaim must not wait out the ping timeout on a known-dead engine"
    assert pool.free_blocks == 32
    assert pool.crash_engine(1) == 0    # idempotent
    assert pool.check_no_leaks()
    return _outcome(pool)


def test_crash_engine_unpins_epoch_and_recovers_blocks():
    _both(crash_unpins)


# ----------------------------------------------------------------------------
# tests/test_prefix_cache.py
# ----------------------------------------------------------------------------


def _pool(pk, **kw):
    kw.setdefault("n_engines", 3)
    kw.setdefault("reclaim_threshold", 4)
    return pk.BlockPool(32, **kw)


def share_acquire_release(pk):
    pool = _pool(pk)
    blocks = pool.allocate(0, 2)
    assert pool.share_prefix(0, "p", blocks, payload="snap")
    assert pool.shared_blocks == 2 and pool.prefix_entries == 1
    got, payload = pool.acquire_prefix(1, "p")
    assert got == blocks and payload == "snap"
    assert set(blocks) <= pool._live_local[1]
    pool.release_shared(0, blocks)
    pool.release_shared(1, blocks)
    assert pool.retired_blocks == 0 and pool.shared_blocks == 2
    assert pool.check_no_leaks()
    pool.evict_prefixes(0)
    assert pool.prefix_entries == 0 and pool.shared_blocks == 0
    assert pool.retired_blocks == 2
    pool.reclaim()
    assert pool.stats.freed == 2 and pool.check_no_leaks()
    return _outcome(pool)


def duplicate_share(pk):
    pool = _pool(pk)
    a = pool.allocate(0, 1)
    b = pool.allocate(1, 1)
    assert pool.share_prefix(0, "k", a)
    assert not pool.share_prefix(1, "k", b)
    assert b[0] in pool._live_local[1] and b[0] not in pool._shared_ref
    return _outcome(pool)


def acquire_miss(pk):
    pool = _pool(pk)
    assert pool.acquire_prefix(0, "nope") is None
    assert pool.stats.prefix_misses == 1 and pool.stats.prefix_hits == 0
    return _outcome(pool)


def same_engine_two_requests(pk):
    pool = _pool(pk)
    blocks = pool.allocate(0, 1)
    pool.share_prefix(0, "p", blocks)
    pool.release_shared(0, blocks)
    pool.acquire_prefix(0, "p")
    pool.acquire_prefix(0, "p")
    pool.release_shared(0, blocks)
    assert blocks[0] in pool._live_local[0], "second request still holds it"
    pool.release_shared(0, blocks)
    assert blocks[0] not in pool._live_local[0]
    assert pool.shared_blocks == 1 and pool.check_no_leaks()
    return _outcome(pool)


def lru_order(pk):
    pool = _pool(pk)
    for i in range(3):
        pool.share_prefix(0, f"k{i}", pool.allocate(0, 1))
        pool.release_shared(0, pool._prefix_cache[f"k{i}"][0])
    hit = pool.acquire_prefix(0, "k0")        # k0 -> MRU
    pool.release_shared(0, hit[0])
    assert pool.evict_prefixes(0, max_entries=2) == 2
    assert pool.prefix_entries == 1 and "k0" in pool._prefix_cache
    return _outcome(pool, keys=sorted(pool._prefix_cache))


def overlapping_entries(pk):
    pool = _pool(pk)
    short = pool.allocate(0, 1)
    pool.share_prefix(0, "ab", short)
    ext = pool.allocate(0, 1)
    pool.share_prefix(0, "abc", short + ext)
    pool.release_shared(0, short + ext)
    assert pool.evict_prefixes(0, max_entries=1) == 1      # evicts "ab"
    assert short[0] in pool._shared_ref and pool.retired_blocks == 0
    pool.evict_prefixes(0)
    assert pool.retired_blocks == 2 and pool.check_no_leaks()
    return _outcome(pool)


def double_release(pk):
    pool = _pool(pk)
    blocks = pool.allocate(0, 2)
    pool.share_prefix(0, "p", blocks)
    pool.release_shared(0, blocks)
    pool.evict_prefixes(0)
    assert pool.release_shared(0, blocks) == 0
    assert pool.release_shared(1, [99]) == 0
    pool.reclaim()
    again = pool.allocate(1, pool.num_blocks)
    assert len(set(again)) == pool.num_blocks
    pool.retire(1, again)
    assert pool.check_no_leaks()
    return _outcome(pool, again=again)


def release_without_entry(pk):
    pool = _pool(pk)
    blocks = pool.allocate(0, 2)
    pool.share_prefix(0, "p", blocks)
    pool.acquire_prefix(1, "p")
    pool.evict_prefixes(0)
    assert pool.retired_blocks == 0
    pool.release_shared(0, blocks)
    assert pool.retired_blocks == 0
    assert pool.release_shared(1, blocks) == 2
    assert pool.retired_blocks == 2 and pool.check_no_leaks()
    return _outcome(pool)


def session_protects_shared(pk):
    pool = _pool(pk, policy=pk.Sim("HazardPtrPOP"))
    blocks = pool.allocate(0, 2)
    pool.share_prefix(0, "p", blocks)
    pool.start_step(1)
    pool.reserve(1, blocks)
    pool.touch(1, blocks)
    pool.release_shared(0, blocks)
    pool.evict_prefixes(0)
    assert all(b not in pool._freeset for b in blocks)
    pool.touch(1, blocks)                     # still protected
    pool.end_step(1)
    pool.start_step(0)
    pool.end_step(0)
    pool.reclaim()
    assert pool.stats.freed >= 2 and pool.check_no_leaks()
    safe = _outcome(pool)

    pool = _pool(pk, policy=pk.Unsafe())
    blocks = pool.allocate(0, 2)
    pool.share_prefix(0, "p", blocks)
    pool.start_step(1)
    pool.reserve(1, blocks)
    pool.touch(1, blocks)
    pool.release_shared(0, blocks)
    pool.evict_prefixes(0)                    # eager free under the session
    with pytest.raises(pk.UseAfterFree):
        pool.touch(1, blocks)
    return dict(safe=safe, unsafe=_outcome(pool))


def refcount_aware(pk):
    pool = _pool(pk)
    a = pool.allocate(0, 2)
    b = pool.allocate(0, 2)
    pool.share_prefix(0, "hot", a)
    pool.share_prefix(0, "cold", b)
    pool.release_shared(0, a + b)
    pool.acquire_prefix(1, "hot")
    assert pool.evict_prefixes(0, policy="refcount-aware") == 1
    assert pool.prefix_entries == 1
    assert pool.acquire_prefix(2, "hot") is not None
    pool.release_shared(2, a)
    pool.release_shared(1, a)
    assert pool.evict_prefixes(0, policy="refcount-aware") == 1
    assert pool.prefix_entries == 0
    pool.reclaim()
    assert pool.check_no_leaks()
    return _outcome(pool)


def lru_ignores_readers(pk):
    pool = _pool(pk)
    a = pool.allocate(0, 2)
    pool.share_prefix(0, "hot", a)
    pool.acquire_prefix(1, "hot")
    assert pool.evict_prefixes(0, policy="lru") == 1
    assert pool.prefix_entries == 0 and pool.retired_blocks == 0
    pool.release_shared(0, a)
    pool.release_shared(1, a)
    pool.reclaim()
    assert pool.check_no_leaks()
    return _outcome(pool)


def unknown_eviction_policy(pk):
    pool = _pool(pk)
    with pytest.raises(ValueError, match="eviction policy") as err:
        pool.evict_prefixes(0, policy="mru")
    return dict(message=str(err.value))


@pytest.mark.parametrize("scenario", [
    share_acquire_release, duplicate_share, acquire_miss,
    same_engine_two_requests, lru_order, overlapping_entries, double_release,
    release_without_entry, session_protects_shared, refcount_aware,
    lru_ignores_readers, unknown_eviction_policy],
    ids=lambda f: f.__name__)
def test_prefix_cache_matches_reference(scenario):
    _both(scenario)
