"""The port's serving runtime on the CPU, the options no other test drives:

* the multi-engine litmus of ``tests/test_serve_multi_engine.py``: every
  registered scheme free of use-after-free with 2 and 4 engine threads
  churning shared prefixes under a reclaimer (a property of the port);
  the unsafe policy firing, on a recycled prefix block too, and prefix
  blocks held under every scheme's open session (scripted: the outcome
  equal to the reference pool's); request ids dense under 8 client
  threads;
* host storage at the engine level (``tests/test_kv_store.py``): tokens
  equal device storage's and the reference engine's, host->device bytes
  a step above 0 on host storage and 0 on device storage, a bad storage
  refused;
* a stalled reader (``stall_every`` / ``stall_s`` / ``stall_workers``)
  under EpochPOP-pool and a simulated scheme, ``evict_policy``
  ``refcount-aware`` against ``lru``, each with the reference's tokens;
* tracing (``tests/test_obs.py``): a pool's and an engine's trace pass
  ``validate_trace``, each ``pop_pass`` span with one ``publish`` child
  per other reader.
"""

import json
import random
import threading
import types
from dataclasses import asdict

import jax
import pytest

import repro.runtime.block_pool as j_pool
import repro.runtime.reclaim as j_reclaim
import repro_torch.runtime.block_pool as t_pool
import repro_torch.runtime.reclaim as t_reclaim
from repro.configs.base import ArchConfig as JArch
from repro.configs.base import dense_stack as j_stack
from repro.core.sim.engine import UseAfterFree as JUseAfterFree
from repro.models.model import init_params as j_init
from repro.serve.engine import ServeEngine as JEngine
from repro_torch.bridge import params_from_jax
from repro_torch.configs.base import ArchConfig, dense_stack
from repro_torch.core.sim.engine import UseAfterFree
from repro_torch.obs import Tracer
from repro_torch.obs.trace import validate_trace
from repro_torch.runtime.block_pool import BlockPool, OutOfBlocks
from repro_torch.runtime.reclaim import (SimulatedSMRPolicy, make_policy,
                                         supported_schemes)
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.worker import Reclaimer

SAFE_SCHEMES = supported_schemes()
PACKAGES = {
    "port": types.SimpleNamespace(
        BlockPool=t_pool.BlockPool, Sim=t_reclaim.SimulatedSMRPolicy,
        Unsafe=t_reclaim.UnsafeEagerPolicy, UseAfterFree=UseAfterFree),
    "reference": types.SimpleNamespace(
        BlockPool=j_pool.BlockPool, Sim=j_reclaim.SimulatedSMRPolicy,
        Unsafe=j_reclaim.UnsafeEagerPolicy, UseAfterFree=JUseAfterFree),
}
KW = dict(name="kv-plain", d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
          vocab=64, remat="none", dtype="float32")
JCFG = JArch(groups=j_stack(2), **KW)
CFG = ArchConfig(groups=dense_stack(2), **KW)
PAGE = 4
PROMPTS = [[1, 9, 3, 5, 2], [7, 2, 8, 6, 4, 1, 3, 5], [11],
           [5, 3, 9, 1, 2, 6, 4, 8, 7, 2, 9]]
SHARED = [5, 3, 9, 1, 2, 6, 4, 8]                  # two full pages
SHARED_PROMPTS = [SHARED + [i + 1] for i in range(6)] + [[7, 7, 1]]


@pytest.fixture(scope="module")
def weights():
    jp = j_init(JCFG, jax.random.PRNGKey(1))
    return jp, params_from_jax(jax.device_get(jp))


def _run(eng, prompts, max_new=3):
    eng.start()
    reqs = [eng.submit(p, max_new=max_new) for p in prompts]
    for r in reqs:
        assert r.done.wait(timeout=300)
    eng.stop()
    assert eng.error is None, f"engine failed: {eng.error!r}"
    return [list(r.out) for r in reqs]


@pytest.fixture(scope="module")
def ref_tokens(weights):
    """The reference engine's tokens for both prompt sets (dense KV, one
    engine: its own tests hold every layout to them)."""
    return {name: _run(JEngine(JCFG, weights[0], max_batch=4, page_size=PAGE,
                               num_pages=64, max_seq=32), prompts)
            for name, prompts in (("plain", PROMPTS),
                                  ("shared", SHARED_PROMPTS))}


def _engine(params, **kw):
    kw.setdefault("max_batch", 4)
    kw.setdefault("num_pages", 64)
    return ServeEngine(CFG, params, device="cpu", page_size=PAGE, max_seq=32,
                       kv_store="paged", **kw)


def _drain_and_check(eng):
    pool = eng.pool
    pool.evict_prefixes(0)
    for e in range(pool.n_engines):
        pool.start_step(e)
        pool.end_step(e)
    pool.policy.flush()
    assert eng.kv_store.poisons == pool.stats.freed
    assert pool.check_no_leaks()


# ----------------------------------------------------------------------------
# tests/test_serve_multi_engine.py
# ----------------------------------------------------------------------------


def churn_engines(pool, n_engines, *, steps=40, per_req=2, window=3,
                  n_keys=2):
    """The reference test's worker-protocol churn on real threads, with a
    reclaimer: (use-after-free count, other errors)."""
    uaf = [0]
    errors = []
    rec = Reclaimer(pool, engine_id=n_engines, interval_s=0.001)

    def engine(eid):
        rng = random.Random(eid)
        live = []
        try:
            for _ in range(steps):
                pool.start_step(eid)
                shared, extra = [], []
                key = ("px", rng.randrange(n_keys))
                hit = pool.acquire_prefix(eid, key)
                if hit is not None:
                    shared = hit[0]
                else:
                    try:
                        pfx = pool.allocate(eid, 1)
                    except OutOfBlocks:
                        pool.reclaim(eid)
                        pool.end_step(eid)
                        continue
                    if pool.share_prefix(eid, key, pfx):
                        shared = pfx
                    else:
                        extra = pfx
                try:
                    priv = pool.allocate(eid, per_req)
                except OutOfBlocks:
                    if shared:
                        pool.release_shared(eid, shared)
                    if extra:
                        pool.retire(eid, extra)
                    pool.evict_prefixes(eid)
                    pool.reclaim(eid)
                    pool.end_step(eid)
                    continue
                live.append((shared, extra + priv))
                session = [b for sh, pv in live for b in sh + pv]
                pk = ("px", rng.randrange(n_keys))
                entry = pool._prefix_cache.get(pk)
                if entry is not None:
                    pool.reserve(eid, entry[0])
                    if pool._prefix_cache.get(pk) is entry:
                        session = session + entry[0]
                pool.reserve(eid, session)
                pool.touch(eid, session)
                if len(live) > window:
                    sh, pv = live.pop(0)
                    pool.retire(eid, pv)
                    if sh:
                        pool.release_shared(eid, sh)
                pool.end_step(eid)
        except UseAfterFree as e:
            uaf[0] += 1
            errors.append(("uaf", str(e)))
        except Exception as e:  # noqa: BLE001
            errors.append(("err", f"{type(e).__name__}: {e}"))
        finally:
            for sh, pv in live:
                try:
                    pool.retire(eid, pv)
                    if sh:
                        pool.release_shared(eid, sh)
                except Exception:  # noqa: BLE001 -- teardown best effort
                    pass

    threads = [threading.Thread(target=engine, args=(i,))
               for i in range(n_engines)]
    rec.start()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    rec.stop()
    assert rec.error is None, f"reclaimer died: {rec.error}"
    return uaf[0], [e for kind, e in errors if kind == "err"]


@pytest.mark.parametrize("n_engines", [2, 4])
@pytest.mark.parametrize("scheme", SAFE_SCHEMES)
def test_registered_schemes_never_uaf_multi_engine(scheme, n_engines):
    pool = BlockPool(12 * n_engines, n_engines=n_engines + 1,
                     reclaim_threshold=4, pressure_factor=1,
                     policy=SimulatedSMRPolicy(scheme))
    uaf, errors = churn_engines(pool, n_engines, steps=40)
    assert uaf == 0, f"use-after-free under {scheme}"
    assert not errors, errors
    pool.evict_prefixes(0)
    pool.policy.flush()
    assert pool.check_no_leaks()


def test_native_epoch_pop_never_uaf_multi_engine():
    pool = BlockPool(24, n_engines=3, reclaim_threshold=4, pressure_factor=1,
                     ping_timeout_s=0.5, policy=make_policy(None))
    uaf, errors = churn_engines(pool, 2, steps=200)
    assert uaf == 0
    assert not errors, errors
    pool.evict_prefixes(0)
    pool.reclaim()
    assert pool.check_no_leaks()


def unsafe_fires(pk, recycle):
    pool = pk.BlockPool(4 if recycle else 16, n_engines=2,
                        reclaim_threshold=2 if recycle else 4,
                        policy=pk.Unsafe())
    shared = pool.allocate(0, 2)
    pool.share_prefix(0, "hot", shared)
    pool.start_step(1)
    pool.reserve(1, shared)
    pool.touch(1, shared)                # fine: cache + engine-0 refs live
    pool.release_shared(0, shared)
    pool.evict_prefixes(0)               # last ref -> retire -> EAGER free
    again = pool.allocate(0, 2) if recycle else []
    with pytest.raises(pk.UseAfterFree) as err:
        pool.touch(1, shared)
    return dict(again=again, what=str(err.value),
                stats={k: v for k, v in asdict(pool.stats).items()
                       if not k.endswith("_s")})


@pytest.mark.parametrize("recycle", [False, True])
def test_unsafe_policy_fires_multi_engine(recycle):
    """Engine 1's session spans a shared block whose last reference drops
    on engine 0: free-on-retire must trip, also once the block is
    recycled into a new request (the allocation generation) -- the same
    outcome as the reference pool's."""
    got = {name: unsafe_fires(pk, recycle) for name, pk in PACKAGES.items()}
    assert got["port"] == got["reference"]
    if recycle:
        assert set(got["port"]["again"]) & {0, 1, 2, 3}


def prefix_blocks_held(pk):
    out = {}
    for scheme in SAFE_SCHEMES:
        pool = pk.BlockPool(16, n_engines=2, reclaim_threshold=2,
                            pressure_factor=1, policy=pk.Sim(scheme))
        blocks = pool.allocate(0, 2)
        pool.share_prefix(0, "hot", blocks)
        pool.start_step(1)
        pool.reserve(1, blocks)
        pool.release_shared(0, blocks)
        pool.evict_prefixes(0)           # retire under engine 1's session
        pool.reclaim(0)
        held = all(b not in pool._freeset for b in blocks)
        pool.touch(1, blocks)            # must not raise
        pool.end_step(1)
        out[scheme] = (held, pool.stats.freed, pool.retired_blocks)
    return out


def test_prefix_blocks_never_recycled_under_any_engine_session():
    got = {name: prefix_blocks_held(pk) for name, pk in PACKAGES.items()}
    assert got["port"] == got["reference"]
    assert all(held for held, _, _ in got["port"].values())


def test_scheduler_rid_thread_safe_and_places_across_engines():
    eng = ServeEngine(CFG, params=None, device="cpu", n_engines=2,
                      num_pages=32, page_size=8, max_seq=64)
    rids = []
    lock = threading.Lock()

    def client():
        mine = [eng.submit([1, 2, 3]).rid for _ in range(50)]
        with lock:
            rids.extend(mine)

    threads = [threading.Thread(target=client) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert sorted(rids) == list(range(1, 401)), "request ids raced"
    sizes = [w.queue.qsize() for w in eng.workers]
    assert sum(sizes) == 400 and all(s > 0 for s in sizes), sizes


# ----------------------------------------------------------------------------
# host storage (tests/test_kv_store.py, engine level)
# ----------------------------------------------------------------------------


def test_host_storage_tokens_and_bytes(weights, ref_tokens):
    """Storage is a residency knob: host and device pages serve the
    reference's tokens; host storage uploads every layer every step,
    device storage moves nothing."""
    stats, outs = {}, {}
    for storage in ("host", "device"):
        eng = _engine(weights[1], kv_storage=storage)
        outs[storage] = _run(eng, PROMPTS)
        stats[storage] = eng.kv_copy_stats()
        _drain_and_check(eng)
    assert outs["host"] == outs["device"] == ref_tokens["plain"]
    assert stats["host"]["kv_storage"] == "host"
    assert stats["host"]["bytes_h2d_per_step"] > 0
    assert stats["device"]["bytes_h2d"] == 0
    assert stats["device"]["bytes_h2d_per_step"] == 0


def test_engine_rejects_bad_kv_storage(weights):
    with pytest.raises(ValueError, match="kv_storage"):
        _engine(weights[1], kv_storage="hbm")


# ----------------------------------------------------------------------------
# a stalled reader; the prefix cache's eviction policy
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("smr", ["EpochPOP-pool", "HazardPtrPOP"])
def test_stalled_reader_serves_safely(smr, weights, ref_tokens):
    """Decode worker 0 sleeps ``stall_s`` mid-step, its reader session
    open, every 2nd step: requests finish with the reference's tokens,
    no use-after-free, the pool leak-free, and the stalls counted."""
    eng = _engine(weights[1], smr=None if smr == "EpochPOP-pool" else smr,
                  n_engines=2, prefill_workers=1, prefix_cache=True,
                  num_pages=32, stall_every=2, stall_s=0.02,
                  stall_workers=[0])
    assert _run(eng, SHARED_PROMPTS) == ref_tokens["shared"]
    assert eng.injected_stalls > 0
    assert eng.workers[1].injected_stalls == 0
    _drain_and_check(eng)


@pytest.mark.parametrize("evict_policy", ["lru", "refcount-aware"])
def test_eviction_policy_keeps_tokens(evict_policy, weights, ref_tokens):
    eng = _engine(weights[1], n_engines=2, prefix_cache=True,
                  evict_policy=evict_policy, num_pages=24)
    assert _run(eng, SHARED_PROMPTS) == ref_tokens["shared"]
    assert eng.pool.stats.prefix_hits > 0
    _drain_and_check(eng)


def test_engine_rejects_unknown_eviction_policy(weights):
    with pytest.raises(ValueError, match="evict_policy"):
        _engine(weights[1], evict_policy="mru")


# ----------------------------------------------------------------------------
# tracing (tests/test_obs.py)
# ----------------------------------------------------------------------------


def _pop_pass_children(evs):
    """Every pop_pass span: its publish children (by pass id), all inside
    it, one per other reader."""
    passes = [e for e in evs if e["name"] == "pop_pass"]
    pubs = [e for e in evs if e["name"] == "publish"]
    acks = [e for e in evs if e["name"] == "pop_ack"]
    assert passes, "forced POP passes must appear in the trace"
    assert len(acks) == len(passes)
    for p in passes:
        kids = [e for e in pubs if e["args"]["pass"] == p["args"]["pass"]]
        assert len(kids) == p["args"]["readers"]
        for k in kids:
            assert k["ts"] >= p["ts"] - 1e-6
            assert k["ts"] + k["dur"] <= p["ts"] + p["dur"] + 1e-6
    return passes


def test_pop_pass_span_tree_one_child_per_reader():
    tr = Tracer()
    # the readers are quiescent and never reach a safepoint: each pass
    # waits out the ping timeout (10 s by default; 0.5 s here) for them
    pool = BlockPool(32, n_engines=3, reclaim_threshold=2, pressure_factor=1,
                     ping_timeout_s=0.5,
                     policy=make_policy(None, pop_every=1), tracer=tr)
    for eid in (1, 2):
        pool.start_step(eid)
        pool.end_step(eid)
    for _ in range(3):
        pool.start_step(0)
        b = pool.allocate(0, 4)
        pool.retire(0, b)
        pool.end_step(0)
        pool.reclaim(0)
    evs = validate_trace(tr.to_dict())
    passes = _pop_pass_children(evs)
    assert all(p["args"]["readers"] == 2 for p in passes)
    assert any(e["name"] == "block_alloc" for e in evs)
    assert any(e["name"] == "block_free" for e in evs)
    assert pool.check_no_leaks()


def test_engine_trace_validates(weights, ref_tokens, tmp_path):
    """An engine run with ``trace=Tracer()`` (2 decode engines, 1 prefill
    worker, the native pool forced to publish-on-ping every pass): the
    export validates, every pop_pass has one publish child per other
    reader, and the request spans are there."""
    tr = Tracer()
    pool = BlockPool(32, n_engines=4, reclaim_threshold=2, pressure_factor=1,
                     ping_timeout_s=0.5,
                     policy=make_policy(None, pop_every=1))
    eng = ServeEngine(CFG, weights[1], device="cpu", page_size=PAGE,
                      max_seq=32, kv_store="paged", max_batch=4, pool=pool,
                      n_engines=2, prefill_workers=1, prefix_cache=True,
                      trace=tr)
    assert _run(eng, SHARED_PROMPTS) == ref_tokens["shared"]
    obj = tr.export(str(tmp_path / "serve.json"))
    evs = validate_trace(obj)
    passes = _pop_pass_children(evs)
    assert all(p["args"]["readers"] == pool.n_engines - 1 for p in passes)
    names = {e["name"] for e in evs}
    assert {"prefill_chunk", "block_alloc"} <= names
    with open(tmp_path / "serve.json") as f:
        assert len(validate_trace(json.load(f))) == len(evs)
    _drain_and_check(eng)
