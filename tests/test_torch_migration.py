"""Migration litmus on the port's pool, the twin of
``tests/test_migration_litmus.py``: ``BlockPool.adopt`` racing
reclamation on every registered SMR scheme and both simulator backends.

The scripted single-threaded scenarios (migrate-then-retire under an open
reader session; adopt before and after the source's crash) run on the
port's pool and on the reference's with the same script: the pools'
counters (``PoolStats``), every simulated thread's ``Stats`` and clock,
the free sets and the use-after-free outcome must be equal.  The threaded ones -- adopt while a native POP pass is
mid-publish, stale shared references, the serving smoke with static
placement, migration and a stalled engine -- are asserted as properties
of the port, and the smoke's tokens equal the reference engine's from the
same bridged weights.
"""

import threading
import types
from dataclasses import asdict

import jax
import pytest

import repro.core.sim.engine as j_sim
import repro.runtime.block_pool as j_pool
import repro.runtime.reclaim as j_reclaim
import repro_torch.core.sim.engine as t_sim
import repro_torch.runtime.block_pool as t_pool
import repro_torch.runtime.reclaim as t_reclaim
from repro.configs.base import ArchConfig as JArch
from repro.configs.base import dense_stack as j_stack
from repro.models.model import init_params as j_init
from repro.serve.engine import ServeEngine as JEngine
from repro_torch.bridge import params_from_jax
from repro_torch.configs.base import ArchConfig, dense_stack
from repro_torch.core.smr.registry import SCHEMES
from repro_torch.runtime.block_pool import BlockPool, StaleHandoff
from repro_torch.runtime.reclaim import make_policy
from repro_torch.serve.engine import ServeEngine

ALL_SCHEMES = list(SCHEMES)
BACKENDS = ("gen", "vec")
PACKAGES = {
    "port": types.SimpleNamespace(
        BlockPool=t_pool.BlockPool, StaleHandoff=t_pool.StaleHandoff,
        Policy=t_reclaim.SimulatedSMRPolicy, Costs=t_sim.Costs,
        UseAfterFree=t_sim.UseAfterFree),
    "reference": types.SimpleNamespace(
        BlockPool=j_pool.BlockPool, StaleHandoff=j_pool.StaleHandoff,
        Policy=j_reclaim.SimulatedSMRPolicy, Costs=j_sim.Costs,
        UseAfterFree=j_sim.UseAfterFree),
}


def _sim_pool(pk, scheme, backend, num_blocks=48, n_engines=3):
    """The reference test's store-buffer regime: drains never complete on
    their own and only a signal forces them."""
    costs = pk.Costs(drain_latency=10_000_000, drain_jitter=0,
                     signal_latency=500)
    return pk.BlockPool(num_blocks, n_engines=n_engines, reclaim_threshold=2,
                        pressure_factor=1,
                        policy=pk.Policy(scheme, backend=backend,
                                         costs=costs))


def _counters(pool):
    """The pool's counters (wall-clock fields, ``*_s``, left out) and each
    simulated thread's ``Stats`` and clock."""
    out = {k: v for k, v in asdict(pool.stats).items()
           if not k.endswith("_s")}
    out["sim"] = [(asdict(t.stats), t.clock)
                  for t in pool.policy.sim.threads]
    return out


def _outcome(pool, **extra):
    with pool._lock:
        free = sorted(pool._freeset)
    return dict(stats=_counters(pool), free=free,
                leak_free=pool.check_no_leaks(), **extra)


def migrate_then_retire(pk, scheme, backend):
    pool = _sim_pool(pk, scheme, backend)
    pool.start_step(0)
    blocks = pool.allocate(0, 3)
    pool.end_step(0)
    pool.start_step(2)                   # engine 2's reader session
    pool.reserve(2, blocks)
    pool.touch(2, blocks)
    pool.start_step(1)                   # engine 1's clock moves first
    junk = pool.allocate(1, 16)
    pool.end_step(1)
    pool.adopt(0, 1, blocks)             # the migration: 0 -> 1
    assert pool.stats.adopts == 1 and pool.stats.adopted_blocks == 3
    pool.start_step(1)
    pool.retire(1, blocks)               # the new owner retires them
    pool.end_step(1)
    try:
        pool.reclaim()
        pool.touch(2, blocks)            # the session must still hold
    except pk.UseAfterFree:
        return dict(uaf=True, stats=_counters(pool))
    pool.end_step(2)
    pool.retire(1, junk)
    for e in range(3):
        pool.start_step(e)
        pool.end_step(e)
    pool.reclaim()
    return _outcome(pool, uaf=False)


def adopt_before_crash(pk, scheme, backend):
    pool = _sim_pool(pk, scheme, backend)
    pool.start_step(0)
    blocks = pool.allocate(0, 3)
    pool.end_step(0)
    pool.adopt(0, 1, blocks)
    recovered = pool.crash_engine(0)     # src owned nothing anymore
    pool.start_step(1)
    pool.reserve(1, blocks)
    pool.touch(1, blocks)
    pool.end_step(1)
    pool.retire(1, blocks)
    for e in (1, 2):
        pool.start_step(e)
        pool.end_step(e)
    pool.reclaim()
    return _outcome(pool, recovered=recovered)


def crash_before_adopt(pk, scheme, backend):
    pool = _sim_pool(pk, scheme, backend)
    blocks = pool.allocate(0, 3)
    recovered = pool.crash_engine(0)     # orphans retired on a survivor
    adopts = pool.stats.adopts
    try:
        pool.adopt(0, 1, blocks)         # the stale queued migration
        refused = False
    except pk.StaleHandoff:
        refused = True
    unchanged = pool.stats.adopts == adopts
    resurrected = bool(set(blocks) & pool._live_local[1])
    pool.start_step(2)
    fresh = pool.allocate(2, 3)
    pool.reserve(2, fresh)
    pool.touch(2, fresh)
    pool.end_step(2)
    pool.retire(2, fresh)
    for e in (1, 2):
        pool.start_step(e)
        pool.end_step(e)
    pool.reclaim()
    return _outcome(pool, recovered=recovered, refused=refused,
                    unchanged=unchanged, resurrected=resurrected)


def _both(scenario, scheme, backend):
    got = {name: scenario(pk, scheme, backend)
           for name, pk in PACKAGES.items()}
    assert got["port"] == got["reference"]
    return got["port"]


# ----------------------------------------------------------------------------
# 1. migrate-then-retire under an open reader session
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("scheme", ALL_SCHEMES)
def test_migrate_then_retire_under_reader_session(scheme, backend):
    """Safe schemes keep every touch of the open session valid; HP-broken
    (unfenced reservation stores) must fire -- on both pools alike."""
    got = _both(migrate_then_retire, scheme, backend)
    assert got["uaf"] == (scheme == "HP-broken")
    if not got["uaf"]:
        assert got["leak_free"]


# ----------------------------------------------------------------------------
# 2. adopt while a native publish-on-ping pass is mid-publish (a property)
# ----------------------------------------------------------------------------


def test_adopt_races_native_pop_pass_mid_publish():
    """The destination publishes its pre-adopt live set, then the blocks
    move and the new owner retires them; the pass must not free them
    (their retire lands at an epoch >= the pass's cut)."""
    pool = BlockPool(32, n_engines=3, reclaim_threshold=100,
                     ping_timeout_s=10.0,
                     policy=make_policy(None, pop_every=1))
    blocks = pool.allocate(0, 4)
    junk = pool.allocate(2, 4)
    pool.retire(2, junk)
    flags = pool.policy._ping_flags
    done = threading.Event()

    def reclaimer():
        pool.reclaim(None)               # pings engines 0, 1, 2
        done.set()

    t = threading.Thread(target=reclaimer, daemon=True)
    t.start()
    assert flags[1].wait(timeout=5.0), "POP pass never pinged engine 1"
    pool.safepoint(1)                # dst publishes its PRE-adopt live set
    pool.adopt(0, 1, blocks)         # the migration, mid-pass
    pool.retire(1, blocks)           # new owner retires: epoch >= cut
    pool.safepoint(0)
    pool.safepoint(2)
    done.wait(timeout=15.0)
    t.join(timeout=15.0)
    assert done.is_set(), "POP pass did not complete"
    with pool._lock:
        assert not (set(blocks) & pool._freeset), \
            "POP pass freed blocks whose adopt raced its publish window"
    assert pool.retired_blocks >= len(blocks)
    pool.reclaim()
    with pool._lock:
        assert set(blocks) <= pool._freeset
    assert pool.check_no_leaks()


# ----------------------------------------------------------------------------
# 3. migration against the source engine's crash
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("scheme", ALL_SCHEMES)
def test_adopt_before_crash_completes_safely(scheme, backend):
    got = _both(adopt_before_crash, scheme, backend)
    assert got["recovered"] == 0 and got["leak_free"]
    assert got["stats"]["stale_handoffs"] == 0


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("scheme", ALL_SCHEMES)
def test_crash_before_adopt_is_refused_as_stale(scheme, backend):
    got = _both(crash_before_adopt, scheme, backend)
    assert got["recovered"] == 3 and got["refused"] and got["unchanged"]
    assert not got["resurrected"] and got["leak_free"]
    assert got["stats"]["stale_handoffs"] == 1


def test_stale_shared_reference_also_refused():
    pool = BlockPool(16, n_engines=3, reclaim_threshold=8)
    blocks = pool.allocate(0, 2)
    assert pool.share_prefix(0, ("k", 1), blocks)
    pool.release_shared(0, blocks)       # source dropped its request refs
    with pytest.raises(StaleHandoff):
        pool.adopt(0, 1, [], shared=blocks)
    assert pool.stats.stale_handoffs == 1
    pool.evict_prefixes(1)
    pool.reclaim()
    assert pool.check_no_leaks()


# ----------------------------------------------------------------------------
# 4. serving: migration rescues a stalled, statically placed fleet
# ----------------------------------------------------------------------------

KW = dict(name="mig-smoke", d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
          vocab=64, remat="none", dtype="float32")
JCFG = JArch(groups=j_stack(2), **KW)
CFG = ArchConfig(groups=dense_stack(2), **KW)
PROMPTS = [[1 + (i % 7), 2, 3, 4 + (i % 5)] for i in range(12)]


@pytest.fixture(scope="module")
def served():
    """The bridged weights and the reference engine's tokens."""
    jp = j_init(JCFG, jax.random.PRNGKey(0))
    eng = JEngine(JCFG, jp, max_batch=2, page_size=4, num_pages=96,
                  max_seq=32)
    eng.start()
    reqs = [eng.submit(p, max_new=4) for p in PROMPTS]
    for r in reqs:
        assert r.done.wait(timeout=120)
    eng.stop()
    assert eng.error is None
    return params_from_jax(jax.device_get(jp)), [list(r.out) for r in reqs]


@pytest.mark.parametrize("scheme", ["EpochPOP-pool", "EpochPOP", "EBR"])
def test_serving_migration_smoke(scheme, served):
    """Static placement piles requests onto a stalled engine 0; the
    migration monitor re-homes them (adopts under live reclamation): the
    reference's tokens, no use-after-free, a leak-free pool."""
    params, want = served
    smr = None if scheme == "EpochPOP-pool" else scheme
    eng = ServeEngine(CFG, params, device="cpu", max_batch=2, page_size=4,
                      num_pages=96, max_seq=32, smr=smr, n_engines=3,
                      sim_backend="vec", place_policy="static", migrate=True,
                      migrate_interval_s=0.005, migrate_threshold=2,
                      stall_every=2, stall_s=0.05, stall_workers=(0,))
    eng.start()
    reqs = [eng.submit(p, max_new=4) for p in PROMPTS]
    for r in reqs:
        assert r.done.wait(timeout=120), f"request {r.rid} never finished"
    eng.stop()
    assert eng.error is None, f"engine failed: {eng.error!r}"
    assert [list(r.out) for r in reqs] == want
    assert eng.injected_stalls > 0
    eng.pool.evict_prefixes(0)
    eng.pool.policy.flush()
    assert eng.pool.check_no_leaks()
    assert eng.pool.stats.stale_handoffs == 0
