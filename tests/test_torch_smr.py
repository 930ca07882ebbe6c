"""The port's SMR simulator, schemes, simulator-backed reclaim policy, trace
generator and SLO accounting against the reference package's.

These modules are host-side simulation and accounting (numpy and the
standard library), copied into the port.  Given a seed and one driving
thread they are deterministic, so the two packages must agree exactly --
not within a tolerance -- on:

* the scripted block-pool churn with a cross-engine session held over
  retires (``tests/test_reclaim_policies.py``), for every registry scheme on
  both simulator backends: every ``PoolStats`` counter, the order in which
  blocks are freed, the simulator's per-thread ``Stats`` and clocks, and
  the scheme's own counters;
* a fixed reader/writer program on the bare simulator, with and without a
  ``FaultPlan`` (stalls, signal delay, a crashed reader): final clock,
  ``Stats``, the memory image and the allocator's free lists;
* the crash-recovery scenario of the reference's policy tests;
* ``make_policy``'s resolution and its errors;
* ``generate`` on four workload specs and the trace's JSON round trip, and
  ``SLOTracker`` fed the same completions.

``PoolStats.max_ping_stall_s`` is a wall-clock time, so it is the one pool
field left out of the exact comparison.
"""

import dataclasses
import json
import random
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import repro.core.sim as j_sim
import repro.core.sim.engine as j_engine
import repro.core.smr.registry as j_registry
import repro.obs.slo as j_slo
import repro.runtime.block_pool as j_pool
import repro.runtime.reclaim as j_reclaim
import repro.serve.loadgen as j_loadgen
import repro_torch.core.sim as t_sim
import repro_torch.core.sim.engine as t_engine
import repro_torch.core.smr.registry as t_registry
import repro_torch.obs.slo as t_slo
import repro_torch.runtime.block_pool as t_pool
import repro_torch.runtime.reclaim as t_reclaim
import repro_torch.serve.loadgen as t_loadgen

REF = SimpleNamespace(sim=j_sim, engine=j_engine, registry=j_registry,
                      pool=j_pool, reclaim=j_reclaim, loadgen=j_loadgen,
                      slo=j_slo)
PORT = SimpleNamespace(sim=t_sim, engine=t_engine, registry=t_registry,
                       pool=t_pool, reclaim=t_reclaim, loadgen=t_loadgen,
                       slo=t_slo)
SCHEMES = list(j_registry.SCHEMES)
BACKENDS = ["gen", "vec"]


def test_the_port_holds_the_same_schemes_and_backends():
    assert list(t_registry.SCHEMES) == SCHEMES
    assert list(t_registry.PAPER_SET) == list(j_registry.PAPER_SET)
    assert sorted(t_sim.BACKENDS) == sorted(j_sim.BACKENDS)
    assert t_reclaim.supported_schemes() == j_reclaim.supported_schemes()


# ---------------------------------------------------------------------------
# scripted block-pool runs
# ---------------------------------------------------------------------------

class _FreedOrder:
    """Block listener recording every freed block id in order."""

    def __init__(self):
        self.order = []

    def on_alloc(self, blocks):
        pass

    def on_free(self, blocks):
        self.order.extend(int(b) for b in blocks)


def _churn(P, pool, *, steps=60, per_req=2, window=3):
    """tests/test_reclaim_policies.py's single-engine serving protocol."""
    live = []
    for _ in range(steps):
        pool.start_step(0)
        try:
            blocks = pool.allocate(0, per_req)
            live.append(blocks)
        except P.pool.OutOfBlocks:
            pool.reclaim(0)
            pool.end_step(0)
            continue
        session = [b for req in live for b in req]
        pool.reserve(0, session)
        pool.touch(0, session)
        if len(live) > window:
            pool.retire(0, live.pop(0))
        pool.end_step(0)
    for req in live:
        pool.retire(0, req)


def _scalars(obj):
    """An object's counters: its int/float/bool attributes and lists of
    them (the schemes' per-thread tallies)."""
    out = {}
    for k, v in sorted(vars(obj).items()):
        if isinstance(v, (bool, int, float)):
            out[k] = v
        elif (isinstance(v, (list, tuple)) and v
              and all(isinstance(x, (bool, int, float)) for x in v)):
            out[k] = list(v)
    return out


def _fingerprint(pool, listener, err):
    pol = pool.policy
    stats = dataclasses.asdict(pool.stats)
    stats.pop("max_ping_stall_s")
    return {
        "err": err,
        "pool": stats,
        "freed_order": listener.order,
        "free_blocks": pool.free_blocks,
        "retired_blocks": pool.retired_blocks,
        "sim_stats": [dataclasses.asdict(t.stats) for t in pol.sim.threads],
        "sim_clocks": [float(t.clock) for t in pol.sim.threads],
        "scheme": _scalars(pol.smr),
        "unreclaimed": pol.unreclaimed,
    }


def _pool_run(P, scheme, backend):
    """test_smr_scheme_never_fires_uaf_under_pressure's protocol: engine 1
    holds a session over two blocks while engine 0 churns, then the owner
    retires them under the open session."""
    pool = P.pool.BlockPool(
        64, n_engines=2, reclaim_threshold=4, pressure_factor=1,
        policy=P.reclaim.SimulatedSMRPolicy(scheme, backend=backend))
    rec = _FreedOrder()
    pool.add_block_listener(rec)
    err = None
    try:
        shared = pool.allocate(0, 2)
        pool.start_step(1)
        pool.reserve(1, shared)
        _churn(P, pool, steps=60)
        pool.touch(1, shared)
        pool.retire(0, shared)
        pool.touch(1, shared)
        pool.end_step(1)
        pool.start_step(0)
        pool.end_step(0)
        pool.reclaim()
    except P.engine.UseAfterFree as e:
        err = (e.tid, e.addr, e.op)
    fp = _fingerprint(pool, rec, err)
    fp["no_leaks"] = pool.check_no_leaks() if err is None else None
    return fp


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("scheme", SCHEMES)
def test_scripted_pool_run_matches_reference_exactly(scheme, backend):
    want = _pool_run(REF, scheme, backend)
    got = _pool_run(PORT, scheme, backend)
    assert got == want
    if scheme == "HP-broken":
        return
    assert got["err"] is None and got["no_leaks"]
    if scheme == "NR" or (scheme, backend) == ("EBR", "vec"):
        # NR never frees; EBR driven on the vec backend keeps all 64
        # retired blocks through the closing quiescent step in the
        # reference as well (the equality above holds the port to it)
        assert got["pool"]["freed"] == 0
    else:
        assert got["pool"]["freed"] > 0 and got["freed_order"]


def _crash_run(P, scheme, backend):
    """test_crash_engine_sim_policy_survivors_keep_reclaiming's scenario."""
    pool = P.pool.BlockPool(
        64, n_engines=3, reclaim_threshold=4, pressure_factor=1,
        policy=P.reclaim.SimulatedSMRPolicy(scheme, backend=backend))
    rec = _FreedOrder()
    pool.add_block_listener(rec)
    pool.start_step(1)
    session = pool.allocate(1, 3)
    pool.reserve(1, session)
    pool.touch(1, session)
    pool.allocate(1, 2)
    lost = pool.crash_engine(1)
    _churn(P, pool, steps=40)
    pool.reclaim()
    again = pool.crash_engine(1)
    fp = _fingerprint(pool, rec, None)
    fp.update(lost=lost, again=again, no_leaks=pool.check_no_leaks())
    return fp


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("scheme",
                         ["HP", "HazardPtrPOP", "EpochPOP", "Hyaline",
                          "DEBRA+"])
def test_crash_recovery_matches_reference(scheme, backend):
    want = _crash_run(REF, scheme, backend)
    got = _crash_run(PORT, scheme, backend)
    assert got == want
    assert got["lost"] == 5 and got["again"] == 0
    assert got["pool"]["freed"] > 0 and got["no_leaks"]


# ---------------------------------------------------------------------------
# the bare simulator
# ---------------------------------------------------------------------------

FAULTS = dict(signal_delay=150.0, signal_delay_jitter=60.0,
              stalls=((1, 300.0, 6_000.0), (2, 900.0, 2_500.0)),
              crashes=((3, 1_000.0),))


def _sim_run(P, scheme, backend, faults):
    """Three readers walk the shared cells through the scheme's
    reservations while a writer replaces a cell's node per iteration and
    retires the old one; thread 3 may crash mid-run under the plan."""
    n, cells_n = 4, 4
    plan = P.sim.FaultPlan(**FAULTS) if faults else None
    costs = P.engine.Costs(signal_latency=300, handler_overhead=40)
    eng = P.sim.make_engine(n, backend=backend, costs=costs, seed=11,
                            faults=plan)
    smr = P.registry.make_scheme(scheme, eng, max_hp=2, reclaim_freq=2,
                                 epoch_freq=3)
    eng.set_signal_handler(smr.handler)
    cells = eng.alloc_shared(cells_n)
    Neutralized = P.engine.Neutralized
    seen = []

    def reader(t):
        smr.thread_init(t)
        for i in range(10):
            while True:
                try:
                    yield from smr.start_op(t)
                    a = yield from smr.read(t, 0, cells + (i + t.tid) % cells_n)
                    b = yield from smr.read(t, 1, cells + (i * 3) % cells_n)
                    va = (yield from t.load(a)) if a else -1
                    yield from t.work(40 * (t.tid + 1))
                    vb = (yield from t.load(b)) if b else -1
                    yield from smr.end_op(t)
                except Neutralized:
                    continue
                break
            seen.append((t.tid, i, va, vb))

    def writer(t):
        smr.thread_init(t)
        for c in range(cells_n):
            node = yield from smr.alloc_node(t, 1)
            yield from t.store(node, c)
            yield from t.atomic_store(cells + c, node)
        for i in range(24):
            while True:
                try:
                    yield from smr.start_op(t)
                    yield from smr.enter_write(t, [])
                    old = yield from smr.read(t, 0, cells + i % cells_n)
                    v = yield from t.load(old)
                    new = yield from smr.alloc_node(t, 1)
                    yield from t.store(new, v + cells_n)
                    yield from t.atomic_store(cells + i % cells_n, new)
                    yield from smr.end_op(t)
                except Neutralized:
                    continue
                break
            yield from smr.retire(t, old)
        yield from smr.flush(t)

    eng.spawn(0, writer)
    for tid in range(1, n):
        eng.spawn(tid, reader)
    err = None
    try:
        eng.run()
    except P.engine.SimError as e:
        err = (type(e).__name__, str(e))
    mem = eng.mem
    return {
        "err": err,
        "time": float(eng.time),
        "clocks": [float(t.clock) for t in eng.threads],
        "stats": [dataclasses.asdict(t.stats) for t in eng.threads],
        "seen": sorted(seen),
        "cells": [int(x) for x in mem.cells[:mem.brk]],
        "state": bytes(mem.state[:mem.brk]),
        "freelists": {k: list(v) for k, v in sorted(mem.alloc.freelist.items())},
        "live": mem.alloc.live_count,
        "freed": mem.alloc.freed_count,
        "scheme": _scalars(smr),
    }


@pytest.mark.parametrize("faults", [False, True], ids=["calm", "faults"])
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("scheme", SCHEMES)
def test_simulator_program_matches_reference_exactly(scheme, backend, faults):
    want = _sim_run(REF, scheme, backend, faults)
    got = _sim_run(PORT, scheme, backend, faults)
    assert got == want
    if scheme not in ("HP-broken",) and not faults:
        assert got["err"] is None
        assert len(got["seen"]) == 3 * 10


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_indexed_store_buffers_behave_as_the_reference_fifo(seed):
    """The port's ``Memory`` indexes each store buffer (O(1) forwarding
    and drains); under a random mix of stores, forwarded loads, drains by
    visibility time, full drains and membarrier cuts it must show the same
    forwarded values, cells and buffer contents as the reference's."""
    rng = random.Random(seed)
    mems = [j_engine.Memory(3), t_engine.Memory(3)]
    for m in mems:
        m._grow(16)
    clock = [0.0, 0.0, 0.0]
    for _ in range(3000):
        tid, op = rng.randrange(3), rng.random()
        addr = rng.randrange(1, 12)
        if op < 0.5:
            clock[tid] += rng.random()
            entry = [addr, rng.randrange(100), clock[tid],
                     clock[tid] + rng.random() * 3]
            mems[0].buffers[tid].append(list(entry))
            mems[1].buffer_store(tid, list(entry))
        elif op < 0.8:
            got = [m.forwarded(tid, addr) for m in mems]
            assert got[0] == got[1]
        elif op < 0.93:
            now = clock[tid] + rng.random()
            for m in mems:
                m.drain_until(tid, now)
        elif op < 0.97:
            for m in mems:
                m.drain_all(tid)
        else:
            cut = clock[tid] - rng.random()
            for m in mems:
                m.drain_issued_before(tid, cut)
        assert mems[0].cells[:16] == mems[1].cells[:16]
    for tid in range(3):
        assert [list(e) for e in mems[1].buffers[tid]] == \
            [list(e) for e in mems[0].buffers[tid]]


# ---------------------------------------------------------------------------
# make_policy
# ---------------------------------------------------------------------------

def _resolve(P, name):
    try:
        p = P.reclaim.make_policy(name)
    except Exception as e:          # the error itself is what is compared
        return ("raises", type(e).__name__, str(e))
    return (type(p).__name__, p.name, getattr(p, "scheme_name", None))


def test_make_policy_resolves_the_reference_names_with_its_errors():
    names = [None, "", "EpochPOP-pool", "pool", "unsafe", "unsafe-eager",
             *SCHEMES, "bogus"]
    got = [_resolve(PORT, n) for n in names]
    assert got == [_resolve(REF, n) for n in names]
    assert ("raises", "ValueError") == got[names.index("HP-broken")][:2]
    assert ("raises", "ValueError") == got[-1][:2]
    for s in t_reclaim.supported_schemes():
        assert got[names.index(s)][0] == "SimulatedSMRPolicy"
        assert t_reclaim.is_simulated(s)
    kw = dict(backend="vec", seed=3, reclaim_freq=5, epoch_freq=2)
    p = t_reclaim.make_policy("EpochPOP", **kw)
    assert (p.backend, p.seed, p.reclaim_freq, p.epoch_freq) == ("vec", 3, 5, 2)
    assert isinstance(t_reclaim.make_policy("EpochPOP-pool", **kw),
                      t_reclaim.EpochPOPPolicy)


# ---------------------------------------------------------------------------
# loadgen and slo
# ---------------------------------------------------------------------------

def _specs(L):
    chat = L.TenantSpec(
        "chat", weight=3.0, system_prefix=16,
        prompt_len={"kind": "lognormal", "mu": 2.0, "sigma": 0.7, "lo": 4,
                    "hi": 32},
        output_len={"kind": "zipf", "alpha": 1.3, "lo": 2, "hi": 10})
    batch = L.TenantSpec("batch", prompt_len={"kind": "fixed", "value": 12},
                         output_len={"kind": "fixed", "value": 6})
    tools = L.TenantSpec(
        "tools", system_prefix=8,
        prompt_len={"kind": "zipf", "alpha": 1.1, "lo": 6, "hi": 28},
        output_len={"kind": "zipf", "alpha": 0.9, "lo": 1, "hi": 12})
    return {
        "poisson": L.WorkloadSpec(duration_s=4.0, seed=1, tenants=(batch,),
                                  process="poisson", rate_rps=12.0),
        "gamma": L.WorkloadSpec(duration_s=4.0, seed=2,
                                tenants=(chat, batch), process="gamma",
                                rate_rps=15.0, burstiness=8.0, vocab=100),
        "diurnal": L.WorkloadSpec(duration_s=6.0, seed=3, tenants=(chat,),
                                  rate_rps=10.0,
                                  diurnal=((0.0, 0.5), (0.4, 1.8),
                                           (0.7, 1.0), (1.0, 0.4))),
        "zipf-prefixes": L.WorkloadSpec(duration_s=4.0, seed=4,
                                        tenants=(chat, tools, batch),
                                        rate_rps=20.0, vocab=50),
    }


@pytest.mark.parametrize("kind", ["poisson", "gamma", "diurnal",
                                  "zipf-prefixes"])
def test_generate_gives_the_reference_trace(kind):
    want = j_loadgen.generate(_specs(j_loadgen)[kind])
    got = t_loadgen.generate(_specs(t_loadgen)[kind])
    assert len(got.requests) > 5
    assert got.to_json() == want.to_json()
    assert [dataclasses.astuple(r) for r in got.requests] == \
        [dataclasses.astuple(r) for r in want.requests]
    back = t_loadgen.Trace.from_json(got.to_json())
    assert back.to_json() == got.to_json()
    assert back.to_json() == j_loadgen.Trace.from_json(want.to_json()).to_json()
    assert json.loads(got.to_json()) == json.loads(want.to_json())
    if kind == "zipf-prefixes":
        by = {}
        for r in got.requests:
            by.setdefault(r.tenant, []).append(r.prompt)
        for name, n in (("chat", 16), ("tools", 8)):
            assert len({p[:n] for p in by[name]}) == 1


def test_replay_submits_in_arrival_order_on_an_injected_clock():
    trace = t_loadgen.generate(_specs(t_loadgen)["poisson"])
    now = [0.0]
    got = t_loadgen.replay(trace, lambda r: (now[0], r.t_s),
                           clock=lambda: now[0],
                           sleep=lambda d: now.__setitem__(0, now[0] + d))
    ts = [t for _, t in got]
    assert ts == sorted(r.t_s for r in trace.requests)
    assert all(abs(at - t) < 1e-9 for at, t in got)


def _slo_feed(S, events):
    tr = S.SLOTracker(S.SLOSpec(ttft_s=0.3, tok_latency_s=0.05, name="x"),
                      window_s=0.5)
    met = [tr.observe(**e) for e in events]
    return met, tr.summary(4.0), tr.attainment(), tr.goodput(4.0)


def test_slo_tracker_matches_reference():
    rng = np.random.default_rng(8)
    events = [dict(t_finish_s=float(rng.uniform(0, 4)),
                   tokens=int(rng.integers(1, 17)),
                   ttft_s=float(rng.uniform(0, 0.6)),
                   tok_latency_s=float(rng.uniform(0, 0.1)),
                   tenant=random.Random(i).choice(["chat", "batch", "tools"]))
              for i in range(60)]
    got = _slo_feed(t_slo, events)
    assert got == _slo_feed(j_slo, events)
    assert 0 < got[2] < 1 and len(got[1]["slo_windows"]) > 4


def test_sampler_reads_every_engine_probe_on_a_port_engine():
    from repro_torch.configs.base import ArchConfig, dense_stack
    from repro_torch.models.model import init_params
    from repro_torch.obs import TimeSeriesSampler, engine_probes
    from repro_torch.serve.engine import ServeEngine

    cfg = ArchConfig(name="kv-plain", d_model=32, n_heads=4, n_kv_heads=2,
                     d_ff=64, vocab=64, remat="none", dtype="float32",
                     groups=dense_stack(2))
    params = init_params(cfg, torch.Generator().manual_seed(2), device="cpu")
    eng = ServeEngine(cfg, params, device="cpu", smr="HazardPtrPOP",
                      n_engines=2, prefill_workers=1, max_batch=4,
                      page_size=4, num_pages=64, max_seq=32, kv_store="paged")
    probes = engine_probes(eng)
    s = TimeSeriesSampler(probes, interval_s=0.01)
    eng.start()
    reqs = [eng.submit([3, 1, 4, 1, 5, 9][: i + 2], max_new=3)
            for i in range(4)]
    s.sample_once()
    for r in reqs:
        assert r.done.wait(timeout=120)
    eng.stop()
    assert eng.error is None
    row = s.sample_once()
    assert set(probes) <= set(row)
    assert all(row[k] is not None for k in probes), row
    assert row["resident_kv_bytes"] == float(eng.kv_store.nbytes) > 0
    assert row["free_blocks"] + row["retired_blocks"] <= 64
