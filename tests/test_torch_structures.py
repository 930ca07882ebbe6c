"""The port's data structures and workload harness (``core/structures``,
``core/workload.py``) against the reference package's.

Both run the paper's trials on their own copy of the simulator with the
same arguments.  A trial is a pure function of its seed, so the two must
agree exactly -- not within a tolerance -- on every public ``TrialResult``
field, ``throughput`` included, for every scheme of ``PAPER_SET`` on the
four structures, both workload mixes and both simulator backends.  The
port's simulator keeps its store buffers as indexed deques where the
reference scans a list (same FIFO semantics): these trials hold the two
equal over whole runs.

Then the scenarios of ``tests/test_structures.py`` on the port:
sequential semantics against a model set, snapshot consistency under a
churn workload, and recycling of freed nodes; and a recording
``rng_factory`` whose draw log equals the reference's.
"""

import dataclasses
import random

import pytest

import repro.core.workload as j_workload
from repro.core.smr.registry import PAPER_SET
from repro_torch.core.sim.engine import Costs, Engine
from repro_torch.core.smr.registry import PAPER_SET as T_PAPER_SET
from repro_torch.core.smr.registry import make_scheme
from repro_torch.core.workload import (STRUCTURES, WORKLOADS, TrialResult,
                                       default_rng_factory, run_trial)

STRUCTS = ["HML", "LL", "HMHT", "DGT"]
#: 4 threads, key_range 64, 60k simulated cycles: the reference runs a
#: gen trial in ~0.25 s here, a vec trial in ~0.06 s
GRID = dict(key_range=64, duration=60_000, seed=3)
FIELDS = [f.name for f in dataclasses.fields(TrialResult)]


def _row(res):
    return {f: getattr(res, f) for f in FIELDS}


def test_the_port_holds_the_same_grid():
    assert T_PAPER_SET == PAPER_SET
    assert list(STRUCTURES) == list(j_workload.STRUCTURES) == STRUCTS
    assert WORKLOADS == j_workload.WORKLOADS
    assert FIELDS == [f.name for f in
                      dataclasses.fields(j_workload.TrialResult)]
    for seed, tid in ((0, -1), (7, -1), (7, 0), (7, 3), (1 << 20, 5)):
        assert (default_rng_factory(seed, tid).random()
                == j_workload.default_rng_factory(seed, tid).random())


@pytest.mark.parametrize("backend", ["gen", "vec"])
@pytest.mark.parametrize("workload", ["read", "update"])
@pytest.mark.parametrize("structure", STRUCTS)
@pytest.mark.parametrize("scheme", PAPER_SET)
def test_trial_rows_equal_reference(scheme, structure, workload, backend):
    kw = dict(GRID, workload=workload, backend=backend)
    want = _row(j_workload.run_trial(structure, scheme, 4, **kw))
    got = _row(run_trial(structure, scheme, 4, **kw))
    assert got == want, {f: (got[f], want[f]) for f in FIELDS
                         if got[f] != want[f]}
    assert got["ops"] > 0


class _Recorder:
    """An ``rng_factory`` that logs every stream it makes and every draw
    taken from it."""

    def __init__(self, base):
        self.base, self.log = base, []

    def __call__(self, seed, tid):
        rng, log = self.base(seed, tid), self.log
        log.append(("make", seed, tid))

        class Logged(random.Random):
            def random(self):
                x = rng.random()
                log.append(("random", tid, x))
                return x

            def randrange(self, *a):
                x = rng.randrange(*a)
                log.append(("randrange", tid, a, x))
                return x

            def shuffle(self, seq):
                rng.shuffle(seq)
                log.append(("shuffle", tid, tuple(seq)))

        return Logged()


@pytest.mark.parametrize("backend", ["gen", "vec"])
def test_recording_rng_factory_sees_the_reference_draws(backend):
    kw = dict(workload="update", key_range=32, duration=40_000, seed=11,
              backend=backend)
    j_rec = _Recorder(j_workload.default_rng_factory)
    t_rec = _Recorder(default_rng_factory)
    want = j_workload.run_trial("HML", "HazardPtrPOP", 3, rng_factory=j_rec,
                                **kw)
    got = run_trial("HML", "HazardPtrPOP", 3, rng_factory=t_rec, **kw)
    assert len(t_rec.log) > 100
    assert t_rec.log == j_rec.log
    assert _row(got) == _row(want)
    # the default factory's streams are the recorded ones
    assert _row(run_trial("HML", "HazardPtrPOP", 3, **kw)) == _row(got)


@pytest.mark.parametrize("structure", STRUCTS)
def test_sequential_semantics_vs_model(structure):
    eng = Engine(1, costs=Costs(), seed=0)
    smr = make_scheme("NR", eng, max_hp=4)
    eng.set_signal_handler(smr.handler)
    ds = STRUCTURES[structure](eng, smr, 64)
    rng = random.Random(42)
    ops = [(rng.choice(["i", "d", "c"]), rng.randrange(40))
           for _ in range(400)]
    results = []

    def body(t):
        smr.thread_init(t)
        model = set()
        for kind, k in ops:
            yield from smr.start_op(t)
            if kind == "i":
                r = yield from ds.insert(t, k)
                expected = k not in model
                model.add(k)
            elif kind == "d":
                r = yield from ds.delete(t, k)
                expected = k in model
                model.discard(k)
            else:
                r = yield from ds.contains(t, k)
                expected = k in model
            yield from smr.end_op(t)
            results.append((kind, k, r, expected))

    eng.spawn(0, body)
    eng.run()
    assert len(results) == len(ops)
    for kind, k, r, expected in results:
        assert r == expected, f"{structure}: {kind}({k}) -> {r}, want "\
            f"{expected}"


@pytest.mark.parametrize("structure", STRUCTS)
@pytest.mark.parametrize("scheme", ["EpochPOP", "HazardPtrPOP", "HE"])
def test_concurrent_consistency(structure, scheme):
    key_range, seed = 32, 5
    r = run_trial(structure, scheme, 4, workload="update", key_range=key_range,
                  duration=150_000, seed=seed, reclaim_freq=8)
    keys = list(range(key_range))
    random.Random(seed).shuffle(keys)
    pre = set(keys[: key_range // 2])
    exp = set()
    for k in range(key_range):
        n = (1 if k in pre else 0) + r.per_key.get(k, 0)
        assert n in (0, 1)
        if n:
            exp.add(k)
    assert set(r._structure.snapshot_keys()) == exp


def test_memory_is_actually_reclaimed_and_recycled():
    """Freed nodes are recycled by the allocator (ABA pressure is real)."""
    r = run_trial("HML", "EpochPOP", 4, workload="update", key_range=32,
                  duration=300_000, seed=9, reclaim_freq=8)
    alloc = r._engine.mem.alloc
    assert r.freed > 100
    assert alloc.freed_count > 100
    assert alloc.live_count + len(sum(alloc.freelist.values(), [])) < r.retired
