"""Workload harness: runs (data structure x SMR scheme x thread count) trials
on the simulator and reports the paper's metrics -- throughput (ops per
million simulated cycles), fences, signals, publishes, restarts, garbage
peak/final.  Mirrors the setbench methodology (§5.0.2): prefill to half the
key range, then timed mixed operations.

Determinism contract: every stochastic draw flows through an injected
seeded ``random.Random`` -- never the module-global RNG -- so trial rows
are bit-reproducible from ``seed`` alone (the gauntlet's row-determinism
regression and the fleet harness's replayable traces both lean on this).
``rng_factory(seed, tid)`` is the seam: the default derivation
(``Random((seed << 16) ^ tid ^ 0x5EED)``, tid -1 for the single-threaded
prefill shuffle) keeps historical streams byte-identical, and tests can
inject a recording factory to audit every draw.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

from repro_torch.core.sim import make_engine
from repro_torch.core.sim.engine import Costs, Engine, Neutralized, ThreadCtx
from repro_torch.core.smr.registry import make_scheme
from repro_torch.core.structures.external_bst import ExternalBST
from repro_torch.core.structures.harris_michael import HarrisMichaelList
from repro_torch.core.structures.hash_table import HashTable
from repro_torch.core.structures.lazy_list import LazyList

STRUCTURES: Dict[str, Callable] = {
    "HML": lambda eng, smr, key_range: HarrisMichaelList(eng, smr),
    "LL": lambda eng, smr, key_range: LazyList(eng, smr),
    "HMHT": lambda eng, smr, key_range: HashTable(eng, smr, nbuckets=max(8, key_range // 8)),
    "DGT": lambda eng, smr, key_range: ExternalBST(eng, smr),
}

# mixes from the paper: read-heavy 90/5/5, update-heavy 0/50/50
WORKLOADS = {
    "read": (0.90, 0.05, 0.05),
    "update": (0.0, 0.50, 0.50),
}


def default_rng_factory(seed: int, tid: int) -> random.Random:
    """The canonical per-thread RNG derivation (tid -1 = prefill stream).
    A pure function of (seed, tid): equal inputs give equal streams, and
    no draw anywhere in the harness touches the module-global RNG."""
    if tid < 0:
        return random.Random(seed)
    return random.Random((seed << 16) ^ tid ^ 0x5EED)


@dataclass
class TrialResult:
    structure: str
    scheme: str
    nthreads: int
    workload: str
    ops: int = 0
    sim_cycles: float = 0.0
    throughput: float = 0.0         # ops per million simulated cycles
    fences: int = 0
    signals_sent: int = 0
    signals_handled: int = 0
    publishes: int = 0
    membarriers: int = 0
    restarts: int = 0
    retired: int = 0
    freed: int = 0
    garbage_peak: int = 0
    garbage_final: int = 0
    per_key: Dict[int, int] = field(default_factory=dict)  # +1 ins, -1 del


def _op_body(
    structure,
    smr,
    duration: float,
    read_frac: float,
    ins_frac: float,
    key_range: int,
    seed: int,
    result: TrialResult,
    read_only: bool = False,
    rng_factory: Callable[[int, int], random.Random] = default_rng_factory,
):
    def body(t: ThreadCtx):
        rng = rng_factory(seed, t.tid)
        smr.thread_init(t)
        ops = 0
        while t.clock < duration:
            r = rng.random()
            key = rng.randrange(key_range)
            if read_only or r < read_frac:
                kind = "c"
            elif r < read_frac + ins_frac:
                kind = "i"
            else:
                kind = "d"
            # --- one operation, with NBR-style restart handling ---
            while True:
                yield from smr.start_op(t)
                try:
                    if kind == "c":
                        res = yield from structure.contains(t, key)
                    elif kind == "i":
                        res = yield from structure.insert(t, key)
                    else:
                        res = yield from structure.delete(t, key)
                except Neutralized:
                    pa = t.local.get("pending_alloc")
                    if pa:
                        t.local["pending_alloc"] = None
                        yield from t.free(pa)
                    continue
                break
            if res and kind == "i":
                result.per_key[key] = result.per_key.get(key, 0) + 1
            elif res and kind == "d":
                result.per_key[key] = result.per_key.get(key, 0) - 1
            while True:
                try:
                    yield from smr.end_op(t)
                except Neutralized:
                    continue
                break
            ops += 1
        t.stats.ops = ops

    return body


def prefill(engine: Engine, structure, smr, key_range: int, target: int,
            seed: int,
            rng_factory: Callable[[int, int], random.Random]
            = default_rng_factory):
    """Prefill to ``target`` keys (paper: half the key range), single-threaded."""
    keys = list(range(key_range))
    rng_factory(seed, -1).shuffle(keys)
    keys = keys[:target]

    def body(t: ThreadCtx):
        smr.thread_init(t)
        for k in keys:
            yield from smr.start_op(t)
            yield from structure.insert(t, k)
            yield from smr.end_op(t)

    engine.spawn(0, body)
    engine.run()
    # reset clocks and stats so the timed phase starts clean
    for t in engine.threads:
        t.clock = 0.0
        t.done = False
        t.frames = []
    engine.time = 0.0


def run_trial(
    structure_name: str,
    scheme_name: str,
    nthreads: int,
    workload: str = "update",
    key_range: int = 128,
    duration: float = 400_000.0,
    seed: int = 1,
    costs: Optional[Costs] = None,
    reclaim_freq: int = 32,
    epoch_freq: int = 8,
    preempt_prob: float = 0.0,
    max_steps: int = 80_000_000,
    backend: str = "gen",
    rng_factory: Callable[[int, int], random.Random] = default_rng_factory,
) -> TrialResult:
    engine = make_engine(nthreads, backend=backend, costs=costs, seed=seed,
                         preempt_prob=preempt_prob)
    smr = make_scheme(
        scheme_name, engine, max_hp=4, reclaim_freq=reclaim_freq, epoch_freq=epoch_freq
    )
    engine.set_signal_handler(smr.handler)
    structure = STRUCTURES[structure_name](engine, smr, key_range)
    prefill(engine, structure, smr, key_range, key_range // 2, seed,
            rng_factory=rng_factory)

    read_frac, ins_frac, _ = WORKLOADS[workload]
    res = TrialResult(structure_name, scheme_name, nthreads, workload)
    for tid in range(nthreads):
        engine.spawn(
            tid,
            _op_body(structure, smr, duration, read_frac, ins_frac,
                     key_range, seed, res, rng_factory=rng_factory),
        )
    engine.run(max_steps=max_steps)

    for t in engine.threads:
        res.ops += t.stats.ops
        res.fences += t.stats.fences
        res.signals_sent += t.stats.signals_sent
        res.signals_handled += t.stats.signals_handled
        res.publishes += t.stats.publishes
        res.membarriers += t.stats.membarriers
        res.restarts += t.stats.restarts
        res.retired += t.stats.retired
        res.freed += t.stats.freed
    res.sim_cycles = max(duration, engine.time)
    res.throughput = res.ops / (res.sim_cycles / 1e6)
    res.garbage_peak = smr.garbage_peak
    res.garbage_final = smr.garbage
    res._engine = engine
    res._smr = smr
    res._structure = structure
    return res
