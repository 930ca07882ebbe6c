"""Quickstart: the paper's algorithms in 60 seconds.

The twin of ``quickstart.py`` on the PyTorch/CUDA port's copy of the simulator
(``repro_torch.core``, bit-exact with the reference's): it prints the
same lines.  The simulator is host code; no card is used.

1. Run the same concurrent-set workload under HP, HazardPtrPOP and EpochPOP
   on the TSO simulator and print the paper's headline comparison.
2. Demonstrate the litmus interleaving: fence-less HP hits a use-after-free,
   publish-on-ping survives it.

    PYTHONPATH=src python examples/quickstart_torch.py
"""

from repro_torch.core.sim.engine import Costs, Engine, UseAfterFree
from repro_torch.core.smr.registry import make_scheme
from repro_torch.core.workload import run_trial


def throughput_comparison():
    print("=== Harris-Michael list, update-heavy, 4 threads ===")
    base = None
    for scheme in ["NR", "HP", "HPAsym", "HE", "EBR",
                   "HazardPtrPOP", "HazardEraPOP", "EpochPOP"]:
        r = run_trial("HML", scheme, 4, workload="update", key_range=64,
                      duration=200_000, seed=3)
        if scheme == "HP":
            base = r.throughput
        rel = f"  ({r.throughput / base:.2f}x HP)" if base else ""
        print(f"  {scheme:14s} {r.throughput:9.1f} ops/Mcycle "
              f"fences={r.fences:6d} signals={r.signals_sent:4d}"
              f" publishes={r.publishes:4d}{rel}")


def _litmus(scheme_name: str, reader_delay_ops: int = 40):
    """Two threads, one shared pointer cell P -> node X (see
    tests/test_smr_litmus.py for the asserted version)."""
    costs = Costs(drain_latency=10_000_000, drain_jitter=0, signal_latency=500)
    eng = Engine(2, costs=costs, seed=0)
    eng.jitter = 0.0
    smr = make_scheme(scheme_name, eng, max_hp=2, reclaim_freq=1)
    eng.set_signal_handler(smr.handler)
    P = eng.alloc_shared(1)
    X = eng.mem.alloc.alloc(2)
    eng.mem.cells[X] = 42
    eng.mem.cells[P] = X
    out = {}

    def reader(t):
        smr.thread_init(t)
        yield from smr.start_op(t)
        x = yield from smr.read(t, 0, P)
        for _ in range(reader_delay_ops):   # "descheduled" mid-operation
            yield from t.work(100)
        out["val"] = yield from t.load(x)   # UAF if x was freed
        yield from smr.end_op(t)

    def reclaimer(t):
        smr.thread_init(t)
        yield from smr.start_op(t)
        yield from t.work(300)
        yield from t.cas(P, X, 0)           # unlink
        yield from smr.retire(t, X)         # threshold 1: reclaim now
        yield from smr.end_op(t)
        yield from smr.flush(t)

    eng.spawn(0, reader)
    eng.spawn(1, reclaimer)
    eng.run()
    return out


def litmus():
    print("\n=== The fence-elision litmus (paper Fig: why HP must fence) ===")
    try:
        _litmus("HP-broken")
        print("  HP without fence: (unexpectedly survived)")
    except UseAfterFree as e:
        print(f"  HP without fence: USE-AFTER-FREE detected ({e})")
    out = _litmus("HazardPtrPOP")
    print(f"  HazardPtrPOP (no fence on read, publish on ping): "
          f"read value {out['val']} -- safe")


if __name__ == "__main__":
    throughput_comparison()
    litmus()
