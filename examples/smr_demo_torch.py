"""The paper's robustness story in one run: stall a reader and watch EBR's
garbage grow unbounded while EpochPOP pings its way to a bounded footprint.

The twin of ``smr_demo.py`` on the PyTorch/CUDA port's copy of the simulator
(``repro_torch.core``, bit-exact with the reference's): it prints the
same lines.  The simulator is host code; no card is used.

    PYTHONPATH=src python examples/smr_demo_torch.py
"""

import random

from repro_torch.core.sim.engine import Costs, Engine
from repro_torch.core.smr.registry import make_scheme
from repro_torch.core.structures.harris_michael import HarrisMichaelList

DURATION = 400_000.0


def run(scheme_name: str):
    eng = Engine(6, costs=Costs(), seed=7)
    smr = make_scheme(scheme_name, eng, max_hp=4, reclaim_freq=16,
                      epoch_freq=4)
    eng.set_signal_handler(smr.handler)
    lst = HarrisMichaelList(eng, smr)

    def prefill(t):
        smr.thread_init(t)
        for k in range(0, 64, 2):
            yield from smr.start_op(t)
            yield from lst.insert(t, k)
            yield from smr.end_op(t)

    eng.spawn(0, prefill)
    eng.run()
    for t in eng.threads:
        t.clock, t.done, t.frames = 0.0, False, []

    def stalled(t):          # delayed but schedulable (paper Assumption 1)
        smr.thread_init(t)
        yield from smr.start_op(t)
        yield from smr.read(t, 0, lst.head)
        while t.clock < DURATION:
            yield from t.work(200)

    def churn(t):
        smr.thread_init(t)
        rng = random.Random(t.tid)
        while t.clock < DURATION:
            k = rng.randrange(64)
            yield from smr.start_op(t)
            if rng.random() < 0.5:
                yield from lst.insert(t, k)
            else:
                yield from lst.delete(t, k)
            yield from smr.end_op(t)

    eng.spawn(0, stalled)
    for tid in range(1, 6):
        eng.spawn(tid, churn)
    eng.run()
    retired = sum(t.stats.retired for t in eng.threads)
    extra = ""
    if hasattr(smr, "pop_reclaims"):
        extra = (f" epoch_reclaims={smr.epoch_reclaims}"
                 f" POP_reclaims={smr.pop_reclaims}")
    print(f"{scheme_name:14s} retired={retired:6d} freed={smr.frees:6d} "
          f"unreclaimed={smr.garbage:6d}{extra}")


if __name__ == "__main__":
    print("one reader stalls mid-operation; five threads churn:\n")
    for s in ["EBR", "HP", "HazardPtrPOP", "EpochPOP"]:
        run(s)
    print("\nEBR: the stalled epoch pins EVERYTHING. EpochPOP: the ping "
          "publishes the stalled reader's reservations; reclamation continues.")
