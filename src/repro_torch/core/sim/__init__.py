"""Simulator backends.

Two interchangeable engines implement the same programmer surface (thread
contexts with ``load/store/cas/faa/fence/membarrier/send_signal/alloc/
free``, signal handlers, ``UseAfterFree``/``DoubleFree`` tripwires,
``Stats``), so every scheme in ``core/smr/registry.py`` runs on either:

* ``"gen"`` -- :class:`repro_torch.core.sim.engine.Engine`: the discrete-event
  reference.  Smallest-clock-first scheduling, per-op cost jitter, one
  generator resume per memory access.  Bit-faithful, slow.
* ``"vec"`` -- :class:`repro_torch.core.sim.vec.VecEngine`: the batch-stepped
  backend.  Per-thread state in numpy arrays, inline op execution,
  horizon-bounded lockstep rounds.  ~5-10x the step throughput; the
  backend for scheme x engines sweeps past 4 engines.

Select with ``make_engine(n, backend="vec", ...)`` or the ``--sim-backend``
flag on ``benchmarks/serve_reclaim.py`` / ``benchmarks/smr_throughput.py``.
"""

from __future__ import annotations

from typing import Dict, Type

from repro_torch.core.sim.engine import (Costs, DoubleFree, Engine, Neutralized,
                                   SimError, Stats, ThreadCtx, UseAfterFree)
from repro_torch.core.sim.faults import FaultPlan
from repro_torch.core.sim.vec import VecEngine

__all__ = [
    "BACKENDS", "Costs", "DoubleFree", "Engine", "FaultPlan", "Neutralized",
    "SimError", "Stats", "ThreadCtx", "UseAfterFree", "VecEngine",
    "make_engine",
]

BACKENDS: Dict[str, Type] = {
    "gen": Engine,
    "vec": VecEngine,
}


def make_engine(nthreads: int, *, backend: str = "gen", **kw):
    """Build a simulator engine by backend name.

    Extra keyword arguments go to the backend constructor (``costs``,
    ``seed``, ``preempt_prob``, ``faults`` (a :class:`FaultPlan`), ... --
    plus ``quantum``/``horizon`` for ``vec``).
    """
    try:
        cls = BACKENDS[backend]
    except KeyError:
        raise ValueError(
            f"unknown sim backend {backend!r}; choose from "
            f"{sorted(BACKENDS)}") from None
    return cls(nthreads, **kw)
