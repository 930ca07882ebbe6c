"""What a run records of its window, for the end-to-end and per-layer
readers: the requests with their snapshots, and (traced runs) the
program's spans and counters, the forwards the wrappers saw and the
profiler slice's reduction.

Times are ``time.monotonic()`` seconds.  ``t0``..``t1`` is the window;
in a traced run the profiler covers ``tp``..``t1`` and the spans, the
counters and the model FLOPs are read over ``t0``..``tp``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class Run:
    cell: str
    model: dict
    page: int
    t0: float
    t1: float
    sent: list                     # loop.Sent, every request of the run
    snap0: dict                    # loop.Snapshot at t0
    snap1: dict                    # ... at t1
    tp: Optional[float] = None     # profiler start (traced runs)
    spans: List[dict] = field(default_factory=list)   # name, t, dur, args
    counters: Dict[str, Dict[str, float]] = field(default_factory=dict)
    calls: list = field(default_factory=list)         # trace.Call records
    profile: Optional[dict] = None                    # profile.reduce()
    peak: Optional[Dict[str, float]] = None            # flops.PEAKS entry

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0

    @property
    def read_end(self) -> float:
        """End of the part of the window the spans and counters cover."""
        return self.tp if self.tp is not None else self.t1

    def counter_delta(self, name: str) -> float:
        c = self.counters[name]
        return c["end"] - c["start"]


def percentile(values: List[float], q: float) -> float:
    """Nearest-rank q-quantile (q in (0, 1]) of a non-empty list."""
    s = sorted(values)
    k = math.ceil(q * len(s) - 1e-9) - 1
    return s[max(0, min(len(s) - 1, k))]
