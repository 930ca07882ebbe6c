"""The profiler slice of a traced run and its reduction.

``torch.profiler`` traces the card's activity (kernels, copies, fills)
over the last seconds of the window, under the same load.  The slice
starts and ends with the page store's write guard held and the stream
drained, so the paged attention kernels it holds are exactly the launches
the wrappers logged between its two marks, in the same order.

Reduced to: the device's busy seconds (the union of every operation's
interval, not their sum), the slice's length, each paged attention
kind's summed bound and device time, and the breakdown (device
operations by time, idle gaps by the operation that ended them).  The
trace stays in memory; no file is written.
"""

from __future__ import annotations

import sys
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

PAGED_KERNEL = "paged_attention_kernel"


class Slice:
    def __init__(self, store, wrappers):
        self.store = store
        self.w = wrappers
        self.prof = None
        self.i0 = self.i1 = 0
        self.t0 = self.t1 = 0.0

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        with self.store.write_guard():
            torch.cuda.synchronize()
            self.prof = profile(activities=[ProfilerActivity.CUDA])
            self.prof.start()
            self.w.detail = True
            self.i0 = len(self.w.launches)
            self.t0 = time.monotonic()

    def stop(self) -> None:
        with self.store.write_guard():
            self.i1 = len(self.w.launches)
            self.w.detail = False
            torch.cuda.synchronize()
            self.t1 = time.monotonic()
            self.prof.stop()

    def reduce(self, page: int, peak: Optional[Dict[str, float]]) -> dict:
        from torch.autograd import DeviceType
        dev = [e for e in self.prof.events()
               if e.device_type == DeviceType.CUDA]
        spans = sorted((e.time_range.start, e.time_range.end, e.name)
                       for e in dev)
        busy_us, gaps = _union(spans)
        by_op: Dict[str, float] = defaultdict(float)
        for s, e, name in spans:
            by_op[name[:120]] += (e - s) / 1e6
        out = {"busy_s": busy_us / 1e6, "window_s": self.t1 - self.t0,
               "device_ops": _top(by_op), "idle_gaps": _top(gaps),
               "paged": None}
        paged = [(s, e) for s, e, name in spans if PAGED_KERNEL in name]
        logged = self.w.launches[self.i0:self.i1]
        if peak is None:
            return out
        if len(paged) != len(logged) or any(c is None for c in logged):
            print(f"perfbench: {len(paged)} paged attention kernels in the "
                  f"slice, {len(logged)} launches logged: rooflines not "
                  f"read", file=sys.stderr)
            return out
        from perfbench.bench.flops import bound_s
        per: Dict[str, Dict[str, float]] = defaultdict(
            lambda: {"bound_s": 0.0, "device_s": 0.0, "launches": 0})
        cost_of: Dict[int, Optional[float]] = {}
        for (s, e), idx in zip(paged, logged):
            if idx not in cost_of:
                c = self.w.launch_cost(idx, page)
                cost_of[idx] = (None if c is None
                                else bound_s(c["ops"], c["bytes"], peak))
            if cost_of[idx] is None:
                continue            # a forward begun before the slice
            p = per[self.w.calls[idx].kind]
            p["bound_s"] += cost_of[idx]
            p["device_s"] += (e - s) / 1e6
            p["launches"] += 1
        out["paged"] = dict(per)
        return out


def _union(spans: List[Tuple[float, float, str]]):
    """Busy microseconds of sorted (start, end, name) intervals, and the
    idle gaps between them summed by the name of the operation that ended
    each gap (seconds)."""
    busy = 0.0
    gaps: Dict[str, float] = defaultdict(float)
    cur_s = cur_e = None
    for s, e, name in spans:
        if cur_e is None:
            cur_s, cur_e = s, e
        elif s > cur_e:
            busy += cur_e - cur_s
            gaps[f"before {name[:80]}"] += (s - cur_e) / 1e6
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy, gaps


def _top(d: Dict[str, float], n: int = 10) -> List[list]:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
