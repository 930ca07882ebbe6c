"""Robustness gauntlet: every registered SMR scheme under injected faults.

The paper's POP schemes rest on Assumption 1 -- signals are delivered and
handled in bounded time.  The gauntlet stress-tests exactly that seam, on
both simulator backends, by running each scheme through three fault modes
(``core/sim/faults.py``):

* **signal-delay** -- a sweep of extra delivery latency.  Ping-based
  schemes' ``max_ping_stall_s`` (longest reclaimer ping->all-responses
  span, seconds at the 1 GHz simulated-clock convention) must stretch with
  the injected delay; scan-based schemes stay at zero.
* **desched-stall** -- the victim reader is descheduled mid-operation for
  a tunable window while churn threads keep retiring.  EBR's
  peak-unreclaimed grows with the window (the stalled announcement pins
  every later retiree); robust schemes stay bounded -- by publication
  (HP), era skipping (HE/IBR/Hyaline), or by *blocking the reclaimer*
  until the signal lands (the POP/NBR+/DEBRA+ ping paths -- visible as a
  ``max_ping_stall_s`` roughly the stall window).
* **reader-crash** -- the victim is killed mid-operation, reservations in
  hand.  Safe schemes must either *recover* (free the backlog once pings
  return ESRCH: POP, DEBRA+, NBR+) or *never free what the dead reader
  held* (HP pins <= max_hp slots, Hyaline leaks only batches handed to the
  dead slot).  ``recovery_s`` is the time from the crash to the first free
  of a node retired before it (None = that backlog is never freed -- for
  EBR that means unbounded growth, for HP/Hyaline a bounded leak).

Every row is a pure function of (scheme, backend, fault mode, parameters,
seed): no wall-clock anywhere, so two runs with the same seed produce
identical rows -- the determinism regression test relies on this.

The victim never mutates, only reads and dereferences, so any premature
free trips the simulator's use-after-free tripwire; the ``uaf`` column
must stay False for every safe scheme and is the whole point of keeping
``HP-broken`` in the grid.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence

from repro_torch.core.sim import FaultPlan, make_engine
from repro_torch.core.sim.engine import Costs, Neutralized, ThreadCtx, UseAfterFree
from repro_torch.core.smr.registry import SCHEMES, make_scheme
from repro_torch.obs import PID_SIM, Histogram, Tracer

FAULT_MODES = ("signal-delay", "desched-stall", "reader-crash")
GHZ = 1e9   # simulated cycles -> seconds


def _fault_plan(fault_mode: str, param: float, duration: float) -> FaultPlan:
    if fault_mode == "signal-delay":
        return FaultPlan(signal_delay=param)
    if fault_mode == "desched-stall":
        # victim desched window opens a quarter into the run
        return FaultPlan(stalls=((0, duration * 0.25, param),))
    if fault_mode == "reader-crash":
        return FaultPlan(crashes=((0, param),))
    raise ValueError(f"unknown fault mode {fault_mode!r}")


def gauntlet_cell(
    scheme_name: str,
    backend: str,
    fault_mode: str,
    param: float,
    *,
    nthreads: int = 6,
    duration: float = 400_000.0,
    seed: int = 11,
    max_hp: int = 4,
    reclaim_freq: int = 16,
    epoch_freq: int = 4,
    tracer: Optional[Tracer] = None,
) -> Dict:
    """One grid cell: victim reader (tid 0, fault target) + churn threads.

    The victim repeatedly protects the shared cell's node, holds it across
    a work window, then dereferences it -- the canonical stalled-reader
    shape, with the fault layer supplying the stall/crash/delay.  Churners
    cycle nodes through their own cells (tid 1 churns the cell the victim
    reads) and retire the old ones, generating the reclamation pressure
    the metrics measure.
    """
    plan = _fault_plan(fault_mode, param, duration)
    # litmus-grade costs: stores sit in the buffer until a fence/RMW drains
    # them, so fence-elision bugs (HP-broken) stay observable under faults
    costs = Costs(drain_latency=10_000_000, drain_jitter=0, signal_latency=500)
    eng = make_engine(nthreads, backend=backend, costs=costs, seed=seed,
                      faults=plan)
    eng.jitter = 0.0
    smr = make_scheme(scheme_name, eng, max_hp=max_hp,
                      reclaim_freq=reclaim_freq, epoch_freq=epoch_freq)
    eng.set_signal_handler(smr.handler)

    cells = eng.alloc_shared(max(1, nthreads - 1))   # cell 0 shared with victim
    retired_at: Dict[int, float] = {}
    crash_at = plan.crash_times().get(0)
    rec: Dict[str, Optional[float]] = {"recovery": None}

    def on_free(t: ThreadCtx, addr: int) -> None:
        # recovery clock: first free of a node retired AFTER the crash --
        # exactly the population a dead reader's stale reservation pins
        # (pre-crash retirees may be freeable regardless, e.g. under EBR)
        ts = retired_at.pop(addr, None)
        if (crash_at is not None and rec["recovery"] is None
                and ts is not None and ts > crash_at):
            rec["recovery"] = t.now() - crash_at

    smr.free_hook = on_free

    # stall DISTRIBUTION, not just the scalar max: every timed ping->acks
    # window lands in a histogram (the paper's latency claims are
    # percentile claims), and -- when a tracer rides along -- as a
    # cycle-domain span, so a gauntlet cell emits the same trace format as
    # a live serve.  Deterministic: cycle counts in, bucket edges out.
    stall_hist = Histogram("ping_stall_s")

    def on_ping(t: ThreadCtx, t0: float, t1: float) -> None:
        stall_hist.record((t1 - t0) / GHZ)
        if tracer is not None and tracer.enabled:
            tracer.complete(
                "ping_pass", Tracer.sim_ts(t0), Tracer.sim_ts(t1 - t0),
                cat="smr", pid=PID_SIM,
                tid=tracer.tid_named(f"{scheme_name} t{t.tid}", PID_SIM),
                args={"scheme": scheme_name, "fault": fault_mode})

    smr.ping_hook = on_ping

    def victim(t: ThreadCtx):
        smr.thread_init(t)
        while t.clock < duration:
            try:
                yield from smr.start_op(t)
                x = yield from smr.read(t, 0, cells)
                if x:
                    for _ in range(8):
                        yield from t.work(50)      # hold the reservation
                    yield from t.load(x)           # deref: UAF tripwire
                yield from smr.end_op(t)
            except Neutralized:
                continue
            if not x:
                yield from t.work(50)

    def churner(t: ThreadCtx):
        smr.thread_init(t)
        cell = cells + (t.tid - 1)
        while True:
            try:
                yield from smr.start_op(t)
                node = yield from smr.alloc_node(t, 1)
                yield from t.atomic_store(cell, node)
                yield from smr.end_op(t)
            except Neutralized:
                continue
            break
        while t.clock < duration:
            try:
                yield from smr.start_op(t)
                x = yield from smr.read(t, 0, cell)
                v = yield from t.load(x)
                new = yield from smr.alloc_node(t, 1)
                t.local["pending_alloc"] = new
                yield from t.store(new, v + 1)
                yield from smr.enter_write(t, [x, new])
                yield from t.cas(cell, x, new)     # sole writer: always wins
                t.local["pending_alloc"] = None
                yield from smr.exit_write(t)
                retired_at[x] = t.now()
                yield from smr.retire(t, x)
                yield from smr.end_op(t)
                t.stats.ops += 1
            except Neutralized:
                pa = t.local.get("pending_alloc")
                if pa:
                    t.local["pending_alloc"] = None
                    yield from t.free(pa)
                continue
        yield from smr.flush(t)

    eng.spawn(0, victim)
    for tid in range(1, nthreads):
        eng.spawn(tid, churner)
    uaf = False
    try:
        eng.run(max_steps=50_000_000)
    except UseAfterFree:
        uaf = True

    recovery = rec["recovery"]
    return {
        "scheme": scheme_name,
        "sim_backend": backend,
        "fault_mode": fault_mode,
        "param": float(param),
        "nthreads": nthreads,
        "duration": duration,
        "seed": seed,
        "ops": sum(t.stats.ops for t in eng.threads),
        "retired": sum(t.stats.retired for t in eng.threads),
        "frees": smr.frees,
        "garbage_peak": smr.garbage_peak,
        "garbage_final": smr.garbage,
        "max_ping_stall_s": round(smr.max_ping_stall / GHZ, 9),
        "ping_stall_p99_s": round(stall_hist.percentile(0.99), 9),
        "ping_stalls": stall_hist.count,
        "recovery_s": None if recovery is None else round(recovery / GHZ, 9),
        "uaf": uaf,
        "restarts": sum(t.stats.restarts for t in eng.threads),
        "signals_sent": sum(t.stats.signals_sent for t in eng.threads),
    }


def run_gauntlet(
    schemes: Optional[Sequence[str]] = None,
    backends: Sequence[str] = ("gen", "vec"),
    quick: bool = False,
    seed: int = 11,
    out: Optional[str] = None,
    verbose: bool = False,
    tracer: Optional[Tracer] = None,
) -> List[Dict]:
    """The full grid: scheme x fault mode (with per-mode parameter sweeps)
    x simulator backend.  Returns one row dict per cell; ``out`` writes the
    rows as JSON under results/."""
    schemes = list(SCHEMES) if schemes is None else list(schemes)
    if quick:
        duration, nthreads = 150_000.0, 4
        delays: Sequence[float] = (0.0, 20_000.0)
    else:
        duration, nthreads = 400_000.0, 6
        delays = (0.0, 5_000.0, 20_000.0, 80_000.0)
    stall = duration * 0.5
    crash_at = duration * 0.3
    grid = [("signal-delay", d) for d in delays]
    grid.append(("desched-stall", stall))
    grid.append(("reader-crash", crash_at))

    rows: List[Dict] = []
    for backend in backends:
        for scheme in schemes:
            for fault_mode, param in grid:
                row = gauntlet_cell(
                    scheme, backend, fault_mode, param,
                    nthreads=nthreads, duration=duration, seed=seed,
                    tracer=tracer)
                rows.append(row)
                if verbose:
                    rec = row["recovery_s"]
                    print(f"{backend:3s} {scheme:14s} {fault_mode:13s} "
                          f"p={param:9.0f} gpeak={row['garbage_peak']:5d} "
                          f"stall={row['max_ping_stall_s'] * 1e6:9.1f}us "
                          f"rec={'-' if rec is None else f'{rec * 1e6:.1f}us':>10s} "
                          f"uaf={row['uaf']}")
    if out:
        path = Path(out)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(rows, indent=1))
    return rows


def summarize(rows: List[Dict]) -> Dict:
    """Headline contrasts: stall-mode peak garbage EBR vs the robust set,
    and each ping scheme's stall growth across the delay sweep."""
    out: Dict = {"uaf_schemes": sorted({r["scheme"] for r in rows if r["uaf"]})}
    for backend in sorted({r["sim_backend"] for r in rows}):
        stall_rows = {r["scheme"]: r for r in rows
                      if r["sim_backend"] == backend
                      and r["fault_mode"] == "desched-stall"}
        if "EBR" in stall_rows:
            ebr = stall_rows["EBR"]["garbage_peak"]
            out[f"{backend}/desched_peak_vs_EBR"] = {
                s: round(r["garbage_peak"] / max(1, ebr), 3)
                for s, r in sorted(stall_rows.items())}
        delay_rows = [r for r in rows if r["sim_backend"] == backend
                      and r["fault_mode"] == "signal-delay"]
        growth: Dict[str, Dict[float, float]] = {}
        p99: Dict[str, Dict[float, float]] = {}
        for r in delay_rows:
            growth.setdefault(r["scheme"], {})[r["param"]] = r["max_ping_stall_s"]
            p99.setdefault(r["scheme"], {})[r["param"]] = r.get(
                "ping_stall_p99_s", 0.0)
        out[f"{backend}/ping_stall_s_by_delay"] = {
            s: {str(int(p)): v for p, v in sorted(d.items())}
            for s, d in sorted(growth.items()) if any(d.values())}
        # the same contrast in percentiles: a scheme whose p99 stays far
        # below its max absorbs delayed signals in the tail only, while a
        # p99 tracking the max means EVERY pass pays the injected delay
        out[f"{backend}/ping_stall_p99_s_by_delay"] = {
            s: {str(int(p)): v for p, v in sorted(d.items())}
            for s, d in sorted(p99.items()) if any(d.values())}
        stall_p99 = {r["scheme"]: r.get("ping_stall_p99_s", 0.0)
                     for r in stall_rows.values()}
        if any(stall_p99.values()):
            out[f"{backend}/desched_ping_stall_p99_s"] = {
                s: v for s, v in sorted(stall_p99.items()) if v}
    return out
