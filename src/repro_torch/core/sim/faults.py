"""Fault injection for the simulator backends (the robustness gauntlet).

The paper's Assumption 1 -- a pinged thread publishes within a *bounded*
number of cycles -- is exactly what adversarial environments violate.  A
:class:`FaultPlan` describes three ways to violate it, and both backends
(:class:`~repro_torch.core.sim.engine.Engine` and
:class:`~repro_torch.core.sim.vec.VecEngine`) honor the same plan, threaded
through ``make_engine(n, faults=FaultPlan(...))``:

* **signal-delivery delay**: every ping is delayed by ``signal_delay``
  cycles plus a uniform draw in ``[0, signal_delay_jitter)`` on top of the
  cost model's base ``signal_latency``.  This stretches Assumption 1's
  bound without breaking it -- POP reclaimers block longer
  (``max_ping_stall``) but garbage stays bounded.
* **OS-desched stalls**: deterministic windows ``(tid, at, duration)``
  take a thread off the (simulated) CPU for ``duration`` cycles once its
  clock passes ``at``; stochastic stalls (``stall_prob`` per scheduling
  step, ``stall_cycles`` mean duration, optionally restricted to
  ``stall_threads``) model a noisy scheduler.  A descheduled thread
  handles no signals until it wakes -- the case where EBR's garbage grows
  without bound while the HP/POP family waits it out.
* **hard reader crashes**: ``(tid, at)`` kills the thread outright at the
  first scheduling point after its clock passes ``at`` (an op boundary on
  the gen backend, a quantum boundary on vec) -- frames dropped, store
  buffer drained (the hardware's buffer survives a thread's death),
  signals to it henceforth dropped like ``pthread_kill``'s ESRCH.  The dead thread holds
  its private (never-published) reservations forever; safe schemes must
  either recover them or provably never free what it held.

All randomness is drawn from the engine's own ``rng``, so equal seeds give
identical runs -- fault injection preserves the simulator's determinism
(and a plan with all defaults is indistinguishable from no plan at all:
engines skip every fault check when ``faults`` is None).

Synchronously *driven* code (``Engine.drive``, the serving runtime's
adaptation layer) is not subject to fault injection: drives model host OS
threads outside the simulated scheduler.  Crashing a driven engine is the
reclaim-policy seam's job (``ReclaimPolicy.on_engine_crash``), which calls
``kill_thread`` directly.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple


@dataclass(frozen=True)
class FaultPlan:
    #: deterministic extra signal-delivery delay, simulated cycles
    signal_delay: float = 0.0
    #: uniform extra delay in [0, jitter) on top of ``signal_delay``
    signal_delay_jitter: float = 0.0
    #: deterministic desched windows: (tid, at, duration) -- once the
    #: thread's clock passes ``at``, it loses ``duration`` cycles
    stalls: Tuple[Tuple[int, float, float], ...] = ()
    #: stochastic stall probability per scheduling step (gen) / compounded
    #: per quantum (vec), matching how the backends apply preempt_prob
    stall_prob: float = 0.0
    #: mean stochastic stall duration (actual draw: uniform in [0.5, 1.5]x)
    stall_cycles: float = 0.0
    #: threads eligible for stochastic stalls; None means all threads
    stall_threads: Optional[Tuple[int, ...]] = None
    #: hard crashes: (tid, at) -- thread dies at the first scheduling
    #: point after its clock passes ``at``
    crashes: Tuple[Tuple[int, float], ...] = ()

    def draw_signal_delay(self, rng) -> float:
        """Extra delivery delay for one ping (deterministic + jitter)."""
        d = self.signal_delay
        if self.signal_delay_jitter:
            d += rng.random() * self.signal_delay_jitter
        return d

    def crash_times(self) -> Dict[int, float]:
        """tid -> earliest crash time (engines consume this once at init)."""
        out: Dict[int, float] = {}
        for tid, at in self.crashes:
            t = float(at)
            if int(tid) not in out or t < out[int(tid)]:
                out[int(tid)] = t
        return out

    def stall_windows(self) -> Dict[int, List[Tuple[float, float]]]:
        """tid -> [(at, duration)] sorted by start time."""
        out: Dict[int, List[Tuple[float, float]]] = {}
        for tid, at, dur in self.stalls:
            out.setdefault(int(tid), []).append((float(at), float(dur)))
        for wins in out.values():
            wins.sort()
        return out

    def stall_eligible(self, tid: int) -> bool:
        return self.stall_threads is None or tid in self.stall_threads

    @property
    def active(self) -> bool:
        """True if the plan injects anything at all."""
        return bool(self.signal_delay or self.signal_delay_jitter
                    or self.stalls or self.stall_prob or self.crashes)
