"""Deterministic, replayable workload generation for fleet-scale load tests.

The paper's headline claim is conditional -- EpochPOP approaches EBR "in the
common case where threads are not frequently delayed" -- and a conditional
claim needs *conditions you can manufacture on demand*: calm traffic, bursty
long-tailed traffic, diurnal ramps, multi-tenant mixes.  This module turns a
:class:`WorkloadSpec` into a :class:`Trace` -- a fully materialized arrival
schedule (arrival time, tenant, prompt tokens, output budget per request) --
so a load run is a pure *replay*: every stochastic draw happens here, from
one seeded ``random.Random``, and the serving fleet under test sees bit-
identical traffic across schemes, runs, and machines.

Building blocks:

* **arrival processes** -- ``"poisson"`` (exponential gaps; the calm
  baseline) and ``"gamma"`` (gamma-distributed gaps with squared
  coefficient of variation ``burstiness`` > 1: the same mean rate arriving
  in clumps separated by silence, the regime where queues actually build).
  Both are modulated by a **piecewise-linear diurnal curve** (via Lewis's
  thinning: candidates at the peak rate, accepted with probability
  ``rate(t)/rate_max``), so a trace can ramp morning->peak->trough.
* **length distributions** -- prompt and output lengths are drawn from
  per-tenant distribution specs: ``fixed``, ``lognormal`` (the classic
  long-tailed prompt shape), or ``zipf`` (power-law over a bounded range).
* **multi-tenant mixes** -- each :class:`TenantSpec` carries a weight and a
  *shared system prefix*: a fixed token run (generated once per tenant from
  the seed) prepended to every one of its prompts, so a prefix-cache-enabled
  fleet sees realistic cross-request sharing.

Serialization: ``Trace.to_json``/``from_json`` round-trip through a compact
JSON object (``{"version", "meta", "tenants", "requests"}``) so any run can
be reproduced exactly from the trace file alone -- the fleet benchmark
commits to *replaying traces*, not to re-generating them.
"""

from __future__ import annotations

import json
import random
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

__all__ = [
    "TenantSpec", "WorkloadSpec", "TraceRequest", "Trace",
    "sample_length", "generate", "replay",
]

TRACE_VERSION = 1


# ---------------------------------------------------------------------------
# length distributions
# ---------------------------------------------------------------------------

def sample_length(dist: Dict, rng: random.Random) -> int:
    """One integer draw from a distribution spec.

    Specs are plain dicts (JSON-serializable, so they ride in the trace
    meta): ``{"kind": "fixed", "value": v}``;
    ``{"kind": "lognormal", "mu": m, "sigma": s, "lo": a, "hi": b}``
    (a lognormal draw clipped into ``[lo, hi]``);
    ``{"kind": "zipf", "alpha": a, "lo": a, "hi": b}`` (P(k) proportional to
    ``1/k^alpha`` over ``lo..hi`` via inverse-CDF, so the tail is a power
    law but bounded -- every draw is servable).
    """
    kind = dist.get("kind", "fixed")
    if kind == "fixed":
        return int(dist["value"])
    if kind == "lognormal":
        v = rng.lognormvariate(float(dist["mu"]), float(dist["sigma"]))
        return int(min(max(round(v), dist["lo"]), dist["hi"]))
    if kind == "zipf":
        lo, hi, alpha = int(dist["lo"]), int(dist["hi"]), float(dist["alpha"])
        weights = [1.0 / (k ** alpha) for k in range(1, hi - lo + 2)]
        total = sum(weights)
        u = rng.random() * total
        acc = 0.0
        for i, w in enumerate(weights):
            acc += w
            if u <= acc:
                return lo + i
        return hi
    raise ValueError(f"unknown length distribution kind {kind!r}")


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class TenantSpec:
    """One traffic class: a weight in the mix, a shared system prefix, and
    prompt/output length distributions."""

    name: str
    weight: float = 1.0
    #: shared system-prompt tokens prepended to every prompt of this tenant
    #: (page-align it for zero-copy prefix-cache hits on the paged path)
    system_prefix: int = 0
    prompt_len: Dict = field(
        default_factory=lambda: {"kind": "fixed", "value": 8})
    output_len: Dict = field(
        default_factory=lambda: {"kind": "fixed", "value": 4})

    def to_dict(self) -> Dict:
        return {"name": self.name, "weight": self.weight,
                "system_prefix": self.system_prefix,
                "prompt_len": dict(self.prompt_len),
                "output_len": dict(self.output_len)}

    @classmethod
    def from_dict(cls, d: Dict) -> "TenantSpec":
        return cls(name=d["name"], weight=float(d["weight"]),
                   system_prefix=int(d["system_prefix"]),
                   prompt_len=dict(d["prompt_len"]),
                   output_len=dict(d["output_len"]))


@dataclass(frozen=True)
class WorkloadSpec:
    """Everything :func:`generate` needs; serialized into the trace meta."""

    duration_s: float
    seed: int
    tenants: Tuple[TenantSpec, ...]
    #: arrival process: "poisson" (calm) or "gamma" (bursty)
    process: str = "poisson"
    #: mean arrival rate, requests/second (before the diurnal multiplier)
    rate_rps: float = 20.0
    #: gamma process: squared coefficient of variation of the gaps (> 1 =
    #: bursty; 1 degenerates to poisson).  Ignored for "poisson".
    burstiness: float = 4.0
    #: piecewise-linear diurnal curve: (time_fraction, rate_multiplier)
    #: knots over [0, 1] x (0, inf); empty = flat rate
    diurnal: Tuple[Tuple[float, float], ...] = ()
    #: token id range for generated prompts: ids in [1, vocab)
    vocab: int = 64

    def rate_at(self, t_s: float) -> float:
        """Instantaneous arrival rate at ``t_s`` (diurnal-modulated)."""
        if not self.diurnal:
            return self.rate_rps
        x = min(max(t_s / self.duration_s, 0.0), 1.0)
        knots = sorted(self.diurnal)
        if x <= knots[0][0]:
            return self.rate_rps * knots[0][1]
        for (x0, m0), (x1, m1) in zip(knots, knots[1:]):
            if x <= x1:
                f = 0.0 if x1 == x0 else (x - x0) / (x1 - x0)
                return self.rate_rps * (m0 + f * (m1 - m0))
        return self.rate_rps * knots[-1][1]

    @property
    def rate_max(self) -> float:
        if not self.diurnal:
            return self.rate_rps
        return self.rate_rps * max(m for _, m in self.diurnal)

    def to_dict(self) -> Dict:
        return {"duration_s": self.duration_s, "seed": self.seed,
                "process": self.process, "rate_rps": self.rate_rps,
                "burstiness": self.burstiness,
                "diurnal": [list(k) for k in self.diurnal],
                "vocab": self.vocab}

    @classmethod
    def from_dict(cls, d: Dict, tenants: Tuple[TenantSpec, ...]) -> "WorkloadSpec":
        return cls(duration_s=float(d["duration_s"]), seed=int(d["seed"]),
                   tenants=tenants, process=d["process"],
                   rate_rps=float(d["rate_rps"]),
                   burstiness=float(d["burstiness"]),
                   diurnal=tuple(tuple(k) for k in d["diurnal"]),
                   vocab=int(d["vocab"]))


# ---------------------------------------------------------------------------
# trace
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class TraceRequest:
    t_s: float                  # arrival offset from trace start, seconds
    tenant: str
    prompt: Tuple[int, ...]
    max_new: int


@dataclass
class Trace:
    """A materialized arrival schedule plus the spec that produced it."""

    meta: Dict
    tenants: List[Dict]
    requests: List[TraceRequest]

    # -- derived views --

    @property
    def duration_s(self) -> float:
        return float(self.meta["duration_s"])

    @property
    def offered_rps(self) -> float:
        return len(self.requests) / max(self.duration_s, 1e-9)

    def tokens_in(self) -> int:
        return sum(len(r.prompt) for r in self.requests)

    def tokens_out_budget(self) -> int:
        return sum(r.max_new for r in self.requests)

    # -- serialization (compact: one row per request) --

    def to_json(self) -> str:
        names = [t["name"] for t in self.tenants]
        idx = {n: i for i, n in enumerate(names)}
        rows = [[round(r.t_s, 6), idx[r.tenant], r.max_new, list(r.prompt)]
                for r in self.requests]
        return json.dumps({"version": TRACE_VERSION, "meta": self.meta,
                           "tenants": self.tenants, "requests": rows})

    @classmethod
    def from_json(cls, text: str) -> "Trace":
        obj = json.loads(text)
        if obj.get("version") != TRACE_VERSION:
            raise ValueError(
                f"unsupported trace version {obj.get('version')!r}")
        names = [t["name"] for t in obj["tenants"]]
        reqs = [TraceRequest(t_s=float(t), tenant=names[ti],
                             prompt=tuple(prompt), max_new=int(mn))
                for t, ti, mn, prompt in obj["requests"]]
        return cls(meta=obj["meta"], tenants=obj["tenants"], requests=reqs)

    def save(self, path) -> None:
        Path(path).write_text(self.to_json())

    @classmethod
    def load(cls, path) -> "Trace":
        return cls.from_json(Path(path).read_text())


# ---------------------------------------------------------------------------
# generation
# ---------------------------------------------------------------------------

def _arrivals(spec: WorkloadSpec, rng: random.Random) -> List[float]:
    """Arrival offsets in [0, duration): the chosen process at the diurnal
    rate, via thinning against the curve's peak rate."""
    out: List[float] = []
    t = 0.0
    rmax = spec.rate_max
    if rmax <= 0:
        return out
    while True:
        if spec.process == "poisson":
            gap = rng.expovariate(rmax)
        elif spec.process == "gamma":
            # shape k = 1/burstiness, scale = burstiness/rate: mean 1/rate,
            # CV^2 = burstiness (k < 1 clumps arrivals into bursts)
            k = 1.0 / max(spec.burstiness, 1e-9)
            gap = rng.gammavariate(k, spec.burstiness / rmax)
        else:
            raise ValueError(f"unknown arrival process {spec.process!r}")
        t += gap
        if t >= spec.duration_s:
            return out
        # thinning: accept with probability rate(t)/rate_max
        if spec.diurnal and rng.random() > spec.rate_at(t) / rmax:
            continue
        out.append(t)


def _system_prefix(spec: WorkloadSpec, tenant: TenantSpec) -> Tuple[int, ...]:
    """The tenant's shared system-prompt tokens: a pure function of
    (seed, tenant name), so every request of the tenant -- in this trace or
    a regenerated one -- shares the identical prefix."""
    if not tenant.system_prefix:
        return ()
    rng = random.Random(f"{spec.seed}:system-prefix:{tenant.name}")
    return tuple(rng.randrange(1, spec.vocab)
                 for _ in range(tenant.system_prefix))


def generate(spec: WorkloadSpec) -> Trace:
    """Materialize the spec into a trace.  Every draw comes from ONE seeded
    ``random.Random(spec.seed)`` (plus the per-tenant prefix streams, which
    are pure functions of the seed), so equal specs give bit-equal traces."""
    if not spec.tenants:
        raise ValueError("need at least one tenant")
    rng = random.Random(spec.seed)
    prefixes = {t.name: _system_prefix(spec, t) for t in spec.tenants}
    weights = [t.weight for t in spec.tenants]
    reqs: List[TraceRequest] = []
    for t_s in _arrivals(spec, rng):
        tenant = rng.choices(spec.tenants, weights=weights)[0]
        plen = sample_length(tenant.prompt_len, rng)
        out = max(1, sample_length(tenant.output_len, rng))
        user = tuple(rng.randrange(1, spec.vocab) for _ in range(max(plen, 1)))
        reqs.append(TraceRequest(
            t_s=round(t_s, 6), tenant=tenant.name,
            prompt=prefixes[tenant.name] + user, max_new=out))
    return Trace(meta=spec.to_dict(),
                 tenants=[t.to_dict() for t in spec.tenants],
                 requests=reqs)


# ---------------------------------------------------------------------------
# replay
# ---------------------------------------------------------------------------

def replay(trace: Trace, submit: Callable[[TraceRequest], object], *,
           time_scale: float = 1.0,
           clock: Callable[[], float] = None,
           sleep: Callable[[float], None] = None,
           stop: Optional[Callable[[], bool]] = None) -> List[object]:
    """Drive ``submit`` through the trace's arrival schedule in real time
    (``time_scale`` stretches/compresses it: 2.0 = half speed).  Arrivals
    the replayer is late for fire immediately -- open-loop load, the
    generator never waits for the fleet.  Returns ``submit``'s results in
    arrival order.  ``clock``/``sleep`` are injectable for tests."""
    import time as _time

    clock = clock or _time.monotonic
    sleep = sleep or _time.sleep
    t0 = clock()
    out: List[object] = []
    for r in sorted(trace.requests, key=lambda r: r.t_s):
        if stop is not None and stop():
            break
        due = t0 + r.t_s * time_scale
        delay = due - clock()
        if delay > 0:
            sleep(delay)
        out.append(submit(r))
    return out
