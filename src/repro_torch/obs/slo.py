"""SLO attainment, goodput accounting, and time-series sampling.

Mean tok/s cannot state the paper's claim: a scheme that stalls one reader
for 200 ms can post the same mean as one that never stalls, while blowing
every latency objective it was supposed to protect.  This module scores a
load run the way a fleet operator would:

* :class:`SLOSpec` -- per-request budgets for **TTFT** (submit -> first
  token) and **per-token latency** (mean inter-token gap after the first
  token).  A request *meets SLO* iff both budgets hold.
* :class:`SLOTracker` -- streaming accounting over request completions:
  overall and per-tenant attainment, **goodput** (tokens/s counting only
  SLO-meeting requests -- the metric the ROADMAP says every PR must not
  regress), and fixed-width **windows** so a diurnal ramp or a burst shows
  up as a dip in the attainment time series, not a smeared average.
* :class:`TimeSeriesSampler` -- a background sampler polling arbitrary
  probe callables (queue depth, resident KV bytes, ping-stall percentiles)
  at a fixed interval; :func:`engine_probes` builds the standard probe set
  for a :class:`~repro_torch.serve.engine.ServeEngine`.

All tracker math is driven by caller-supplied timestamps and is exactly
reproducible; only the sampler touches the wall clock (and exposes
``sample_once`` for deterministic tests).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Callable, Dict, List, Mapping, Optional

__all__ = ["SLOSpec", "SLOTracker", "TimeSeriesSampler", "engine_probes"]


@dataclass(frozen=True)
class SLOSpec:
    """Latency budgets a request must meet to count toward goodput."""

    ttft_s: float
    tok_latency_s: float
    name: str = "default"

    def meets(self, ttft_s: float, tok_latency_s: float) -> bool:
        return ttft_s <= self.ttft_s and tok_latency_s <= self.tok_latency_s

    def to_dict(self) -> Dict:
        return {"name": self.name, "ttft_s": self.ttft_s,
                "tok_latency_s": self.tok_latency_s}


@dataclass
class _Bucket:
    requests: int = 0
    met: int = 0
    tokens: int = 0            # tokens from all finished requests
    good_tokens: int = 0       # tokens from SLO-meeting requests only


class SLOTracker:
    """Streaming SLO attainment + goodput over request completions.

    Feed one :meth:`observe` per finished request; read :meth:`summary` at
    the end.  ``window_s`` buckets completions by finish time so attainment
    is observable *over* the run (the windows ride into benchmark rows as
    the ``slo_windows`` time series).
    """

    def __init__(self, spec: SLOSpec, *, window_s: float = 0.5) -> None:
        self.spec = spec
        self.window_s = float(window_s)
        self._lock = threading.Lock()
        self._total = _Bucket()
        self._tenants: Dict[str, _Bucket] = {}
        self._windows: Dict[int, _Bucket] = {}

    def observe(self, *, t_finish_s: float, tokens: int, ttft_s: float,
                tok_latency_s: float = 0.0,
                tenant: str = "default") -> bool:
        """Record one finished request; returns whether it met the SLO.
        ``tok_latency_s`` is the request's mean inter-token gap (0.0 for
        single-token requests, which trivially meet the per-token half)."""
        met = self.spec.meets(ttft_s, tok_latency_s)
        w = int(t_finish_s / self.window_s) if self.window_s > 0 else 0
        with self._lock:
            for b in (self._total,
                      self._tenants.setdefault(tenant, _Bucket()),
                      self._windows.setdefault(w, _Bucket())):
                b.requests += 1
                b.tokens += tokens
                if met:
                    b.met += 1
                    b.good_tokens += tokens
        return met

    # -- read side --

    @property
    def requests(self) -> int:
        return self._total.requests

    @property
    def good_tokens(self) -> int:
        return self._total.good_tokens

    def attainment(self) -> float:
        """Fraction of finished requests that met the SLO (1.0 when none
        finished: an empty run violates nothing)."""
        t = self._total
        return t.met / t.requests if t.requests else 1.0

    def goodput(self, elapsed_s: float) -> float:
        """SLO-meeting tokens per second over ``elapsed_s``."""
        return self._total.good_tokens / max(elapsed_s, 1e-9)

    def per_tenant(self, elapsed_s: float) -> Dict[str, Dict[str, float]]:
        with self._lock:
            return {
                name: {
                    "requests": b.requests,
                    "attainment": b.met / b.requests if b.requests else 1.0,
                    "goodput": b.good_tokens / max(elapsed_s, 1e-9),
                }
                for name, b in sorted(self._tenants.items())
            }

    def windows(self) -> List[Dict[str, float]]:
        """Per-window attainment rows, sorted by window start time."""
        with self._lock:
            return [
                {"t_s": w * self.window_s, "requests": b.requests,
                 "attainment": b.met / b.requests if b.requests else 1.0,
                 "good_tokens": b.good_tokens, "tokens": b.tokens}
                for w, b in sorted(self._windows.items())
            ]

    def summary(self, elapsed_s: float) -> Dict:
        """The benchmark-row fragment."""
        return {
            "slo": self.spec.to_dict(),
            "slo_requests": self._total.requests,
            "slo_met": self._total.met,
            "slo_attainment": self.attainment(),
            "goodput_under_slo": self.goodput(elapsed_s),
            "tokens_out": self._total.tokens,
            "goodput_per_tenant": self.per_tenant(elapsed_s),
            "slo_windows": self.windows(),
        }


class TimeSeriesSampler:
    """Polls named probe callables on a background thread at a fixed
    interval, accumulating ``{"t_s": ..., probe: value, ...}`` rows.

    Probes are read without any engine lock -- they are gauges (queue
    depth, free blocks, resident bytes) whose instantaneous value is
    approximate by nature; a probe that raises contributes ``None`` for
    that sample rather than killing the sampler.
    """

    def __init__(self, probes: Mapping[str, Callable[[], float]], *,
                 interval_s: float = 0.25,
                 clock: Optional[Callable[[], float]] = None) -> None:
        import time as _time
        self.probes = dict(probes)
        self.interval_s = float(interval_s)
        self.samples: List[Dict[str, Optional[float]]] = []
        self._clock = clock or _time.monotonic
        self._t0 = self._clock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def sample_once(self) -> Dict[str, Optional[float]]:
        row: Dict[str, Optional[float]] = {
            "t_s": round(self._clock() - self._t0, 6)}
        for name, probe in self.probes.items():
            try:
                row[name] = float(probe())
            except Exception:
                row[name] = None
        self.samples.append(row)
        return row

    def start(self) -> "TimeSeriesSampler":
        def loop():
            while not self._stop.wait(self.interval_s):
                self.sample_once()
        self._t0 = self._clock()
        self._thread = threading.Thread(
            target=loop, name="ts-sampler", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> List[Dict[str, Optional[float]]]:
        """Stop polling, take one final sample, return all samples."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self.sample_once()
        return self.samples

    def peak(self, name: str) -> float:
        """Max observed value of one probe (0.0 if never observed)."""
        vals = [s[name] for s in self.samples if s.get(name) is not None]
        return max(vals) if vals else 0.0


def engine_probes(eng) -> Dict[str, Callable[[], float]]:
    """The standard probe set for a :class:`~repro_torch.serve.engine.ServeEngine`:
    scheduling depth, pool occupancy, resident KV bytes, and the running
    ping-stall p99 -- the gauges whose *trajectory* the fleet benchmark
    exports as each row's ``samples`` time series."""
    pool = eng.pool

    def resident_kv_bytes() -> float:
        store = getattr(eng, "kv_store", None)
        if store is not None and hasattr(store, "nbytes"):
            return float(store.nbytes)
        # dense path: one full-length cache per active request
        total = 0
        for w in eng.workers:
            per = getattr(w, "_dense_cache_bytes", 0) or 0
            total += per * len(getattr(w, "_caches", ()))
        return float(total)

    return {
        "queue_depth": lambda: float(sum(w.load for w in eng.workers)),
        "running": lambda: float(sum(len(w.running) for w in eng.workers)),
        "prefill_queue": lambda: float(
            eng.scheduler.prefill_queue.qsize()
            if getattr(eng.scheduler, "prefill_queue", None) is not None
            else 0),
        "free_blocks": lambda: float(pool.free_blocks),
        "retired_blocks": lambda: float(pool.retired_blocks),
        "resident_kv_bytes": resident_kv_bytes,
        "ping_stall_p99_s": lambda: pool.metrics.histogram(
            "ping_stall_s").percentile(0.99),
    }
