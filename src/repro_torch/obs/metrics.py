"""Log-bucketed latency histograms with thread-local shards.

The paper's claims are *distribution* claims -- reservations cost nothing
until a reclaimer pings, and the ping->publish->ack window is the price of
robustness -- so scalar maxima (`PoolStats.max_ping_stall_s`, mean tok/s)
cannot state them.  This module is the measurement substrate: every latency
the serving stack cares about (TTFT, per-token latency, prefill queue wait,
ping stall, reclaim-pass duration) is recorded into a
:class:`Histogram` whose summary carries ``{count, mean, p50, p99, p999,
max}``.

The design follows the paper's own idea, applied to measurement:

* **record privately** -- ``Histogram.record`` writes into a *thread-local
  shard* (a flat bucket-count list), so concurrent workers never contend on
  a lock or a shared cache line on the hot path;
* **publish on flush** -- shards are merged into the histogram's global
  counts only when someone asks (``snapshot``/``percentile``/``merge``),
  the analogue of publishing reservations only when a reclaimer pings.

Buckets are logarithmic: 2x octaves split into ``SUBBUCKETS`` linear
sub-buckets each (~9% relative resolution at the default 8), spanning
2^-40 .. 2^20 seconds (~1 ps .. ~12 days), with exact min/max/sum kept on
the side.  Percentiles report the *upper edge* of the bucket holding the
requested rank -- a deterministic, monotone estimate (the gauntlet's
row-determinism regression relies on this), never more than one sub-bucket
above the true value.  Values are dimensionless as far as the histogram is
concerned; the serving stack records seconds, the simulator records
cycle-derived seconds at the 1 GHz convention.

``Histogram.record_locked`` is the one shared-write path: multi-thread
writers that need their sample *immediately* visible in the merged state
(the publish-on-ping pass's stall recording, where the derived
``max_ping_stall_s`` scalar must update race-free) take the histogram lock
instead of a shard.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, List, Optional

__all__ = ["Counter", "Histogram", "MetricsRegistry", "summary_keys"]

MIN_EXP = -40          # 2^-40 s ~ 1 ps: nothing we time is faster
MAX_EXP = 20           # 2^20 s ~ 12 days: nothing we time is slower
SUBBUCKETS = 8         # linear sub-buckets per 2x octave (~9% resolution)
N_BUCKETS = (MAX_EXP - MIN_EXP) * SUBBUCKETS

#: the summary fields every histogram snapshot carries, in order
summary_keys = ("count", "mean", "p50", "p99", "p999", "max")


def _bucket_of(value: float) -> int:
    """Flat bucket index of a positive value (clamped at both ends)."""
    m, e = math.frexp(value)            # value = m * 2^e, m in [0.5, 1)
    if e <= MIN_EXP:
        return 0
    if e > MAX_EXP:
        return N_BUCKETS - 1
    sub = int((m * 2.0 - 1.0) * SUBBUCKETS)   # [0, SUBBUCKETS)
    if sub >= SUBBUCKETS:                     # m == 1.0 - epsilon rounding
        sub = SUBBUCKETS - 1
    return (e - 1 - MIN_EXP) * SUBBUCKETS + sub


def _bucket_edge(index: int) -> float:
    """Upper edge of bucket ``index`` (the percentile estimate)."""
    e = index // SUBBUCKETS + MIN_EXP
    sub = index % SUBBUCKETS
    return math.ldexp(1.0 + (sub + 1) / SUBBUCKETS, e)


class _Shard:
    """One thread's private bucket counts for one histogram."""

    __slots__ = ("counts", "count", "total", "vmax", "vmin")

    def __init__(self) -> None:
        self.counts: List[int] = [0] * N_BUCKETS
        self.count = 0
        self.total = 0.0
        self.vmax = 0.0
        self.vmin = math.inf


class Histogram:
    """Log-bucketed histogram with thread-local shards merged on demand."""

    def __init__(self, name: str) -> None:
        self.name = name
        self._lock = threading.Lock()
        self._merged = _Shard()
        self._tls = threading.local()
        self._shards: List[_Shard] = []      # every live shard, for merging

    # -- hot path (no shared writes) --

    def _shard(self) -> _Shard:
        s = getattr(self._tls, "shard", None)
        if s is None:
            s = _Shard()
            with self._lock:                 # one-time per thread
                self._shards.append(s)
            self._tls.shard = s
        return s

    @staticmethod
    def _record_into(s: _Shard, value: float) -> None:
        if value <= 0.0:
            value = 0.0
            s.counts[0] += 1
        else:
            s.counts[_bucket_of(value)] += 1
        s.count += 1
        s.total += value
        if value > s.vmax:
            s.vmax = value
        if value < s.vmin:
            s.vmin = value

    def record(self, value: float) -> None:
        """Record into the calling thread's private shard (lock-free)."""
        self._record_into(self._shard(), value)

    def record_locked(self, value: float) -> float:
        """Record straight into the merged state under the histogram lock
        and return the merged max -- the one shared-write path, for samples
        whose derived aggregates (e.g. ``max_ping_stall_s``) must be
        immediately and race-free visible across threads."""
        with self._lock:
            self._record_into(self._merged, value)
            return self._merged.vmax

    # -- flush / read side --

    def merge(self) -> None:
        """Publish every thread's shard into the merged state (the flush)."""
        with self._lock:
            m = self._merged
            for s in self._shards:
                if not s.count:
                    continue
                for i, c in enumerate(s.counts):
                    if c:
                        m.counts[i] += c
                        s.counts[i] = 0
                m.count += s.count
                m.total += s.total
                if s.vmax > m.vmax:
                    m.vmax = s.vmax
                if s.vmin < m.vmin:
                    m.vmin = s.vmin
                s.count = 0
                s.total = 0.0
                s.vmax = 0.0
                s.vmin = math.inf

    def reset(self) -> None:
        """Drop every recorded sample (thread shards AND merged state).
        For the warmup/timed-window boundary in benchmarks: samples a
        concurrent recorder lands mid-reset may be dropped with them, so
        only call while recording threads are quiescent."""
        self.merge()                 # absorbs + zeroes every shard
        with self._lock:
            self._merged = _Shard()

    @property
    def count(self) -> int:
        self.merge()
        return self._merged.count

    @property
    def max(self) -> float:
        self.merge()
        return self._merged.vmax

    def percentile(self, q: float) -> float:
        """Upper-edge estimate of the q-quantile (q in [0, 1]); the exact
        max for the tail bucket, 0.0 for an empty histogram."""
        self.merge()
        m = self._merged
        if not m.count:
            return 0.0
        rank = q * m.count
        seen = 0
        for i, c in enumerate(m.counts):
            seen += c
            if seen >= rank:
                if i == 0:
                    return min(m.vmax, _bucket_edge(0))
                return min(m.vmax, _bucket_edge(i))
        return m.vmax

    def snapshot(self) -> Dict[str, float]:
        self.merge()
        m = self._merged
        return {
            "count": m.count,
            "mean": m.total / m.count if m.count else 0.0,
            "p50": self.percentile(0.50),
            "p99": self.percentile(0.99),
            "p999": self.percentile(0.999),
            "max": m.vmax,
        }


class Counter:
    """Monotonic named event counter (scheduler control-plane events:
    ``queue_reorder``, ``preemption``, ``migration``).  These fire per
    scheduling *decision*, not per token, so a plain int under a lock is
    the right cost -- the histogram shard machinery exists for the hot
    data path, not for events that happen a few times per second."""

    __slots__ = ("name", "_lock", "_n")

    def __init__(self, name: str) -> None:
        self.name = name
        self._lock = threading.Lock()
        self._n = 0

    def inc(self, n: int = 1) -> int:
        with self._lock:
            self._n += n
            return self._n

    @property
    def value(self) -> int:
        return self._n


class MetricsRegistry:
    """Named histograms + counters, created on demand, snapshot as one dict.

    One registry per serving engine (TTFT, token latency, queue wait) plus
    one per block pool (ping stall, reclaim-pass duration); ``snapshot``
    merges every shard first, so it is safe to call while workers are still
    recording -- they only ever lose the samples recorded after the merge.
    Counters live alongside (``counter``/``counters``) but stay out of
    ``snapshot``/``flat``: those emit the histogram summary-row contract
    results-file readers rely on, and a counter has no percentiles.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._hists: Dict[str, Histogram] = {}
        self._counters: Dict[str, Counter] = {}

    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            with self._lock:
                c = self._counters.get(name)
                if c is None:
                    c = Counter(name)
                    self._counters[name] = c
        return c

    def counters(self) -> Dict[str, int]:
        """Current value of every counter, as one plain dict."""
        with self._lock:
            return {name: c.value for name, c in sorted(self._counters.items())}

    def histogram(self, name: str) -> Histogram:
        h = self._hists.get(name)
        if h is None:
            with self._lock:
                h = self._hists.get(name)
                if h is None:
                    h = Histogram(name)
                    self._hists[name] = h
        return h

    def record(self, name: str, value: float) -> None:
        self.histogram(name).record(value)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._hists)

    def reset(self) -> None:
        """Reset every histogram (see :meth:`Histogram.reset`) and zero
        every counter -- the warmup/timed-window boundary."""
        for name in self.names():
            self._hists[name].reset()
        with self._lock:
            counters = list(self._counters.values())
        for c in counters:
            with c._lock:
                c._n = 0

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        return {name: self._hists[name].snapshot() for name in self.names()}

    def flat(self, names: Optional[List[str]] = None,
             fields=summary_keys) -> Dict[str, float]:
        """Flattened ``{metric}_{field}`` dict -- the benchmark-row shape
        (``ttft_p99_s`` style: callers pick names that already carry the
        unit suffix, e.g. ``ttft_s`` -> ``ttft_p99_s``).  ``count`` is a
        sample count, not a latency, so it never gets the unit suffix:
        ``ttft_s`` flattens to ``ttft_count``, ``ttft_mean_s``,
        ``ttft_p99_s``, ... -- the count/mean columns are what goodput math
        and ``benchmarks/perf_diff.py`` normalize against."""
        out: Dict[str, float] = {}
        for name in (self.names() if names is None else names):
            snap = self.histogram(name).snapshot()
            stem, suffix = (name[:-2], "_s") if name.endswith("_s") \
                else (name, "")
            for f in fields:
                if f == "count":
                    out[f"{stem}_count"] = snap[f]
                else:
                    out[f"{stem}_{f}{suffix}"] = snap[f]
        return out
