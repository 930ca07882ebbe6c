"""Tracing and metrics for the serving stack.

Threads record events and latency samples **privately** (thread-local trace
buffers, thread-local histogram shards) and **publish on flush** at
safepoints, so observability adds no cross-thread traffic on the hot path.

* :class:`~repro_torch.obs.trace.Tracer` -- Chrome-trace/Perfetto JSON spans
  for the request lifecycle, SMR ping passes and block lifecycle instants.
* :class:`~repro_torch.obs.metrics.MetricsRegistry` -- log-bucketed
  histograms (p50/p99/p999/max) for TTFT, per-token latency, prefill queue
  wait, ping stall and reclaim-pass duration.
* :class:`~repro_torch.obs.slo.SLOTracker` -- SLO attainment and goodput
  accounting (SLO-meeting tokens/s, per-tenant, windowed over the run),
  plus the :class:`~repro_torch.obs.slo.TimeSeriesSampler` that exports
  gauge trajectories (queue depth, resident KV bytes, ping-stall p99) as
  time-series rows.
"""

from repro_torch.obs.metrics import Counter, Histogram, MetricsRegistry, \
    summary_keys
from repro_torch.obs.slo import SLOSpec, SLOTracker, TimeSeriesSampler, \
    engine_probes
from repro_torch.obs.trace import PID_SIM, PID_WALL, Tracer, validate_trace

__all__ = ["Counter", "Histogram", "MetricsRegistry", "PID_SIM", "PID_WALL",
           "SLOSpec", "SLOTracker", "TimeSeriesSampler", "Tracer",
           "engine_probes", "summary_keys", "validate_trace"]
