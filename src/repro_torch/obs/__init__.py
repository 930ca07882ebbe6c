"""Tracing and metrics for the serving stack.

Threads record events and latency samples **privately** (thread-local trace
buffers, thread-local histogram shards) and **publish on flush** at
safepoints, so observability adds no cross-thread traffic on the hot path.

* :class:`~repro_torch.obs.trace.Tracer` -- Chrome-trace/Perfetto JSON spans
  for the request lifecycle, SMR ping passes and block lifecycle instants.
* :class:`~repro_torch.obs.metrics.MetricsRegistry` -- log-bucketed
  histograms (p50/p99/p999/max) for TTFT, per-token latency, prefill queue
  wait, ping stall and reclaim-pass duration.

SLO accounting (``obs/slo.py`` in the reference package) is ported in a
later slice.
"""

from repro_torch.obs.metrics import Counter, Histogram, MetricsRegistry, \
    summary_keys
from repro_torch.obs.trace import PID_SIM, PID_WALL, Tracer, validate_trace

__all__ = ["Counter", "Histogram", "MetricsRegistry", "PID_SIM", "PID_WALL",
           "Tracer", "summary_keys", "validate_trace"]
