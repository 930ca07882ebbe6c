"""Publish-on-flush tracer: Chrome-trace/Perfetto JSON for the serving stack.

Threads record events into **private thread-local buffers** -- no shared
writes, no lock on the hot path -- and the buffers are **published on
flush**: explicitly via :meth:`Tracer.flush` at a safepoint, or swept all at
once by :meth:`Tracer.export` (the reclaimer-pings-everyone analogue).  This
is the paper's publish-on-ping idea applied to measurement: tracing adds no
cross-thread traffic until somebody actually wants the trace.

The output is the Chrome trace-event JSON format (the ``traceEvents`` array
object form), loadable directly in https://ui.perfetto.dev or
``chrome://tracing``.  Event phases used:

* ``X`` (complete)  -- thread-scoped spans: decode steps, prefill chunks,
  reclaim passes, SMR publish-on-ping passes and their per-reader publish
  child spans;
* ``i`` (instant)   -- block lifecycle (alloc/free/poison), first token,
  crashes;
* ``b``/``e`` (async) -- request-lifecycle span trees that cross threads
  (submit -> queue wait -> prefill -> decode -> retire), keyed by request
  id;
* ``M`` (metadata)  -- process/thread names.

**Clock domains.**  Chrome traces have one timebase per *process* (pid), so
the tracer maps each clock domain to its own pid:

* ``PID_WALL`` -- wall clock (``time.monotonic`` relative to tracer
  creation, microseconds): the real serving threads;
* ``PID_SIM``  -- simulated cycle clocks (gen + vec backends), converted at
  the repo-wide 1 GHz convention (1 cycle = 1 ns = 1e-3 us via
  :meth:`Tracer.sim_ts`): litmus/gauntlet runs and the sim-backed reclaim
  policies emit here, so a gauntlet row produces the *same* trace format as
  a live serve and both domains can coexist in one file.

Real threads get a track (tid) named after their thread name on first
event; synthetic tracks (e.g. one per SMR reader slot for the per-reader
publish spans of a ping pass) come from :meth:`tid_named`.

Disabled tracers are free: every recording method returns immediately and
``span`` hands back a shared no-op context manager, so the tracing-off
serve path allocates nothing per event (tests/test_obs.py guards this).
"""

from __future__ import annotations

import json
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

__all__ = ["Tracer", "validate_trace", "PID_WALL", "PID_SIM"]

PID_WALL = 1    # wall-clock domain (real serving threads)
PID_SIM = 2     # simulated-cycle domain (gen/vec sim engines, 1 GHz)

_PROCESS_NAMES = {PID_WALL: "serve (wall clock)",
                  PID_SIM: "sim (cycle clock, 1 GHz)"}

#: phases the exporter may emit / the validator accepts
_PHASES = {"X", "i", "b", "e", "M", "C"}


class _NullSpan:
    """Shared no-op context manager for disabled tracers."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    """Context manager emitting one X event on the current thread."""

    __slots__ = ("_tr", "_name", "_cat", "_args", "_t0")

    def __init__(self, tr: "Tracer", name: str, cat: str, args):
        self._tr = tr
        self._name = name
        self._cat = cat
        self._args = args
        self._t0 = 0.0

    def __enter__(self):
        self._t0 = self._tr.now_us()
        return self

    def __exit__(self, *exc):
        tr = self._tr
        tr.complete(self._name, self._t0, tr.now_us() - self._t0,
                    cat=self._cat, args=self._args)
        return False


class Tracer:
    """Thread-safe trace recorder with private per-thread buffers."""

    def __init__(self, enabled: bool = True) -> None:
        self.enabled = enabled
        self._t0 = time.monotonic()
        self._lock = threading.Lock()
        self._published: List[dict] = []     # flushed events + metadata
        self._tls = threading.local()
        self._buffers: List[List[dict]] = []  # every live private buffer
        self._tids: Dict[tuple, int] = {}    # (pid, track name) -> tid
        self._next_tid = 1
        self._next_async = 1
        self._meta_pids: set = set()

    # -- clocks --

    def now_us(self) -> float:
        """Wall-domain timestamp: microseconds since tracer creation."""
        return (time.monotonic() - self._t0) * 1e6

    def wall_ts(self, monotonic_s: float) -> float:
        """Convert a raw ``time.monotonic()`` reading (taken by the caller,
        e.g. before a timed region) into a wall-domain trace timestamp."""
        return (monotonic_s - self._t0) * 1e6

    @staticmethod
    def sim_ts(cycles: float) -> float:
        """Cycle-domain timestamp: simulated cycles -> microseconds at the
        repo-wide 1 GHz convention (1 cycle = 1 ns)."""
        return cycles / 1e3

    # -- track bookkeeping (one-time locked paths) --

    def _buffer(self) -> List[dict]:
        buf = getattr(self._tls, "buf", None)
        if buf is None:
            buf = []
            with self._lock:
                self._buffers.append(buf)
            self._tls.buf = buf
        return buf

    def _meta(self, event: dict) -> None:
        with self._lock:
            self._published.append(event)

    def _pid_meta(self, pid: int) -> None:
        if pid in self._meta_pids:
            return
        self._meta_pids.add(pid)
        self._meta({"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
                    "ts": 0,
                    "args": {"name": _PROCESS_NAMES.get(pid, f"pid{pid}")}})

    def tid_named(self, name: str, pid: int = PID_WALL) -> int:
        """Stable tid for a (possibly synthetic) track name, emitting the
        thread_name metadata event on first use."""
        tid = self._tids.get((pid, name))
        if tid is not None:
            return tid
        with self._lock:
            tid = self._tids.get((pid, name))
            if tid is None:
                tid = self._next_tid
                self._next_tid += 1
                self._tids[(pid, name)] = tid
        self._pid_meta(pid)
        self._meta({"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
                    "ts": 0, "args": {"name": name}})
        return tid

    def _cur_tid(self, pid: int) -> int:
        return self.tid_named(threading.current_thread().name, pid)

    def next_async_id(self) -> int:
        with self._lock:
            aid = self._next_async
            self._next_async += 1
        return aid

    # -- recording (hot paths: append to the private buffer, no lock) --

    def complete(self, name: str, ts_us: float, dur_us: float, *,
                 cat: str = "", args: Optional[dict] = None,
                 pid: int = PID_WALL, tid: Optional[int] = None) -> None:
        if not self.enabled:
            return
        ev = {"name": name, "ph": "X", "cat": cat or "default",
              "ts": ts_us, "dur": max(dur_us, 0.0), "pid": pid,
              "tid": self._cur_tid(pid) if tid is None else tid}
        if args:
            ev["args"] = args
        self._buffer().append(ev)

    def instant(self, name: str, *, cat: str = "",
                args: Optional[dict] = None, ts_us: Optional[float] = None,
                pid: int = PID_WALL, tid: Optional[int] = None) -> None:
        if not self.enabled:
            return
        ev = {"name": name, "ph": "i", "cat": cat or "default",
              "ts": self.now_us() if ts_us is None else ts_us, "s": "t",
              "pid": pid,
              "tid": self._cur_tid(pid) if tid is None else tid}
        if args:
            ev["args"] = args
        self._buffer().append(ev)

    def async_begin(self, name: str, aid: int, *, cat: str = "",
                    args: Optional[dict] = None,
                    ts_us: Optional[float] = None,
                    pid: int = PID_WALL) -> None:
        if not self.enabled:
            return
        ev = {"name": name, "ph": "b", "cat": cat or "async",
              "id": f"0x{aid:x}",
              "ts": self.now_us() if ts_us is None else ts_us,
              "pid": pid, "tid": self._cur_tid(pid)}
        if args:
            ev["args"] = args
        self._buffer().append(ev)

    def async_end(self, name: str, aid: int, *, cat: str = "",
                  args: Optional[dict] = None,
                  ts_us: Optional[float] = None,
                  pid: int = PID_WALL) -> None:
        if not self.enabled:
            return
        ev = {"name": name, "ph": "e", "cat": cat or "async",
              "id": f"0x{aid:x}",
              "ts": self.now_us() if ts_us is None else ts_us,
              "pid": pid, "tid": self._cur_tid(pid)}
        if args:
            ev["args"] = args
        self._buffer().append(ev)

    def span(self, name: str, *, cat: str = "", args: Optional[dict] = None):
        """Context manager timing a block as an X event on this thread.
        Returns a shared no-op object when disabled (zero allocation)."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, cat, args)

    # -- publish on flush --

    def flush(self) -> int:
        """Publish the calling thread's private buffer; returns # events."""
        buf = getattr(self._tls, "buf", None)
        if not buf:
            return 0
        with self._lock:
            n = len(buf)
            self._published.extend(buf)
            del buf[:n]
        return n

    def _sweep(self) -> List[dict]:
        """Publish every thread's buffer (the export-time ping-everyone)."""
        with self._lock:
            for buf in self._buffers:
                # CPython list append/slice are atomic under the GIL: we
                # take a stable prefix; events appended mid-sweep land in
                # the next sweep
                n = len(buf)
                if n:
                    self._published.extend(buf[:n])
                    del buf[:n]
            return list(self._published)

    @property
    def events(self) -> int:
        """Total recorded events (published + still in private buffers)."""
        with self._lock:
            return len(self._published) + sum(len(b) for b in self._buffers)

    def to_dict(self) -> dict:
        evs = self._sweep()
        return {"traceEvents": evs, "displayTimeUnit": "ms",
                "otherData": {"clockDomains": {
                    str(PID_WALL): "wall (us since tracer creation)",
                    str(PID_SIM): "simulated cycles at 1 GHz (us)"}}}

    def export(self, path) -> dict:
        """Write the Chrome-trace JSON object to ``path`` and return it."""
        obj = self.to_dict()
        p = Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(json.dumps(obj))
        return obj


def validate_trace(obj: Any) -> List[dict]:
    """Validate a loaded trace against the Chrome trace-event schema subset
    this tracer emits; returns the event list or raises ``ValueError``.

    Checks the object form (``traceEvents`` array), per-event required keys
    (``name``/``ph``/``ts``/``pid``/``tid``), known phases, ``dur`` on
    complete events, and ``id`` on async events -- the exact properties
    Perfetto's JSON importer needs to build span trees.
    """
    if not isinstance(obj, dict) or "traceEvents" not in obj:
        raise ValueError("trace must be the object form with 'traceEvents'")
    evs = obj["traceEvents"]
    if not isinstance(evs, list):
        raise ValueError("'traceEvents' must be a list")
    for i, ev in enumerate(evs):
        if not isinstance(ev, dict):
            raise ValueError(f"event {i} is not an object")
        for key in ("name", "ph", "ts", "pid", "tid"):
            if key not in ev:
                raise ValueError(f"event {i} ({ev.get('name')!r}) "
                                 f"missing required key {key!r}")
        ph = ev["ph"]
        if ph not in _PHASES:
            raise ValueError(f"event {i} has unknown phase {ph!r}")
        if not isinstance(ev["ts"], (int, float)):
            raise ValueError(f"event {i} ts is not numeric")
        if ph == "X" and not isinstance(ev.get("dur"), (int, float)):
            raise ValueError(f"complete event {i} ({ev['name']!r}) "
                             f"missing numeric 'dur'")
        if ph in ("b", "e") and "id" not in ev:
            raise ValueError(f"async event {i} ({ev['name']!r}) missing 'id'")
    return evs
