"""Scheduler and prefill, as a user sees them: the median time to first
token over every request submitted in the window, from the requests'
exact stamps.  A request without its first token at the window's end
counts with its wait up to that end, so that a stall cannot hide.  A
per-layer metric and not an end-to-end one: a window holds a few tens of
requests, and the median of so few spread 12-29% between runs of one
seed set, more than any bound the check allows."""

from perfbench.bench.window import percentile


def read(run):
    waits = []
    for s in run.sent:
        t_sub = s.req.t_submit
        if not run.t0 <= t_sub < run.t1:
            continue
        t_first = run.snap1.get(s.i, (0, 0.0, 0.0))[2]
        waits.append((t_first if t_first else run.t1) - t_sub)
    return percentile(waits, 0.5) if waits else None
