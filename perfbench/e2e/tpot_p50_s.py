"""Median over requests of each request's mean gap between output tokens
inside the window, from its token count and last-token time snapshotted
at the window's start and end.  A request counts once it made two tokens
in the window; its gaps run from its last token before the window (or
its first token in it) to its last token in it."""

from perfbench.bench.window import percentile


def read(run):
    gaps = []
    for i, (n1, last1, first1, _) in run.snap1.items():
        n0, last0 = run.snap0.get(i, (0, 0.0))[:2]
        if n1 - n0 < 2:
            continue
        if n0:
            gaps.append((last1 - last0) / (n1 - n0))
        else:
            gaps.append((last1 - first1) / (n1 - 1))
    return percentile(gaps, 0.5) if gaps else None
