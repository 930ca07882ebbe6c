"""Scheduler: mean wait from submit to first pickup (``Request.t_admitted -
t_submit``) of the requests picked up in the read part of the window."""


def read(run):
    waits = [s.req.t_admitted - s.req.t_submit for s in run.sent
             if s.req.t_admitted and run.t0 <= s.req.t_admitted < run.read_end]
    return sum(waits) / len(waits) if waits else None
