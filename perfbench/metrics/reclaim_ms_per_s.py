"""Reclamation: milliseconds spent in reclamation passes per second of
the read part of the window (the pool's ``reclaim_pass_s`` histogram's
exact sum, differenced)."""


def read(run):
    return 1e3 * run.counter_delta("reclaim_pass_s") / (run.read_end - run.t0)
