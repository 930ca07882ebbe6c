"""Device: share (%) of the profiler slice in which no operation ran on
the card (1 - the union of every device operation's interval over the
slice's length)."""


def read(run):
    p = run.profile
    if not p or not p["window_s"]:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
