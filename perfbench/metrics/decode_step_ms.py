"""Decode worker: mean length of a ``decode_step`` span (host clock; the
step ends with its tokens read back, so it covers the device's work)."""


def read(run):
    d = [s["dur"] for s in run.spans if s["name"] == "decode_step"]
    return 1e3 * sum(d) / len(d) if d else None
