"""Decode worker: mean rows of a decode step (the ``batch`` argument of
the program's ``decode_step`` spans)."""


def read(run):
    b = [s["args"]["batch"] for s in run.spans if s["name"] == "decode_step"]
    return sum(b) / len(b) if b else None
