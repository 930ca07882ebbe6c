"""Model step: mean length of a ``prefill_chunk`` span (host clock, from
one chunk's end to the next; the chunk's device work is not waited for,
so this is the host's issue time where the device keeps up)."""


def read(run):
    d = [s["dur"] for s in run.spans if s["name"] == "prefill_chunk"]
    return 1e3 * sum(d) / len(d) if d else None
