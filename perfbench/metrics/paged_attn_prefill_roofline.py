"""Kernels: the paged attention launches of prefill forwards in the profiler
slice, their summed bound (each launch the larger of its bytes over HBM
bandwidth and its operations over the bf16 peak; each live KV slot counted
once) over their summed device time, in %."""


def read(run):
    p = (run.profile or {}).get("paged") or {}
    k = p.get("prefill")
    if not k or not k["device_s"]:
        return None
    return 100.0 * k["bound_s"] / k["device_s"]
