"""One run of one cell: set-up, the measured window, the readers, and the
output check.

The system under test is ``repro_torch``'s paged serving engine
(``ServeEngine(kv_store="paged", kv_storage="device")``), built from the
configuration's engine settings and handed the benchmark's weights; the
benchmark drives it only through ``submit`` and reads only its requests'
stamps, its spans and its counters.
"""

from __future__ import annotations

import gc
import sys
import time
from typing import Dict, List, Tuple

import torch

from perfbench.bench import check, flops, spec
from perfbench.bench.loop import ClosedLoop
from perfbench.bench.weights import make_params, same_layout
from perfbench.bench.window import Run
from perfbench.reference.model import Reference
from perfbench.traffic.mix import Mix

FIRST_TOKENS_TIMEOUT_S = 600.0
PROFILE_S = 3.0                 # the profiler slice at the traced window's end


def log(msg: str, t_start: float) -> None:
    print(f"perfbench: {msg} at {time.monotonic() - t_start:.1f} s",
          file=sys.stderr, flush=True)


def port_config(cfg_spec: dict):
    """The port's ArchConfig: its registry entry with the configuration's
    settings that the port takes as they are published."""
    from repro_torch.configs.registry import get_config, get_smoke_config
    port = cfg_spec["port"]
    get = get_smoke_config if port.get("smoke") else get_config
    return get(port["registry"]).scaled(**port.get("settings", {}))


def build_engine(cfg, params, cfg_spec: dict, device, tracer=None):
    from repro_torch.serve.engine import ServeEngine
    e = dict(cfg_spec["engine"])
    return ServeEngine(cfg, params, kv_store="paged", kv_storage="device",
                       device=device, trace=tracer, **e)


def _wait(reqs, timeout_s: float, engine) -> None:
    t_end = time.monotonic() + timeout_s
    for r in reqs:
        while not r.done.wait(0.05):
            if engine.error is not None:
                raise RuntimeError("engine failed") from engine.error
            if time.monotonic() > t_end:
                raise TimeoutError("set-up requests did not finish")


def _counters(engine) -> Dict[str, float]:
    actors = engine.workers + engine.prefill_workers
    h = engine.pool.metrics.histogram("reclaim_pass_s").snapshot()
    return {"prefill_tokens_skipped": float(sum(a.prefill_tokens_skipped
                                                for a in actors)),
            "reclaim_pass_s": h["count"] * h["mean"]}


def _spans(tracer, t_lo: float, t_hi: float) -> List[dict]:
    now = time.monotonic()
    base = now - tracer.wall_ts(now) / 1e6       # the tracer's clock origin
    out = []
    for ev in tracer.to_dict()["traceEvents"]:
        if ev.get("ph") != "X":
            continue
        t = base + ev["ts"] / 1e6
        if t_lo <= t and t + ev["dur"] / 1e6 <= t_hi:
            out.append({"name": ev["name"], "t": t, "dur": ev["dur"] / 1e6,
                        "args": ev.get("args", {})})
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def run_cell(name: str, wl: dict, cfg_spec: dict, bench: dict, *, seed: int,
             seconds: float, trace: bool, device: str, t_start: float,
             control: bool = False) -> Tuple[dict, List[Tuple[str, float, float]]]:
    """Run cell ``name`` once; returns the result line's object and the
    numbers compared, each ``(name, value, limit)``."""
    from repro_torch.models.model import abstract_params

    model = cfg_spec["model"]
    cfg = port_config(cfg_spec)
    dev = torch.device(device)
    params = make_params(model, seed, dev)
    same_layout(params, abstract_params(cfg))
    log(f"weights made ({sum(t.numel() for t in _leaves(params))} "
        f"parameters)", t_start)
    page = int(cfg_spec["engine"]["page_size"])
    traffic = wl["mix"]
    mix = Mix(traffic, model["vocab"], seed)

    tracer = wrappers = None
    if trace:
        from repro_torch.obs import Tracer
        from perfbench.bench.trace import Wrappers
        tracer = Tracer()
        wrappers = Wrappers(model)
        wrappers.install()
    engine = build_engine(cfg, params, cfg_spec, dev, tracer)
    engine.start()
    loop = None
    try:
        # warm-up: a whole chunk and a partial one, then decode steps
        chunk = int(cfg_spec["engine"]["prefill_chunk"])
        _wait([engine.submit(mix.warmup(chunk + 1), 2)], 600, engine)
        log("warm-up done", t_start)
        # shared contexts go into the prefix cache first, one request each
        _wait([engine.submit(mix.context(c), 1)
               for c in range(mix.n_contexts)], 600, engine)
        if mix.n_contexts:
            log(f"{mix.n_contexts} contexts cached", t_start)
        loop = ClosedLoop(engine, mix, traffic["clients"],
                          traffic["stagger_s"])
        loop.start()
        loop.wait_all_first(FIRST_TOKENS_TIMEOUT_S)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.monotonic()
        setup_s = t0 - t_start
        log(f"every client had its first token ({len(loop.sent)} sent); "
            "window opens", t_start)
        snap0 = loop.snapshot()
        c0 = _counters(engine)
        t1 = t0 + seconds
        prof = tp = cp = None
        if trace and dev.type == "cuda":
            from perfbench.bench.profile import Slice
            tp = max(t0, t1 - PROFILE_S)
            time.sleep(max(0.0, tp - time.monotonic()))
            cp = _counters(engine)
            prof = Slice(engine.kv_store, wrappers)
            prof.start()
            # the slice lasts PROFILE_S from its start, whatever starting
            # it took (the profiler's first start initialises CUPTI)
            tp = prof.t0
            t1 = max(t1, tp + PROFILE_S)
        time.sleep(max(0.0, t1 - time.monotonic()))
        if prof is not None:
            prof.stop()
            t1 = prof.t1
        else:
            t1 = time.monotonic()
        snap1 = loop.snapshot()
        c1 = _counters(engine)
        if trace and tp is None:
            tp, cp = t1, c1
        loop.stop()
        mem_peak = (torch.cuda.max_memory_allocated(dev)
                    if dev.type == "cuda" else 0)
        pool = engine.pool
        pages_peak = pool.num_blocks - pool.stats.free_watermark_min
        failed_engine = engine.error is not None or loop.error is not None
        h2d = engine.kv_store.bytes_h2d
    finally:
        if loop is not None:
            loop.stop()
        engine.stop()
        if wrappers is not None:
            wrappers.uninstall()

    run = Run(cell=name, model=model, page=page, t0=t0, t1=t1,
              sent=loop.sent, snap0=snap0, snap1=snap1, tp=tp)
    attempted = [s for s in loop.sent if t0 <= s.req.t_submit < t1]
    short = [s for s in attempted
             if s.i in snap1 and snap1[s.i][3] and snap1[s.i][0] < s.req.max_new]
    failed = len(attempted) if failed_engine else len(short)

    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                   "count": 1, "memory_peak_bytes": int(mem_peak)}
    metrics: Dict[str, dict] = {}
    breakdown = None
    if not trace:
        for m in spec.metrics_for(bench, "end_to_end", name):
            v = (setup_s if m["name"] == "setup_s"
                 else spec.reader("e2e", m["name"])(run))
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        run.counters = {k: {"start": c0[k], "end": cp[k]} for k in c0}
        run.spans = _spans(tracer, t0, tp)
        run.calls = wrappers.calls
        if dev.type == "cuda":
            run.peak = flops.PEAKS.get(device_info["kind"])
            run.profile = prof.reduce(page, run.peak)
            device_info["busy_s"] = run.profile["busy_s"]
            device_info["window_s"] = run.profile["window_s"]
            breakdown = {"device_ops": run.profile["device_ops"],
                         "idle_gaps": run.profile["idle_gaps"]}
        for m in spec.metrics_for(bench, "per_layer", name):
            v = spec.reader("metrics", m["name"])(run)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}

    log(f"window closed ({len(attempted)} sent in it, "
        f"{sum(1 for i, v in snap1.items() if v[0] - snap0.get(i, (0,))[0] >= 2)}"
        " with two tokens or more in it); memory peak "
        f"{mem_peak} bytes" + (f" of {torch.cuda.get_device_properties(dev).total_memory}"
                                if dev.type == "cuda" else "")
        + f"; pages out of the free list (live, cached or retired) at most "
        f"{pages_peak} of {pool.num_blocks} since the run started", t_start)
    # the program's state goes before the reference runs
    finished = [(list(s.req.prompt), list(s.req.out[:s.req.max_new]))
                for s in loop.sent
                if s.i in snap1 and snap1[s.i][0] >= s.req.max_new
                and s.req.max_new > 1]
    kv_store = engine.kv_store
    del engine, loop, run, kv_store, pool, tracer, wrappers
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    limits = cfg_spec["check"]
    pairs = check.sample(finished, int(limits["sample"]), seed)
    checks = [("engine_errors", float(failed_engine), 0.0),
              ("kv_h2d_bytes", float(h2d), 0.0),
              ("compared_tokens_min", float(sum(len(o) for _, o in pairs)),
               float(limits["min_tokens"]))]
    gap = mean = float("inf")
    if pairs:
        reference = Reference(model, params)
        if control:
            # the fp8 control in the program's place: at each served
            # position, the token the control puts first
            gap, mean, _ = check.control_gaps(
                reference, Reference(model, params, "fp8"), pairs)
        else:
            gap, mean, _ = check.served_gaps(reference, pairs)
    checks.append(("mean_logit_gap", mean, float(limits["mean_logit_gap"])))
    log(f"widest served-token gap {gap!r} (not compared)"
        + (" of the fp8 control" if control else ""), t_start)
    log("output check done", t_start)
    ok = (checks[0][1] == 0 and checks[1][1] == 0
          and checks[2][1] >= checks[2][2] and checks[3][1] <= checks[3][2])
    result = {"correct": bool(ok), "attempted": len(attempted),
              "failed": failed, "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    return result, checks


def forbidden_modules() -> List[str]:
    """Modules loaded whose top-level name is JAX's, flax's or the JAX
    package's (``repro``); ``repro_torch`` is the port and allowed."""
    bad = {"jax", "jaxlib", "flax", "repro"}
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in bad)
