#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU: build its kernels, hold
each against its plain PyTorch version, serve starcoder2-7b through the
paged runtime, and compare the slice's logits through the kernels with the
same through the plain versions.

    python3 chip_smoke.py          # from the root of a checkout, one card

Phases (any failure raises and exits non-zero; none is caught):

1. card    -- name and power limit from nvidia-smi; TF32 off for matmuls
              and cuDNN, so float32 means float32.
2. build   -- nvcc builds every kernel of ``src/repro_torch/kernels/csrc``.
3. kernels -- each kernel against its plain version at the slice's shapes
              (H=36, Hkv=4, D=128, page=16, bf16 and f32): paged attention
              within 2e-5 (f32) / 2e-2 (bf16) absolute, the scatter
              bit-exact; then timed with CUDA events beside its plain
              version, its library call where one exists, and its bound.
4. serve   -- ServeEngine(kv_store="paged", kv_storage="device") on
              starcoder2-7b at full width and depth, random bf16 weights
              from a seed: EpochPOP-pool, 2 decode engines, 1 prefill
              worker, prefix cache; no use-after-free, no leaks, poisons ==
              frees, 0 host->device KV bytes per decode step, both kernels
              launched, finite logits below the poison scale.
   profile -- the same traffic under torch.profiler: device idle share,
              launches per forward, the kernels that take the time.
5. slice   -- chunked prefill + decode steps of one prompt through the
              kernels vs through the plain versions, same weights, on the
              card: logits within 5e-2 absolute + 5e-2 relative in bf16,
              2e-4 in f32 (f32 compute and pages over the bf16 weights).

The last two lines of standard output are the kernels' JSON line and the
device JSON line.  Without CUDA it exits non-zero before printing either.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.configs import starcoder2_7b  # noqa: E402
from repro_torch.kernels import build, ref  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kernels.paged_attention import build_block_table  # noqa: E402
from repro_torch.models.model import init_params  # noqa: E402
from repro_torch.runtime.kv_store import PagedKVStore  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.serve.paged_model import (paged_decode_step,  # noqa: E402
                                           prefill_kv_chunked)

SEED = 0
HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
F32_FLOPS = 67e12                # H100 SXM, float32 outside the tensor cores
ATT_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
SLICE_TOL = 5e-2                 # bf16 logits through 32 layers

H, HKV, D, PAGE = 36, 4, 128, 16  # starcoder2-7b attention; the serve page
POOL_PAGES = 2048
DEV = "cuda"

REPLACES = {
    "paged_attention": "src/repro/kernels/paged_attention.py:118",
    "paged_scatter": "src/repro/kernels/paged_attention.py:176",
}
SOURCES = {
    "paged_attention": "src/repro_torch/kernels/csrc/paged_attention.cu",
    "paged_scatter": "src/repro_torch/kernels/csrc/paged_scatter.cu",
}


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device milliseconds of ``fn`` over ``iters`` back-to-back runs."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ----------------------------------------------------------------------------
# 1. card
# ----------------------------------------------------------------------------


def phase_card() -> str:
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    log(f"card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("tf32: torch.backends.cuda.matmul.allow_tf32=False, "
        "torch.backends.cudnn.allow_tf32=False")
    return card


# ----------------------------------------------------------------------------
# 2. build
# ----------------------------------------------------------------------------


def phase_build() -> None:
    log(f"build: {', '.join(build.KERNELS)} in {build.build_all():.1f} s")


# ----------------------------------------------------------------------------
# 3. kernels vs plain versions
# ----------------------------------------------------------------------------


def _pages(rng, dtype, n_pages=POOL_PAGES):
    k = torch.from_numpy(rng.standard_normal((n_pages, PAGE, HKV, D),
                                             np.float32)).to(DEV, dtype)
    v = torch.from_numpy(rng.standard_normal((n_pages, PAGE, HKV, D),
                                             np.float32)).to(DEV, dtype)
    return k, v


def _decode_rows(rng, lengths):
    """One row per request, each with its own distinct pages."""
    perm = rng.permutation(np.arange(1, POOL_PAGES))
    blocks, at = [], 0
    for n in lengths:
        used = -(-n // PAGE)
        blocks.append([int(b) for b in perm[at:at + used]])
        at += used
    return blocks


def _att_bound_ms(table, lengths, elem: int, B: int):
    """Least time for the work these inputs need: the live K/V token rows
    (each distinct (page, slot) once), q and out, over HBM bandwidth; vs
    4 * G * D flops per (row, kv head, live position) in float32."""
    t = table.cpu().numpy()
    n = lengths.cpu().numpy()
    live = set()
    pairs = 0
    for b in range(t.shape[0]):
        for pos in range(int(n[b])):
            pid = t[b, pos // PAGE]
            if pid >= 0:
                live.add((int(pid), pos % PAGE))
                pairs += 1
    bytes_ = (2 * len(live) * HKV * D * elem + 2 * B * H * D * 4
              + t.size * 4 + n.size * 4)
    flops = 4 * pairs * H * D
    t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S, flops / F32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def check_attention(rng, dtype):
    """Correctness cases at the slice's shapes; returns the timed decode
    case's numbers."""
    kp, vp = _pages(rng, dtype)
    scale = 1.0 / math.sqrt(D)
    tol = ATT_TOL[dtype]
    worst = 0.0

    def compare(name, q, table, lens, k=kp, v=vp):
        nonlocal worst
        got = pa.paged_attention(q, k, v, table, lens, scale=scale)
        want = ref.paged_attention_ref(q, k, v, table, lens, scale=scale)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        log(f"  paged_attention {str(dtype)[6:]} {name}: max |err| {err:.3e}"
            f" (tol {tol:g})")
        if not err <= tol:
            raise AssertionError(f"paged_attention {name} {dtype}: {err}")
        worst = max(worst, err)
        return got

    # ragged decode batch: empty row, 1 token, page + 1, multi-page rows
    lengths = [0, 1, PAGE + 1, 64, 100, 129, 200, 250]
    blocks = _decode_rows(rng, lengths)
    table, lens = build_block_table(blocks, lengths, page=PAGE, device=DEV)
    q = torch.from_numpy(rng.standard_normal((len(lengths), H, D),
                                             np.float32)).to(DEV)
    out = compare("ragged decode B=8", q, table, lens)
    if float(out[0].abs().max()) != 0.0:
        raise AssertionError("length-0 row is not exact zeros")

    # dead entries: poison every page no live entry names (page 0, the
    # TPU kernel's redirect target, included) -- result bit-identical
    live = {int(p) for p in table.flatten().tolist() if p >= 0}
    dead = torch.tensor(sorted(set(range(POOL_PAGES)) - live), device=DEV)
    kp2, vp2 = kp.clone(), vp.clone()
    kp2.index_fill_(0, dead, 1e9)
    vp2.index_fill_(0, dead, 1e9)
    wide = torch.cat([table, torch.full((table.shape[0], 3), -1,
                                        dtype=torch.int32, device=DEV)], 1)
    again = compare("dead entries poisoned", q, wide, lens, kp2, vp2)
    if not torch.equal(again, out):
        raise AssertionError("poisoned dead pages changed the result")
    del kp2, vp2

    # prefill-chunk layout: 32 rows over ONE table, positions 96..127
    prompt_blocks = _decode_rows(rng, [128])[0]
    rows = [prompt_blocks] * 32
    chunk_lens = list(range(97, 129))
    ctable, clens = build_block_table(rows, chunk_lens, page=PAGE, device=DEV)
    cq = torch.from_numpy(rng.standard_normal((32, H, D), np.float32)).to(DEV)
    compare("prefill chunk 32 rows", cq, ctable, clens)

    elem = kp.element_size()
    timed = {
        "decode": (q, table, lens),
        "prefill_chunk": (cq, ctable, clens),
    }
    times = {}
    for name, (tq, tt, tl) in timed.items():
        ms = cuda_ms(lambda: pa.paged_attention(tq, kp, vp, tt, tl,
                                                scale=scale))
        plain = cuda_ms(lambda: ref.paged_attention_ref(tq, kp, vp, tt, tl,
                                                        scale=scale))
        bound, by = _att_bound_ms(tt, tl, elem, tq.shape[0])
        times[name] = (ms, plain, bound, by)
        log(f"  paged_attention {str(dtype)[6:]} {name} B={tq.shape[0]}: "
            f"kernel {ms:.4f} ms, plain {plain:.4f} ms, bound {bound:.6f} ms "
            f"({by})")
    return worst, times


def check_scatter(rng, dtype, L=32):
    """Per-layer and all-layer writes, bit-exact against index_put_."""
    shape = (L, POOL_PAGES, PAGE, HKV, D)
    kp = torch.zeros(shape, dtype=dtype, device=DEV)
    vp = torch.zeros(shape, dtype=dtype, device=DEV)
    kr, vr = kp.clone(), vp.clone()
    T = 8
    blk = rng.choice(POOL_PAGES, T, replace=False).astype(np.int64)
    slot = rng.integers(0, PAGE, T).astype(np.int64)
    bt, st = torch.from_numpy(blk).to(DEV), torch.from_numpy(slot).to(DEV)

    def vals(*lead):
        return torch.from_numpy(rng.standard_normal((*lead, T, HKV, D),
                                                    np.float32)).to(DEV, dtype)

    kv1, vv1 = vals(), vals()
    pa.paged_scatter(kp, vp, blk, slot, kv1, vv1, layer=5)
    kr[5, bt, st] = kv1
    vr[5, bt, st] = vv1
    kvL, vvL = vals(L), vals(L)
    blk2 = rng.choice(POOL_PAGES, T, replace=False).astype(np.int64)
    b2 = torch.from_numpy(blk2).to(DEV)
    pa.paged_scatter(kp, vp, blk2, slot, kvL, vvL, layer=None)
    kr[:, b2, st] = kvL
    vr[:, b2, st] = vvL
    torch.cuda.synchronize()
    if not (torch.equal(kp, kr) and torch.equal(vp, vr)):
        raise AssertionError(f"paged_scatter {dtype} differs from index_put_")
    log(f"  paged_scatter {str(dtype)[6:]}: layer=5 and layer=None "
        f"bit-exact vs index_put_")

    # time the main path's per-layer decode write (T=8 tokens, K and V)
    ms = cuda_ms(lambda: pa.paged_scatter(kp, vp, blk, slot, kv1, vv1,
                                          layer=5))
    plain = cuda_ms(lambda: ref.paged_scatter_ref(kp, vp, bt, st, kv1, vv1,
                                                  layer=5))

    def library():
        kp[5].index_put_((bt, st), kv1)
        vp[5].index_put_((bt, st), vv1)

    lib = cuda_ms(library)
    bound = (2 * 2 * T * HKV * D * kp.element_size() + 2 * T * 4) \
        / HBM_BYTES_PER_S * 1e3
    log(f"  paged_scatter {str(dtype)[6:]} T={T} one layer: kernel "
        f"{ms:.4f} ms, plain {plain:.4f} ms, index_put_ {lib:.4f} ms, "
        f"bound {bound:.6f} ms")
    del kp, vp, kr, vr
    torch.cuda.empty_cache()
    return 0.0, (ms, plain, bound, lib)


def phase_kernels():
    rng = np.random.default_rng(SEED)
    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        results[("paged_attention", dtype)] = check_attention(rng, dtype)
        results[("paged_scatter", dtype)] = check_scatter(rng, dtype)
    torch.cuda.empty_cache()
    return results


# ----------------------------------------------------------------------------
# 4. serve starcoder2-7b
# ----------------------------------------------------------------------------


def _prompts(rng, vocab):
    """8 prompts of 64-256 tokens; the first four share a 96-token
    (6-page) prefix and differ in a tail shorter than a page, so their
    page-aligned prefix is exactly the shared one."""
    shared = rng.integers(1, vocab, 96).tolist()
    prompts = [shared + rng.integers(1, vocab, int(t)).tolist()
               for t in (5, 9, 12, 15)]
    prompts += [rng.integers(1, vocab, int(n)).tolist()
                for n in (64, 130, 200, 256)]
    return prompts


def _engine(cfg, params):
    return ServeEngine(cfg, params, kv_store="paged", kv_storage="device",
                       device=DEV, smr="EpochPOP-pool", n_engines=2,
                       prefill_workers=1, prefix_cache=True, page_size=PAGE,
                       prefill_chunk=32, num_pages=POOL_PAGES, max_batch=8)


def phase_serve(cfg, params, card: str, max_new: int = 16):
    rng = np.random.default_rng(SEED + 1)
    prompts = _prompts(rng, cfg.vocab)
    eng = _engine(cfg, params)
    pa.reset_launch_counts()
    t0 = time.monotonic()
    eng.start()
    reqs = [eng.submit(p, max_new=max_new) for p in prompts]
    for r in reqs:
        if not r.done.wait(timeout=900):
            raise AssertionError(f"request {r.rid} did not finish")
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    eng.stop()
    launches = dict(pa.launch_counts)
    if eng.error is not None:
        raise AssertionError(f"engine failed: {eng.error!r}")
    for r in reqs:
        if len(r.out) != max_new:
            raise AssertionError(f"request {r.rid}: {len(r.out)} tokens")
    pool, store = eng.pool, eng.kv_store
    pool.evict_prefixes(0)
    pool.policy.flush()
    stats = eng.kv_copy_stats()
    peak = max(w.max_abs_logit for w in eng.workers)
    checks = {
        "no leaks": pool.check_no_leaks(),
        "poisons == freed": store.poisons == pool.stats.freed,
        "freed > 0": pool.stats.freed > 0,
        "prefix hits > 0": pool.stats.prefix_hits > 0,
        "bytes_h2d_per_step == 0": stats["bytes_h2d_per_step"] == 0,
        "paged_attention launched": launches["paged_attention"] > 0,
        "paged_scatter launched": launches["paged_scatter"] > 0,
        "logits finite, below poison": (math.isfinite(peak)
                                        and peak < PagedKVStore.POISON),
    }
    for name, ok in checks.items():
        log(f"  serve check {name}: {ok}")
    if not all(checks.values()):
        raise AssertionError(f"serve checks failed: {checks}")
    tokens = sum(len(r.out) for r in reqs)
    prompt_tokens = sum(len(p) for p in prompts)
    lat = eng.metrics.snapshot().get("tok_latency_s", {})
    log(f"serve: {len(reqs)} requests, {prompt_tokens} prompt tokens "
        f"({eng.prefill_tokens} prefilled, {pool.stats.prefix_hits} prefix "
        f"hits), {tokens} generated in {wall:.2f} s wall = "
        f"{tokens / wall:.2f} generated tok/s; decode steps "
        f"{eng.steps}; inter-token p50 {1e3 * lat.get('p50', float('nan')):.2f} ms "
        f"p99 {1e3 * lat.get('p99', float('nan')):.2f} ms; max |logit| "
        f"{peak:.3f}; launches {launches}; {card}")
    return launches


def phase_profile(cfg, params, max_new: int = 16, top: int = 6):
    """The serve phase's traffic again, under torch.profiler: device busy
    time and idle share over the window, kernel launches per forward, and
    the kernels that take the device time.  A separate run, so the serve
    phase's own numbers carry no tracing cost."""
    from torch.profiler import ProfilerActivity, profile

    prompts = _prompts(np.random.default_rng(SEED + 1), cfg.vocab)
    eng = _engine(cfg, params)
    eng.start()
    pa.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        reqs = [eng.submit(p, max_new=max_new) for p in prompts]
        for r in reqs:
            if not r.done.wait(timeout=900):
                raise AssertionError(f"request {r.rid} did not finish")
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    eng.stop()
    if eng.error is not None:
        raise AssertionError(f"engine failed: {eng.error!r}")
    forwards = pa.launch_counts["paged_attention"] / cfg.n_layers

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    events = prof.key_averages()
    busy = sum(dev_us(e) for e in events) / 1e6
    launches = sum(e.count for e in events
                   if e.key in ("cudaLaunchKernel", "cuLaunchKernelEx"))
    log(f"profile: window {wall:.2f} s, device busy {busy:.3f} s, idle "
        f"share {1 - busy / wall:.4f}; {forwards:.0f} forwards, "
        f"{launches / forwards:.0f} kernel launches per forward "
        f"({launches / forwards / cfg.n_layers:.1f} per layer)")
    for e in sorted(events, key=dev_us, reverse=True)[:top]:
        log(f"  profile kernel {e.key[:60]}: {dev_us(e) / 1e3:.2f} ms "
            f"({dev_us(e) / 1e6 / busy:.4f} of busy), {e.count} launches")


# ----------------------------------------------------------------------------
# 5. slice through the kernels vs through the plain versions
# ----------------------------------------------------------------------------


def _run_slice(cfg, params, prompt, blocks, chunk, steps, impl):
    """Chunked prefill + decode steps on a fresh store; returns the logits
    rows and the host seconds per prefill chunk and per decode step (each
    ended by a sync)."""
    store = PagedKVStore(cfg, 64, PAGE, storage="device", device=DEV,
                         scatter_impl=impl)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    outs = [lg for _, lg in prefill_kv_chunked(
        params, cfg, store, blocks, prompt, chunk, impl=impl)]
    torch.cuda.synchronize()
    t1 = time.monotonic()
    tok, n = prompt[-1], len(prompt)
    for _ in range(steps):
        lg = paged_decode_step(params, cfg, store, [blocks], [n], [tok],
                               impl=impl)
        outs.append(lg)
        tok, n = int(lg[0].argmax()), n + 1
    t2 = time.monotonic()
    return (torch.cat(outs).float(), (t1 - t0) / len(range(0, len(prompt),
                                                           chunk)),
            (t2 - t1) / steps)


def phase_slice(cfg, params, n_prompt: int = 100, chunk: int = 32,
                steps: int = 4):
    """The slice through the kernels vs through the plain versions, in the
    model's bf16 and in f32 (same bf16 weights, f32 compute and pages).
    Tolerances, elementwise |a - b| <= tol + tol * |b|: bf16 5e-2 -- the
    kernels' attention agrees with the plain version to ~1e-6, but its
    bf16 rounding flips a last bit now and then, and 32 layers carry that
    on; f32 2e-4, the CPU parity tests' f32 tolerance."""
    rng = np.random.default_rng(SEED + 2)
    prompt = rng.integers(1, cfg.vocab, n_prompt).tolist()
    blocks = list(range(1, 1 + -(-(n_prompt + steps) // PAGE)))
    for dtype, tol in (("bfloat16", SLICE_TOL), ("float32", 2e-4)):
        c = cfg.scaled(dtype=dtype)
        runs = {impl: _run_slice(c, params, prompt, blocks, chunk, steps,
                                 impl) for impl in ("cuda", "torch")}
        a, b = runs["cuda"][0], runs["torch"][0]
        if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
            raise AssertionError("non-finite logits")
        diff = (a - b).abs()
        abs_err = float(diff.max())
        rel_err = float((diff / b.abs().clamp(min=1e-6)).max())
        ok = bool((diff <= tol + tol * b.abs()).all())
        agree = float((a.argmax(-1) == b.argmax(-1)).float().mean())
        log(f"slice {dtype}: {a.shape[0]} logit rows (prefill chunks of "
            f"{chunk} + {steps} decode steps), kernels vs plain: max |diff| "
            f"{abs_err:.4e}, max rel {rel_err:.4e}, max |logit| "
            f"{float(b.abs().max()):.3f}, within {tol:g} abs + {tol:g} rel: "
            f"{ok}; argmax agreement {agree:.4f}; one thread, host time per "
            f"prefill chunk / decode step: kernels "
            f"{1e3 * runs['cuda'][1]:.2f} / {1e3 * runs['cuda'][2]:.2f} ms, "
            f"plain {1e3 * runs['torch'][1]:.2f} / "
            f"{1e3 * runs['torch'][2]:.2f} ms")
        if not ok:
            raise AssertionError(f"slice {dtype} logits differ beyond "
                                 f"tolerance")


# ----------------------------------------------------------------------------


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    card = phase_card()
    phase_build()
    kres = phase_kernels()

    cfg = starcoder2_7b.CONFIG
    log(f"model: {cfg.name} layers={cfg.n_layers} d_model={cfg.d_model} "
        f"heads={cfg.n_heads}/{cfg.n_kv_heads} d_ff={cfg.d_ff} "
        f"vocab={cfg.vocab} dtype={cfg.dtype} (no depth cut)")
    t0 = time.monotonic()
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    params = init_params(cfg, gen, device=DEV)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"weights: {n_params} random bf16 parameters in "
        f"{time.monotonic() - t0:.1f} s")
    launches = phase_serve(cfg, params, card)
    phase_profile(cfg, params)
    phase_slice(cfg, params)

    kernels = []
    for name in ("paged_attention", "paged_scatter"):
        err_f32, t_f32 = kres[(name, torch.float32)]
        err_bf16, t_bf16 = kres[(name, torch.bfloat16)]
        if name == "paged_attention":
            ms, plain, bound, by = t_bf16["decode"]
            lib = None
        else:
            ms, plain, bound, lib = t_bf16
            by = "bytes"
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": max(err_f32, err_bf16), "ms": ms,
            "plain_ms": plain, "bound_ms": bound,
            "bound_by": by, "library_ms": lib,
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


if __name__ == "__main__":
    sys.exit(main())
