#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU: build its kernels, hold
each against its plain PyTorch version, serve starcoder2-7b through the
paged runtime (under the native policy, under every SMR scheme of the
registry, and replaying a multi-tenant trace), run zamba2-2.7b's and
rwkv6-1.6b's dense prefill through the flash-attention and linear-scan
kernels, serve zamba2-2.7b densely, run olmoe-1b-7b's MoE model end to
end, and compare every path's logits through the kernels with the same
through the plain versions; beside them, on the host, the paper's
data-structure grid and robustness gauntlet.

    python3 chip_smoke.py          # from the root of a checkout, one card

Phases (any failure raises and exits non-zero; none is caught):

1. card    -- name and power limit from nvidia-smi; TF32 off for matmuls
              and cuDNN, so float32 means float32.
2. build   -- nvcc builds every kernel of ``src/repro_torch/kernels/csrc``,
              one process per source, all at once; ptxas's registers and
              spills of each flash, paged-attention and scan instantiation;
              the wrappers' shared-memory sums against the sources' own.
3. kernels -- each kernel against its plain version at its main path's
              shapes, bf16 and f32, elementwise |a - b| <= tol + tol |b|:
              paged attention (H=36, Hkv=4, D=128, page=16: a ragged decode
              batch with a length-0 row, poisoned dead pages in a wider
              table, a 32-row prefill chunk, and a long-context batch of 7
              rows of 2048-4096 tokens and one of 8192) and flash
              attention (zamba2's prefill B=4, S=2048, H=Hkv=32, D=80,
              causal; a gemma2 local layer B=1, S=8192, H=32, Hkv=16,
              D=128, window 4096, softcap 50; and the small edge cases of
              ``FLASH_EDGE_CASES``) within 2e-5 (f32) / 2e-2 (bf16); the
              scatter bit-exact through numpy indices and through a
              prepared index, and timed both ways beside two index_put_
              calls; the linear scan (mamba2 B=4,
              S=2048, H=80, K=Vd=64, scalar decay, chunk 128; rwkv6 B=4,
              S=2048, H=32, K=Vd=64, vector decay + bonus, chunk 32; and
              ``SCAN_EDGE_CASES``: S off the chunk, the 75 clamp active)
              within 2e-4 / 5e-2, and in f32 against the exact oracle at
              S=512.  Then each timed with CUDA events beside its plain
              version, its library call where one exists, and its bound;
              paged attention and the scan also by their kernels' device
              time per launch (torch.profiler), apart from the wrapper's
              host work.
4. serve   -- ServeEngine(kv_store="paged", kv_storage="device") on
              starcoder2-7b at full width and depth, random bf16 weights
              from a seed: EpochPOP-pool, 2 decode engines, 1 prefill
              worker, prefix cache; no use-after-free, no leaks, poisons ==
              frees, 0 host->device KV bytes per decode step, both kernels
              launched, finite logits below the poison scale.
   smr serve -- the same traffic at 8 new tokens under every safe scheme
              of the SMR registry (SimulatedSMRPolicy, ``gen`` backend)
              and HazardPtrPOP and EpochPOP on ``vec``, each run a process
              of its own (``chip_smoke.py --smr-run SCHEME BACKEND``), four
              at a time: the same checks (NR: nothing freed), one line per
              run with tok/s, inter-token p50/p99, frees, pings,
              publishes, the largest ping stall and the policy's host
              time per decode step.
   fleet replay -- a trace of fleet_load.py's tenant mix (Poisson, 0.5
              requests/s for 16 s) replayed in real time under
              EpochPOP-pool, HazardPtrPOP, EpochPOP, HP and EBR, scored
              against MLPerf's Llama-2-70B server limits (TTFT 2 s, 200 ms
              per token): attainment, goodput, TTFT p50/p99, the largest
              ping stall; no use-after-free.
   profile -- the same traffic under torch.profiler: device idle share,
              kernel launches and copies per forward, the kernels that
              take the time.
5. slice   -- chunked prefill + decode steps of one prompt through the
              kernels vs through the plain versions, same weights, on the
              card: logits within 5e-2 absolute + 5e-2 relative in bf16,
              2e-4 in f32 (f32 compute and pages over the bf16 weights).
   prefill_kv -- one 512-token prompt through the full-sequence prefill
              (flash) into pages, against the chunked paged prefill's pages.
6. dense   -- zamba2-2.7b at full width and depth: make_prefill_step on 4
              prompts x 2048 tokens through the kernels (9 flash calls and
              54 scan calls, of three launches each, per prefill) vs the
              plain versions, in bf16 and
              f32 compute; the prefill cache grafted into init_cache and 8
              decode steps against the train-mode forward; 8 greedy
              make_serve_step steps; then rwkv6-1.6b's prefill of 2 x 2048
              through the vector-decay scan vs the plain version.
   dense serve -- ServeEngine(kv_store="dense") on zamba2-2.7b:
              EpochPOP-pool, 2 decode engines, prefix cache, 6 requests;
              no use-after-free, no leaks, prefix hits.
   profile -- the zamba2 prefill under torch.profiler.
7. structures -- host work in a process of its own (``chip_smoke.py
              --structures``), started before the build and joined after
              the kernels phase: the paper's throughput grid (HML, LL,
              HMHT, DGT x read/update x PAPER_SET, 8 threads, key range
              128, 300k cycles, seed 7, ``vec``), one line per structure
              and mix with each scheme's throughput in simulator units and
              the HazardPtrPOP/HP, HazardPtrPOP/HPAsym, HazardEraPOP/HE,
              EpochPOP/EBR ratios; ``run_gauntlet(quick=True)`` on ``gen``
              and ``vec``.  No use-after-free by a safe scheme; HP-broken
              the only scheme that trips, on ``gen`` in every fault mode;
              a trial and a gauntlet cell repeated give identical rows.
8. olmoe   -- olmoe-1b-7b at full width and depth (16 layers, 64 experts
              top-8): make_prefill_step on 4 x 2048 tokens through the
              kernels (16 flash launches) vs the plain versions in bf16 and
              f32, with the MoE routing of the plain f32 run replayed in
              the others (a perturbation of the kernels' size flips
              near-ties of the discrete routing; the flips and the
              unpinned distances are printed); two more bf16 prefills
              bit-equal to the first; decode
              steps after a prefill vs the train-mode forward (experts
              dropless in both); one MoE layer timed beside its bound; the
              MoE share of the prefill's device time (torch.profiler);
              prefill and decode times and peak memory; dense serving of
              the zamba2 traffic; the paged path's ValueError.

The last two lines of standard output are the kernels' JSON line and the
device JSON line.  Without CUDA it exits non-zero before printing either.
"""

from __future__ import annotations

import ctypes
import dataclasses
import gc
import json
import math
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.configs import (olmoe_1b_7b, rwkv6_1p6b,  # noqa: E402
                                 starcoder2_7b, zamba2_2p7b)
from repro_torch.core.gauntlet import (gauntlet_cell,  # noqa: E402
                                       run_gauntlet, summarize)
from repro_torch.core.smr.registry import PAPER_SET  # noqa: E402
from repro_torch.core.workload import STRUCTURES, run_trial  # noqa: E402
from repro_torch.kernels import build, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import linear_scan as ls  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kernels.paged_attention import build_block_table  # noqa: E402
from repro_torch.models import model as model_mod  # noqa: E402
from repro_torch.models.model import (apply_model, init_cache,  # noqa: E402
                                      init_params, layer_params)
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models.moe import apply_moe, capacity  # noqa: E402
from repro_torch.obs import SLOSpec, SLOTracker  # noqa: E402
from repro_torch.runtime.kv_store import PagedKVStore  # noqa: E402
from repro_torch.runtime.reclaim import supported_schemes  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.serve.loadgen import (TenantSpec, WorkloadSpec,  # noqa: E402
                                       generate, replay)
from repro_torch.serve.paged_model import (paged_decode_step,  # noqa: E402
                                           prefill_kv, prefill_kv_chunked)
from repro_torch.train.train_step import (make_prefill_step,  # noqa: E402
                                          make_serve_step)

SEED = 0
HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
# peak operation rates for the work's type (H100 SXM data sheet, dense):
# bf16 on the tensor cores, float32 outside them
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
ATT_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
SCAN_TOL = {torch.float32: 2e-4, torch.bfloat16: 5e-2}
SLICE_TOL = 5e-2                 # bf16 logits through 32 layers

H, HKV, D, PAGE = 36, 4, 128, 16  # starcoder2-7b attention; the serve page
POOL_PAGES = 2048
# the long-context decode rows (1824 pages of the pool)
LONG_ROWS = [2048, 2560, 3072, 3584, 4096, 2304, 3328, 8192]
DEV = "cuda"

REPLACES = {
    "paged_attention": "src/repro/kernels/paged_attention.py:118",
    "paged_scatter": "src/repro/kernels/paged_attention.py:176",
    "flash_attention": "src/repro/kernels/flash_attention.py:94",
    "linear_scan": "src/repro/kernels/linear_scan.py:81",
}
SOURCES = {name: f"src/repro_torch/kernels/csrc/{name}.cu"
           for name in REPLACES}


def log(msg: str) -> None:
    print(msg, flush=True)


def within(a: torch.Tensor, b: torch.Tensor, tol: float):
    """(max |a - b|, whether |a - b| <= tol + tol |b| everywhere)."""
    a, b = a.float(), b.float()
    diff = (a - b).abs()
    return float(diff.max()), bool((diff <= tol + tol * b.abs()).all())


def bound_ms(bytes_: float, flops: float, dtype):
    """Least time for the work: bytes over HBM bandwidth vs operations over
    the peak rate for their type; returns (ms, what bounds it)."""
    t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def free_cuda() -> None:
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


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


def _card() -> str:
    """The card's name and power limit; TF32 off for matmuls and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def phase_card() -> str:
    card = _card()
    log(f"card: {card}")
    log("tf32: torch.backends.cuda.matmul.allow_tf32=False, "
        "torch.backends.cudnn.allow_tf32=False")
    return card


# ----------------------------------------------------------------------------
# 2. build
# ----------------------------------------------------------------------------


_PTXAS_KERNELS = re.compile(
    r"(flash_[a-z0-9]+_kernel|paged_attention_kernel|scan_state_mma|"
    r"scan_out_mma|scan_state_f32|scan_out_f32|scan_state_pass)")


def _ptxas_name(line: str):
    """``kernel<args>`` from ptxas's mangled entry name: the element type
    (bf16 / f32) and the integer and bool template arguments."""
    m = _PTXAS_KERNELS.search(line)
    if m is None:
        return None
    tmpl = line[m.end():].split("Ev", 1)[0]
    args = []
    if tmpl.startswith("I13__nv_bfloat16"):
        args.append("bf16")
    elif tmpl.startswith("If"):
        args.append("f32")
    args += re.findall(r"L[ib](\d+)E", tmpl)
    return m.group(1) + (f"<{','.join(args)}>" if args else "")


def phase_build() -> None:
    log(f"build: {', '.join(build.KERNELS)} in {build.build_all():.1f} s")
    # ptxas -v of the flash, paged-attention and scan instantiations:
    # registers and spills
    for kernel in ("flash_attention", "paged_attention", "linear_scan"):
        name = None
        for line in build.build_logs.get(kernel, "").splitlines():
            if "Compiling entry function" in line:
                name = _ptxas_name(line)
            elif name and ("registers" in line or "spill" in line):
                log(f"  ptxas {name}: {line.split('info    :')[-1].strip()}")
    check_smem_mirrors()


def check_smem_mirrors() -> None:
    """The wrappers' shared-memory sums (checked against the card's limit
    before a launch) against the sources' own, at the main paths' shapes
    and a few others."""
    c_int = ctypes.c_int
    pa_fn = build.load("paged_attention").paged_attention_smem_bytes
    pa_fn.argtypes, pa_fn.restype = [c_int] * 3, ctypes.c_longlong
    ls_fn = build.load("linear_scan").linear_scan_smem_bytes
    ls_fn.argtypes, ls_fn.restype = [c_int] * 6, ctypes.c_longlong
    n = 0
    for code, dtype in ((0, torch.float32), (1, torch.bfloat16)):
        for G, D in ((9, 128), (3, 32), (1, 64), (8, 128)):
            got, want = pa_fn(code, G, D), pa.smem_bytes(dtype, G, D)
            if got != want:
                raise AssertionError(f"paged smem {dtype} G={G} D={D}: "
                                     f"source {got}, wrapper {want}")
            n += 1
        for K, Vd, Kd, L, bonus in ((64, 64, 1, 128, False),
                                    (64, 64, 64, 32, True),
                                    (32, 48, 32, 32, True),
                                    (16, 24, 1, 32, False),
                                    (32, 32, 1, 64, True)):
            got = ls_fn(code, K, Vd, Kd, L, int(bonus))
            want = ls.smem_bytes(K, Vd, Kd, L, bonus, dtype)
            if got != want:
                raise AssertionError(f"scan smem {dtype} {(K, Vd, Kd, L)}: "
                                     f"source {got}, wrapper {want}")
            n += 1
    log(f"  shared memory: the wrappers' sums equal the sources' at {n} "
        f"shapes")


def device_ms(fn, names, calls: int = 20):
    """Device milliseconds per call of ``fn`` of the kernels whose names
    contain one of ``names``, from torch.profiler's kernel times (the
    wrapper's host work excluded), and each kernel's share:
    ``(total, {kernel: ms per call})``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    per = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and any(n in e.key
                                                    for n in names):
            key = re.sub(r"^void |\(anonymous namespace\)::|\(.*$", "",
                         e.key)
            per[key] = per.get(key, 0.0) + _dev_us(e) / 1e3 / calls
    if not per:
        raise AssertionError(f"the profiler saw no kernel named {names}")
    return sum(per.values()), per


def _dev_us(e) -> float:
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


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


def _att_bound_ms(table, lengths, elem: int, B: int, dtype):
    """Least time for the work these inputs need: the live K/V token rows
    (each distinct (page, slot) once), q and out, over HBM bandwidth; vs
    4 * G * D flops per (row, kv head, live position) at the pages' type's
    peak rate."""
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
    return bound_ms(bytes_, 4 * pairs * H * D, dtype)


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

    # long context, where the split over pages matters most: 7 rows of
    # 2048-4096 tokens and one of 8192, each split over up to 64 units
    long_lens = LONG_ROWS
    ltable, llens = build_block_table(_decode_rows(rng, long_lens),
                                      long_lens, page=PAGE, device=DEV)
    lq = torch.from_numpy(rng.standard_normal((len(long_lens), H, D),
                                              np.float32)).to(DEV)
    compare(f"long context B={len(long_lens)} up to {max(long_lens)} "
            f"tokens", lq, ltable, llens)

    elem = kp.element_size()
    timed = {
        "decode": (q, table, lens),
        "prefill_chunk": (cq, ctable, clens),
        "long_context": (lq, ltable, llens),
    }
    times = {}
    for name, (tq, tt, tl) in timed.items():
        ms = cuda_ms(lambda: pa.paged_attention(tq, kp, vp, tt, tl,
                                                scale=scale))
        dev, _ = device_ms(lambda: pa.paged_attention(tq, kp, vp, tt, tl,
                                                      scale=scale),
                           ("paged_attention_kernel",))
        plain = cuda_ms(lambda: ref.paged_attention_ref(tq, kp, vp, tt, tl,
                                                        scale=scale),
                        *((10, 2) if name == "long_context" else ()))
        bound, by = _att_bound_ms(tt, tl, elem, tq.shape[0], dtype)
        times[name] = (ms, plain, bound, by, dev)
        plan = pa.split_plan(tq.shape[0], HKV, tt.shape[1],
                             torch.cuda.get_device_properties(0)
                             .multi_processor_count)
        log(f"  paged_attention {str(dtype)[6:]} {name} B={tq.shape[0]}: "
            f"kernel {ms:.4f} ms (event time of a wrapper call), device "
            f"{dev:.4f} ms a launch (profiler), plain {plain:.4f} ms, bound "
            f"{bound:.6f} ms ({by}); {plan.n_splits} splits a (row, kv head)")
    return worst, times


def check_scatter(rng, dtype, L=32):
    """Per-layer and all-layer writes, through numpy indices and through a
    prepared index, bit-exact against index_put_; then the main path's
    per-layer decode write timed three ways: numpy indices (index built and
    uploaded per call), a prepared index (built once, as a forward does),
    and two index_put_ calls with device indices."""
    shape = (L, POOL_PAGES, PAGE, HKV, D)
    kp = torch.zeros(shape, dtype=dtype, device=DEV)
    vp = torch.zeros(shape, dtype=dtype, device=DEV)
    kr, vr = kp.clone(), vp.clone()
    pa.check_scatter_pools(kp, vp)
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
    # the prepared index, reused as a forward reuses it for every layer
    index = pa.scatter_index(blk, slot, num_blocks=POOL_PAGES, page=PAGE,
                             device=DEV)
    kv7, vv7 = vals(), vals()
    for layer in (7, 9):
        pa.paged_scatter_indexed(kp, vp, index, kv7, vv7, layer=layer)
        kr[layer, bt, st] = kv7
        vr[layer, bt, st] = vv7
    index2 = pa.scatter_index(blk2, slot, num_blocks=POOL_PAGES, page=PAGE,
                              device=DEV)
    kvL, vvL = vals(L), vals(L)
    pa.paged_scatter_indexed(kp, vp, index2, kvL, vvL, layer=None)
    kr[:, b2, st] = kvL
    vr[:, b2, st] = vvL
    torch.cuda.synchronize()
    if not (torch.equal(kp, kr) and torch.equal(vp, vr)):
        raise AssertionError(f"paged_scatter {dtype} differs from index_put_")
    log(f"  paged_scatter {str(dtype)[6:]}: numpy indices (layer=5, "
        f"layer=None) and a prepared index (layers 7 and 9 from one index, "
        f"layer=None) bit-exact vs index_put_")

    # time the main path's per-layer decode write (T=8 tokens, K and V)
    numpy_ms = cuda_ms(lambda: pa.paged_scatter(kp, vp, blk, slot, kv1, vv1,
                                                layer=5))
    ms = cuda_ms(lambda: pa.paged_scatter_indexed(kp, vp, index, kv1, vv1,
                                                  layer=5))
    plain = cuda_ms(lambda: ref.paged_scatter_ref(kp, vp, bt, st, kv1, vv1,
                                                  layer=5))

    def library():
        kp[5].index_put_((bt, st), kv1)
        vp[5].index_put_((bt, st), vv1)

    lib = cuda_ms(library)
    bound = (2 * 2 * T * HKV * D * kp.element_size() + 2 * T * 4) \
        / HBM_BYTES_PER_S * 1e3
    log(f"  paged_scatter {str(dtype)[6:]} T={T} one layer: prepared index "
        f"{ms:.4f} ms, numpy indices {numpy_ms:.4f} ms, plain {plain:.4f} "
        f"ms, index_put_ x2 {lib:.4f} ms, bound {bound:.6f} ms; prepared "
        f"no slower than index_put_ x2: {ms <= lib}")
    del kp, vp, kr, vr
    torch.cuda.empty_cache()
    return 0.0, (ms, plain, bound, lib)


FLASH_SHAPES = {
    # name: (B, S, H, Hkv, D, window, softcap)
    "zamba2 prefill": (4, 2048, 32, 32, 80, 0, 0.0),
    "gemma2 local": (1, 8192, 32, 16, 128, 4096, 50.0),
    "olmoe prefill": (4, 2048, 16, 16, 128, 0, 0.0),
}
# (B, Sq, Sk, H, Hkv, D, Dv, causal, window, softcap): the flash kernel's
# edges, the cases of tests/test_torch_dense_kernels.py's card test (this
# machine has no JAX to run that file) -- head dims 1..256 (16-byte copies
# or element copies, padding to 16), G in {1, 2, 3, 4, 9}, S off the 64-key
# tile, a window that leaves a row's first tiles wholly masked, a softcap,
# Sq != Sk
FLASH_EDGE_CASES = [
    (1, 130, 130, 2, 2, 16, 16, True, 0, 0.0),
    (2, 200, 200, 8, 2, 80, 80, True, 0, 0.0),
    (1, 300, 300, 4, 2, 128, 128, True, 70, 50.0),
    (1, 150, 150, 3, 1, 192, 128, True, 0, 0.0),      # MLA's D / Dv
    (1, 100, 100, 9, 1, 128, 128, True, 0, 0.0),      # starcoder2's G
    (1, 260, 260, 2, 2, 64, 64, True, 100, 0.0),
    (2, 96, 160, 4, 4, 32, 32, True, 0, 0.0),
    (1, 160, 96, 4, 2, 48, 48, False, 0, 0.0),
    (1, 77, 77, 4, 4, 20, 20, True, 0, 0.0),
    (1, 90, 90, 2, 1, 256, 100, False, 30, 0.0),
    (1, 64, 64, 2, 2, 1, 1, True, 0, 0.0),
]
SCAN_SHAPES = {
    # name: (B, S, H, K, Vd, vector decay + bonus, chunk)
    "mamba2": (4, 2048, 80, 64, 64, False, 128),
    "rwkv6": (4, 2048, 32, 64, 64, True, 32),
}
# (name, (B, S, H, K, Vd, vector decay + bonus, chunk), log decay range):
# S off the chunk, and decays that take -cl past the 75 clamp inside a
# chunk (the factored form's clamp, which the kernels must keep)
SCAN_EDGE_CASES = [
    ("mamba2 S off the chunk", (2, 1000, 8, 64, 64, False, 128), 0.01, 1.0),
    ("rwkv6 S off the chunk", (2, 1000, 8, 64, 64, True, 32), 0.01, 1.0),
    ("mamba2 clamp active", (2, 512, 8, 64, 64, False, 128), 0.6, 0.8),
    ("rwkv6 clamp active", (2, 256, 8, 64, 64, True, 32), 2.4, 2.6),
]


def _randn(g, shape, dtype=torch.float32):
    return torch.randn(shape, generator=g, device=DEV).to(dtype)


def _flash_pairs(S: int, window: int) -> int:
    """Unmasked (query, key) pairs of one causal head of length S."""
    n = np.arange(1, S + 1)
    return int((np.minimum(n, window) if window else n).sum())


def check_flash(g, dtype):
    """Flash attention against its plain version at zamba2's prefill shape
    and a gemma2 local layer; returns the worst error and, per shape, the
    kernel / plain / bound / SDPA times."""
    tol = ATT_TOL[dtype]
    worst, times = 0.0, {}
    for case in FLASH_EDGE_CASES:
        B, Sq, Sk, H, Hkv, D, Dv, causal, window, cap = case
        q = _randn(g, (B, Sq, H, D), dtype)
        k = _randn(g, (B, Sk, Hkv, D), dtype)
        v = _randn(g, (B, Sk, Hkv, Dv), dtype)
        kw = dict(causal=causal, window=window, softcap=cap)
        got = fa.flash_attention(q, k, v, **kw)
        want = ref.flash_attention_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        err, ok = within(got, want, tol)
        log(f"  flash_attention {str(dtype)[6:]} edge {case}: max |err| "
            f"{err:.3e}: {ok}")
        if not ok:
            raise AssertionError(f"flash_attention {case} {dtype}: {err}")
        worst = max(worst, err)
    for name, (B, S, H, Hkv, D, window, cap) in FLASH_SHAPES.items():
        q = _randn(g, (B, S, H, D), dtype)
        k = _randn(g, (B, S, Hkv, D), dtype)
        v = _randn(g, (B, S, Hkv, D), dtype)
        kw = dict(window=window, softcap=cap)
        got = fa.flash_attention(q, k, v, **kw)
        want = ref.flash_attention_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        err, ok = within(got, want, tol)
        log(f"  flash_attention {str(dtype)[6:]} {name}: max |err| "
            f"{err:.3e} (tol {tol:g} abs + rel)")
        if not ok:
            raise AssertionError(f"flash_attention {name} {dtype}: {err}")
        worst = max(worst, err)
        ms = cuda_ms(lambda: fa.flash_attention(q, k, v, **kw), 10, 2)
        plain = cuda_ms(lambda: ref.flash_attention_ref(q, k, v, **kw), 3, 1)
        bytes_ = (q.numel() + k.numel() + v.numel() + got.numel()) \
            * q.element_size()
        flops = 4 * D * B * H * _flash_pairs(S, window)
        bound, by = bound_ms(bytes_, flops, dtype)
        lib = None
        if not window and not cap:
            # the same function in one PyTorch call, as a yardstick only
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            lib = cuda_ms(lambda: torch.nn.functional
                          .scaled_dot_product_attention(qt, kt, vt,
                                                        is_causal=True),
                          10, 2)
            del qt, kt, vt
        times[name] = (ms, plain, bound, by, lib)
        rate = (f"{flops / ms / 1e9:.1f} TFLOP/s" + (
            "" if lib is None else f" vs SDPA {flops / lib / 1e9:.1f}"))
        log(f"  flash_attention {str(dtype)[6:]} {name}: kernel {ms:.4f} ms "
            f"({rate}), plain {plain:.4f} ms, SDPA "
            f"{'n/a' if lib is None else f'{lib:.4f} ms'}, bound "
            f"{bound:.6f} ms ({by})")
        del q, k, v, got, want
        free_cuda()
    return worst, times


def _scan_inputs(g, shape, dtype, S=None, max_decay=1.0, min_decay=0.01):
    """q, k, v, log decay (and bonus) as the model hands them over: mamba2's
    q/k are one (B, S, 1, K) matrix each viewed with stride 0 over the
    heads."""
    B, S0, H, K, Vd, vec, _ = shape
    S = S or S0
    if vec:
        q, k = _randn(g, (B, S, H, K), dtype), _randn(g, (B, S, H, K), dtype)
        ld_shape = (B, S, H, K)
        bonus = _randn(g, (H, K))
    else:
        q = _randn(g, (B, S, 1, K), dtype).expand(B, S, H, K)
        k = _randn(g, (B, S, 1, K), dtype).expand(B, S, H, K)
        ld_shape = (B, S, H)
        bonus = None
    v = _randn(g, (B, S, H, Vd), dtype)
    ld = -(min_decay + (max_decay - min_decay) * torch.rand(
        ld_shape, generator=g, device=DEV))
    return (q, k, v, ld), bonus


def _stored_bytes(t: torch.Tensor) -> int:
    """Bytes of a tensor's distinct elements (stride-0 dims count once)."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        n *= size if stride else 1
    return n * t.element_size()


def check_scan(g, dtype):
    """The linear scan against linear_scan_ref at mamba2's and rwkv6's
    main-path shapes, in f32 also against the exact oracle at S=512 (with
    mamba2's decays kept under the 75 clamp over a 128 chunk, where the
    factored form is exact); returns the worst error and the times."""
    tol = SCAN_TOL[dtype]
    worst, times = 0.0, {}
    for name, shape in SCAN_SHAPES.items():
        B, S, H, K, Vd, vec, chunk = shape
        args, bonus = _scan_inputs(g, shape, dtype)
        kw = dict(bonus=bonus, chunk=chunk)
        out, st = ls.linear_scan(*args, **kw)
        want, st_want = ref.linear_scan_ref(*args, **kw)
        torch.cuda.synchronize()
        err, ok = within(out, want, tol)
        err_st, ok_st = within(st, st_want, tol)
        log(f"  linear_scan {str(dtype)[6:]} {name}: max |err| out "
            f"{err:.3e}, state {err_st:.3e} (tol {tol:g} abs + rel)")
        if not (ok and ok_st):
            raise AssertionError(f"linear_scan {name} {dtype}: {err} "
                                 f"{err_st}")
        worst = max(worst, err, err_st)
        if dtype == torch.float32:
            eargs, ebonus = _scan_inputs(g, shape, dtype, S=512,
                                         max_decay=0.5)
            ekw = dict(bonus=ebonus, chunk=chunk)
            eo, es = ls.linear_scan(*eargs, **ekw)
            xo, xs = ref.linear_scan_exact(*eargs, **ekw)
            e1, ok1 = within(eo, xo, tol)
            e2, ok2 = within(es, xs, tol)
            log(f"  linear_scan float32 {name} S=512 vs linear_scan_exact: "
                f"max |err| out {e1:.3e}, state {e2:.3e} (tol {tol:g})")
            if not (ok1 and ok2):
                raise AssertionError(f"linear_scan {name} vs exact: {e1} "
                                     f"{e2}")
        ms = cuda_ms(lambda: ls.linear_scan(*args, **kw), 10, 2)
        dev, parts = device_ms(lambda: ls.linear_scan(*args, **kw),
                               ("scan_state", "scan_out"), 10)
        plain = cuda_ms(lambda: ref.linear_scan_ref(*args, **kw), 3, 1)
        n = -(-S // chunk)
        L = chunk
        flops = 2 * B * H * n * ((L * (L - 1) // 2) * K + L * K
                                 + (L * (L + 1) // 2) * Vd + 2 * L * K * Vd)
        bytes_ = (sum(_stored_bytes(t) for t in args) + _stored_bytes(out)
                  + _stored_bytes(st)
                  + (0 if bonus is None else _stored_bytes(bonus)))
        bound, by = bound_ms(bytes_, flops, dtype)
        times[name] = (ms, plain, bound, by, None, dev)
        log(f"  linear_scan {str(dtype)[6:]} {name}: kernel {ms:.4f} ms "
            f"(event time of a wrapper call), device {dev:.4f} ms a call "
            f"(profiler: " + ", ".join(f"{k} {v:.4f}" for k, v in
                                       parts.items())
            + f"), plain {plain:.4f} ms, bound {bound:.6f} ms ({by})")
        del args, out, st, want, st_want
        free_cuda()
    # S off the chunk, and decays whose -cl passes the 75 clamp in a chunk
    for name, shape, lo, hi in SCAN_EDGE_CASES:
        args, bonus = _scan_inputs(g, shape, dtype, max_decay=hi,
                                   min_decay=lo)
        kw = dict(bonus=bonus, chunk=shape[-1])
        out, st = ls.linear_scan(*args, **kw)
        want, st_want = ref.linear_scan_ref(*args, **kw)
        torch.cuda.synchronize()
        err, ok = within(out, want, tol)
        err_st, ok_st = within(st, st_want, tol)
        log(f"  linear_scan {str(dtype)[6:]} {name} {shape}: max |err| out "
            f"{err:.3e}, state {err_st:.3e} (tol {tol:g} abs + rel): "
            f"{ok and ok_st}")
        if not (ok and ok_st):
            raise AssertionError(f"linear_scan {name} {dtype}: {err} "
                                 f"{err_st}")
        worst = max(worst, err, err_st)
    return worst, times


def phase_kernels():
    rng = np.random.default_rng(SEED)
    g = torch.Generator(device=DEV).manual_seed(SEED)
    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        results[("paged_attention", dtype)] = check_attention(rng, dtype)
        results[("paged_scatter", dtype)] = check_scatter(rng, dtype)
        results[("flash_attention", dtype)] = check_flash(g, dtype)
        results[("linear_scan", dtype)] = check_scan(g, dtype)
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


def _engine(cfg, params, smr: str = "EpochPOP-pool", backend: str = "gen"):
    return ServeEngine(cfg, params, kv_store="paged", kv_storage="device",
                       device=DEV, smr=smr, sim_backend=backend, n_engines=2,
                       prefill_workers=1, prefix_cache=True, page_size=PAGE,
                       prefill_chunk=32, num_pages=POOL_PAGES, max_batch=8)


def _serve(eng, prompts, max_new: int, label: str):
    """Start ``eng``, submit ``prompts`` at ``max_new`` tokens each, wait
    for every request, stop: (requests, wall seconds, kernel launches)."""
    build.reset_launch_counts()
    t0 = time.monotonic()
    eng.start()
    reqs = [eng.submit(p, max_new=max_new) for p in prompts]
    for r in reqs:
        if not r.done.wait(timeout=900):
            raise AssertionError(f"{label}: request {r.rid} did not finish")
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    eng.stop()
    return reqs, wall, dict(build.launch_counts)


def _serve_checks(eng, reqs, launches, want_tokens, leaky: bool = False):
    """Raise on an engine error or a short request (``want_tokens`` is each
    request's count); then quiesce, flush, and return the run's checks."""
    if eng.error is not None:
        raise AssertionError(f"engine failed: {eng.error!r}")
    for r, n in zip(reqs, want_tokens):
        if len(r.out) != n:
            raise AssertionError(f"request {r.rid}: {len(r.out)} of {n} "
                                 f"tokens")
    pool, store = eng.pool, eng.kv_store
    _quiesce_and_flush(pool)
    peak = max(w.max_abs_logit for w in eng.workers)
    return {
        "no leaks": pool.check_no_leaks(),
        "poisons == freed": store.poisons == pool.stats.freed,
        # NR never frees by design: its check is that nothing was freed
        ("freed == 0" if leaky else "freed > 0"):
            (pool.stats.freed == 0) if leaky else (pool.stats.freed > 0),
        "bytes_h2d_per_step == 0":
            eng.kv_copy_stats()["bytes_h2d_per_step"] == 0,
        "paged_attention launched": launches["paged_attention"] > 0,
        "paged_scatter launched": launches["paged_scatter"] > 0,
        "logits finite, below poison": (math.isfinite(peak)
                                        and peak < PagedKVStore.POISON),
    }


def _quiesce_and_flush(pool) -> None:
    """Evict the prefix cache, give every engine slot one empty step (the
    later quiescent step epoch schemes need), then run a reclaim pass."""
    pool.evict_prefixes(0)
    for e in range(pool.n_engines):
        pool.start_step(e)
        pool.end_step(e)
    pool.policy.flush()


def phase_serve(cfg, params, card: str, max_new: int = 16):
    prompts = _prompts(np.random.default_rng(SEED + 1), cfg.vocab)
    eng = _engine(cfg, params)
    reqs, wall, launches = _serve(eng, prompts, max_new, "serve")
    pool = eng.pool
    checks = _serve_checks(eng, reqs, launches, [max_new] * len(reqs))
    checks["prefix hits > 0"] = pool.stats.prefix_hits > 0
    for name, ok in checks.items():
        log(f"  serve check {name}: {ok}")
    if not all(checks.values()):
        raise AssertionError(f"serve checks failed: {checks}")
    tokens = sum(len(r.out) for r in reqs)
    prompt_tokens = sum(len(p) for p in prompts)
    lat = eng.metrics.snapshot().get("tok_latency_s", {})
    peak = max(w.max_abs_logit for w in eng.workers)
    log(f"serve: {len(reqs)} requests, {prompt_tokens} prompt tokens "
        f"({eng.prefill_tokens} prefilled, {pool.stats.prefix_hits} prefix "
        f"hits), {tokens} generated in {wall:.2f} s wall = "
        f"{tokens / wall:.2f} generated tok/s; decode steps "
        f"{eng.steps}; inter-token p50 {1e3 * lat.get('p50', float('nan')):.2f} ms "
        f"p99 {1e3 * lat.get('p99', float('nan')):.2f} ms; max |logit| "
        f"{peak:.3f}; launches {launches}; {card}")
    return launches


# ----------------------------------------------------------------------------
# 4b. the paper's SMR schemes guarding the device pages
# ----------------------------------------------------------------------------

#: every safe scheme of the registry on the discrete-event backend, and the
#: two publish-on-ping schemes again on the batch-stepped one
SMR_RUNS = ([(s, "gen") for s in supported_schemes()]
            + [("HazardPtrPOP", "vec"), ("EpochPOP", "vec")])
#: the schemes whose simulated work grows with the pool (every step or
#: every ping stores or scans max_hp = POOL_PAGES slots): their runs take
#: minutes, the others seconds
SMR_HEAVY = ("HazardEraPOP", "HP", "HE", "HPAsym", "DEBRA+")
#: smr serve runs at once, one process each: four copies of the weights
#: (14.8 GB) and the pages (2.1 GB) fit the card's 80 GB beside the
#: script's own process, which drops its copy during the phase
SMR_PROCS = 4
SMR_TIMEOUT_S = 1000.0           # one run's limit; the heavy runs take minutes
#: fleet_load.py's tenant mix (benchmarks/fleet_load.py, TENANTS): a chat
#: tenant with a page-aligned 16-token system prompt and long-tailed
#: lengths, a fixed batch tenant, a zipf-tailed tools tenant
FLEET_TENANTS = (
    TenantSpec("chat", weight=3.0, system_prefix=16,
               prompt_len={"kind": "lognormal", "mu": 2.0, "sigma": 0.7,
                           "lo": 4, "hi": 32},
               output_len={"kind": "zipf", "alpha": 1.3, "lo": 2, "hi": 10}),
    TenantSpec("batch", weight=1.0,
               prompt_len={"kind": "fixed", "value": 12},
               output_len={"kind": "fixed", "value": 6}),
    TenantSpec("tools", weight=1.0,
               prompt_len={"kind": "zipf", "alpha": 1.1, "lo": 6, "hi": 28},
               output_len={"kind": "lognormal", "mu": 1.4, "sigma": 0.5,
                           "lo": 2, "hi": 8}),
)
#: MLPerf Inference's Llama-2-70B server-scenario latency limits (TTFT
#: 2 s, 200 ms per output token), the nearest public interactive budget
FLEET_SLO = SLOSpec(ttft_s=2.0, tok_latency_s=0.2,
                    name="mlperf-llama2-70b-server")
FLEET_SCHEMES = ("EpochPOP-pool", "HazardPtrPOP", "EpochPOP", "HP", "EBR")


def _policy_ms_per_step(eng) -> str:
    """The policy's host time: time spent holding the simulator's lock
    (drives and the frees they complete) and waiting for it, summed over
    every thread, in all and per decode step.  Idle workers bracket empty
    steps too, so their drives count.  The native EpochPOP-pool policy has
    no simulator and no such counter."""
    pol, steps = eng.pool.policy, max(eng.steps, 1)
    if not hasattr(pol, "host_s"):
        return "policy host ms/step n/a (native)"
    return (f"policy host {pol.host_s:.3f} s held + {pol.wait_s:.3f} s "
            f"waiting over {pol.drives} drives = policy host ms/step "
            f"{1e3 * pol.host_s / steps:.3f} held + "
            f"{1e3 * pol.wait_s / steps:.3f} waiting")


def smr_serve_run(cfg, params, scheme: str, backend: str, card: str,
                  max_new: int = 8) -> None:
    """The serve phase's traffic (8 requests, 4 sharing a 96-token prefix)
    at ``max_new`` tokens each under one scheme of the SMR registry: the
    simulator-backed policy decides when each device page is freed (and
    poisoned).  Raises on a failed check; prints one line."""
    prompts = _prompts(np.random.default_rng(SEED + 1), cfg.vocab)
    eng = _engine(cfg, params, smr=scheme, backend=backend)
    reqs, wall, launches = _serve(eng, prompts, max_new, f"{scheme}@{backend}")
    checks = _serve_checks(eng, reqs, launches, [max_new] * len(reqs),
                           leaky=scheme == "NR")
    if not all(checks.values()):
        raise AssertionError(f"{scheme}@{backend} checks failed: {checks}")
    st = eng.pool.stats
    lat = eng.metrics.snapshot().get("tok_latency_s", {})
    tokens = sum(len(r.out) for r in reqs)
    log(f"smr serve {scheme}@{backend}: {tokens} generated in "
        f"{wall:.2f} s = {tokens / wall:.2f} generated tok/s; "
        f"inter-token p50 {1e3 * lat.get('p50', float('nan')):.2f} ms "
        f"p99 {1e3 * lat.get('p99', float('nan')):.2f} ms; decode steps "
        f"{eng.steps}; freed {st.freed}, pings {st.pings}, publishes "
        f"{st.publishes}, max ping stall {1e3 * st.max_ping_stall_s:.3f} "
        f"ms; {_policy_ms_per_step(eng)}; launches paged_attention "
        f"{launches['paged_attention']} paged_scatter "
        f"{launches['paged_scatter']}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; checks "
        f"passed; use-after-free: none; {card}")


def smr_run_main(scheme: str, backend: str) -> int:
    """``chip_smoke.py --smr-run SCHEME BACKEND``: one run of the smr serve
    phase in a process of its own, on starcoder2-7b's weights from the
    script's seed (the same weights as every other phase)."""
    card = _card()
    cfg = starcoder2_7b.CONFIG
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    smr_serve_run(cfg, init_params(cfg, gen, device=DEV), scheme, backend,
                  card)
    return 0


def phase_smr_serve() -> None:
    """Every run of ``SMR_RUNS``, each in a process of its own,
    ``SMR_PROCS`` at a time on the one card.  A run's cost is host time under its
    process's one GIL and the policy's one lock (the device idles most of
    a serve step), so the runs share only the host's cores and the card.
    The longest runs start first.  The first failure stops the other
    processes and raises."""
    order = ([r for h in SMR_HEAVY for r in SMR_RUNS if r[0] == h]
             + [r for r in SMR_RUNS if r[0] not in SMR_HEAVY])
    running = []               # (scheme, backend, process, output, t0)
    t_all = time.monotonic()
    try:
        while order or running:
            while order and len(running) < SMR_PROCS:
                scheme, backend = order.pop(0)
                out = tempfile.TemporaryFile(mode="w+")
                proc = subprocess.Popen(
                    [sys.executable, str(Path(__file__).resolve()),
                     "--smr-run", scheme, backend],
                    stdout=out, stderr=subprocess.STDOUT, text=True)
                running.append((scheme, backend, proc, out, time.monotonic()))
            time.sleep(0.5)
            for item in list(running):
                scheme, backend, proc, out, t0 = item
                if proc.poll() is None:
                    if time.monotonic() - t0 > SMR_TIMEOUT_S:
                        proc.kill()
                        proc.wait()
                        raise AssertionError(
                            f"smr serve {scheme}@{backend}: no end after "
                            f"{SMR_TIMEOUT_S:.0f} s")
                    continue
                running.remove(item)
                out.seek(0)
                text = out.read()
                out.close()
                if proc.returncode != 0:
                    raise AssertionError(
                        f"smr serve {scheme}@{backend} failed (exit "
                        f"{proc.returncode}):\n{text[-6000:]}")
                for line in text.splitlines():
                    if line.startswith("smr serve "):
                        log(line)
    finally:
        for _, _, proc, out, _ in running:
            proc.kill()
            proc.wait()
            out.close()
    log(f"smr serve: {len(SMR_RUNS)} runs passed in "
        f"{time.monotonic() - t_all:.1f} s, {SMR_PROCS} processes at a "
        f"time")


def phase_fleet_replay(cfg, params, card: str, duration_s: float = 16.0,
                       rate_rps: float = 0.5) -> None:
    """A fleet_load.py-style trace (its tenant mix, Poisson arrivals at
    ``rate_rps`` for ``duration_s``, token ids over starcoder2's vocab)
    replayed in real time through the same engine layout under each scheme
    of ``FLEET_SCHEMES``, scored by an SLOTracker.  Evidence that the path
    works under open-loop load, not a benchmark cell."""
    spec = WorkloadSpec(duration_s=duration_s, seed=SEED, tenants=FLEET_TENANTS,
                        process="poisson", rate_rps=rate_rps, vocab=cfg.vocab)
    trace = generate(spec)
    if len(trace.requests) < 4:
        raise AssertionError(f"trace holds {len(trace.requests)} requests")
    log(f"fleet trace: {len(trace.requests)} requests over "
        f"{trace.duration_s:.2f} s, {sum(len(r.prompt) for r in trace.requests)} "
        f"prompt tokens, {sum(r.max_new for r in trace.requests)} output "
        f"tokens, tenants {sorted({r.tenant for r in trace.requests})}; "
        f"SLO {FLEET_SLO.name}: TTFT <= {FLEET_SLO.ttft_s} s, per-token <= "
        f"{FLEET_SLO.tok_latency_s} s")
    for scheme in FLEET_SCHEMES:
        eng = _engine(cfg, params, smr=scheme)
        eng.start()
        build.reset_launch_counts()
        t0 = time.monotonic()
        pairs = replay(trace, lambda r: (r, eng.submit(list(r.prompt),
                                                       max_new=r.max_new)),
                       stop=lambda: eng.error is not None)
        for _, r in pairs:
            if not r.done.wait(timeout=900):
                raise AssertionError(f"{scheme}: request {r.rid} did not "
                                     f"finish")
        torch.cuda.synchronize()
        elapsed = time.monotonic() - t0
        eng.stop()
        launches = dict(build.launch_counts)
        if len(pairs) != len(trace.requests):
            raise AssertionError(f"{scheme}: replayed {len(pairs)} of "
                                 f"{len(trace.requests)} requests")
        checks = _serve_checks(eng, [r for _, r in pairs], launches,
                               [t.max_new for t, _ in pairs])
        if not all(checks.values()):
            raise AssertionError(f"{scheme} replay checks failed: {checks}")
        slo_t = SLOTracker(FLEET_SLO, window_s=4.0)
        for treq, r in pairs:
            ttft = r.t_first_tok - r.t_submit
            tok_lat = ((r.t_last_tok - r.t_first_tok) / (len(r.out) - 1)
                       if len(r.out) > 1 else 0.0)
            slo_t.observe(t_finish_s=max(r.t_last_tok - t0, 0.0),
                          tokens=len(r.out), ttft_s=ttft,
                          tok_latency_s=tok_lat, tenant=treq.tenant)
        ttft = eng.metrics.snapshot().get("ttft_s", {})
        st = eng.pool.stats
        log(f"fleet replay {scheme}: {slo_t.requests} requests in "
            f"{elapsed:.2f} s; SLO attainment {slo_t.attainment():.3f}, "
            f"goodput {slo_t.goodput(elapsed):.3f} tok/s (TTFT <= "
            f"{FLEET_SLO.ttft_s} s, per-token <= {FLEET_SLO.tok_latency_s} "
            f"s); TTFT p50 {1e3 * ttft.get('p50', float('nan')):.2f} ms p99 "
            f"{1e3 * ttft.get('p99', float('nan')):.2f} ms; max ping stall "
            f"{1e3 * st.max_ping_stall_s:.3f} ms; freed {st.freed}; "
            f"{_policy_ms_per_step(eng)}; use-after-free 0; {card}")
        del eng
        free_cuda()


def phase_profile(cfg, params, max_new: int = 16, top: int = 6):
    """The serve phase's traffic again, under torch.profiler: device busy
    time and idle share over the window, kernel launches per forward, and
    the kernels that take the device time.  A separate run, so the serve
    phase's own numbers carry no tracing cost."""
    from torch.profiler import ProfilerActivity, profile

    prompts = _prompts(np.random.default_rng(SEED + 1), cfg.vocab)
    eng = _engine(cfg, params)
    eng.start()
    build.reset_launch_counts()
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
    forwards = build.launch_counts["paged_attention"] / cfg.n_layers
    report_profile(prof, wall, forwards, cfg.n_layers, top)
    log(f"  profile scatter index uploads per forward: "
        f"{eng.kv_store.index_builds / forwards:.2f} (one per forward; "
        f"{build.launch_counts['paged_scatter'] / forwards:.1f} scatter "
        f"launches per forward)")


def report_profile(prof, wall: float, forwards: float, n_layers: int,
                   top: int, skip: tuple = ()) -> float:
    """Device busy time and idle share over the window, host kernel
    launches and copies per forward, and the kernels that take the device
    time; returns the busy seconds.  Only the device's own events count: a
    host op's row also carries the device time of the kernels it launched,
    which would count them twice (and so would a user range's device-side
    span: its name goes in ``skip``)."""
    from torch.autograd import DeviceType

    dev_us = _dev_us
    all_events = prof.key_averages()
    events = [e for e in all_events if e.device_type == DeviceType.CUDA
              and e.key not in skip]
    busy = sum(dev_us(e) for e in events) / 1e6
    launches = sum(e.count for e in all_events
                   if e.key in ("cudaLaunchKernel", "cuLaunchKernelEx"))
    copies = sum(e.count for e in all_events if e.key == "cudaMemcpyAsync")
    log(f"profile: window {wall:.2f} s, device busy {busy:.3f} s, idle "
        f"share {1 - busy / wall:.4f}; {forwards:.0f} forwards, "
        f"{launches / forwards:.0f} kernel launches per forward "
        f"({launches / forwards / n_layers:.1f} per layer), "
        f"{copies / forwards:.1f} cudaMemcpyAsync per forward")
    ranked = sorted(events, key=dev_us, reverse=True)
    ours = [e for e in ranked[top:] if any(f"::{name}" in e.key for name in (
        "paged_attention_kernel", "paged_scatter_kernel", "flash_bf16_kernel",
        "flash_f32_kernel", "scan_state", "scan_out"))]
    for e in ranked[:top] + ours:   # this package's kernels always shown
        log(f"  profile kernel {e.key[:60]}: {dev_us(e) / 1e3:.2f} ms "
            f"({dev_us(e) / 1e6 / busy:.4f} of busy), {e.count} launches")
    return busy


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


def phase_prefill_kv(cfg, params, n_prompt: int = 512, chunk: int = 32):
    """One prompt into pages two ways: the full-sequence prefill (flash
    attention over the whole prompt, one all-layer scatter) and the chunked
    paged prefill (paged attention per chunk).  f32 compute: the pages
    agree within 2e-4 abs + rel (two exact attentions, summation order
    only).  bf16: within max(5e-2, 2 e), e the chunked path's own bf16
    distance from its f32 pages -- the two paths round at different places
    through 32 layers."""
    rng = np.random.default_rng(SEED + 3)
    prompt = rng.integers(1, cfg.vocab, n_prompt).tolist()
    blocks = list(range(1, 1 + n_prompt // PAGE))
    pages = {}
    for dtype in ("float32", "bfloat16"):
        c = cfg.scaled(dtype=dtype)
        full = PagedKVStore(c, len(blocks) + 1, PAGE, storage="device",
                            device=DEV)
        build.reset_launch_counts()
        k, v = prefill_kv(params, c, prompt)
        full.write_prefill(blocks, k, v)
        flash = build.launch_counts["flash_attention"]
        chunked = PagedKVStore(c, len(blocks) + 1, PAGE, storage="device",
                               device=DEV)
        for _ in prefill_kv_chunked(params, c, chunked, blocks, prompt,
                                    chunk):
            pass
        torch.cuda.synchronize()
        pages[dtype] = (torch.stack([full.k[:, blocks], full.v[:, blocks]]),
                        torch.stack([chunked.k[:, blocks],
                                     chunked.v[:, blocks]]), flash)
        del full, chunked, k, v
    own = within(pages["bfloat16"][1], pages["float32"][1], 0.0)[0]
    for dtype, tol in (("float32", 2e-4),
                       ("bfloat16", max(SLICE_TOL, 2 * own))):
        a, b, flash = pages[dtype]
        err, ok = within(a, b, tol)
        log(f"prefill_kv {dtype}: {n_prompt}-token prompt, {flash} flash "
            f"launches, pages vs prefill_kv_chunked's: max |diff| {err:.4e} "
            f"(tol {tol:.4g} abs + rel): {ok}")
        if not ok or flash != cfg.n_layers:
            raise AssertionError(f"prefill_kv {dtype}: {err}, {flash} "
                                 f"flash launches")


# ----------------------------------------------------------------------------
# 6. the dense path: zamba2-2.7b and rwkv6-1.6b prefill, zamba2 dense serve
# ----------------------------------------------------------------------------


def _graft(cfg, pcache, batch: int, seq: int):
    """A prefill cache written into a zero decode cache of ``seq``
    positions (the rule of tests/test_models_smoke.py)."""
    cache = init_cache(cfg, batch, seq, cfg.dtype, device=DEV)
    cache["pos"] = pcache["pos"].clone()
    for gk, gv in pcache["groups"].items():
        for pk, pv in gv.items():
            for name, arr in pv.items():
                tgt = cache["groups"][gk][pk][name]
                tgt[tuple(slice(0, n) for n in arr.shape)] = arr.to(tgt.dtype)
    return cache


def _prefill_runs(cfg, params, toks):
    """make_prefill_step through the kernels and through the plain
    versions, in bf16 and f32 compute: {(dtype, impl): (last logits, cache,
    launch counts, host seconds of a second, warm call)}."""
    runs = {}
    for dtype in ("bfloat16", "float32"):
        c = cfg.scaled(dtype=dtype)
        for impl in ("cuda", "torch"):
            step = make_prefill_step(c, impl=impl)
            build.reset_launch_counts()
            logits, cache = step(params, toks)
            torch.cuda.synchronize()
            counts = dict(build.launch_counts)
            t0 = time.monotonic()
            step(params, toks)
            torch.cuda.synchronize()
            runs[(dtype, impl)] = (logits.float(), cache, counts,
                                   time.monotonic() - t0)
            free_cuda()
    return runs


def _check_prefill(name, runs, f32_tol: float):
    """Kernels vs plain: f32 within ``f32_tol`` abs + rel (summation order
    through every layer); bf16 within max(5e-2, 2 e), e the plain path's
    own bf16 distance from its f32 logits (the two bf16 paths round in
    different places, each about e from the f32 value)."""
    own = within(runs[("bfloat16", "torch")][0],
                 runs[("float32", "torch")][0], 0.0)[0]
    for dtype, tol in (("float32", f32_tol),
                       ("bfloat16", max(SLICE_TOL, 2 * own))):
        a, b = runs[(dtype, "cuda")][0], runs[(dtype, "torch")][0]
        if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
            raise AssertionError(f"{name} {dtype}: non-finite logits")
        err, ok = within(a, b, tol)
        agree = float((a.argmax(-1) == b.argmax(-1)).float().mean())
        log(f"dense prefill {name} {dtype}: last-position logits {tuple(a.shape)}, "
            f"kernels vs plain max |diff| {err:.4e} (tol {tol:.4g} abs + rel): "
            f"{ok}; argmax agreement {agree:.4f}; max |logit| "
            f"{float(b[b > -1e29].abs().max()):.3f} (padded vocab masked "
            f"to -1e30 left out); prefill host time kernels "
            f"{1e3 * runs[(dtype, 'cuda')][3]:.1f} ms, plain "
            f"{1e3 * runs[(dtype, 'torch')][3]:.1f} ms; launches "
            f"{runs[(dtype, 'cuda')][2]}")
        if not ok:
            raise AssertionError(f"{name} {dtype} prefill logits differ")


def phase_dense_prefill(cfg, params, batch: int = 4, seq: int = 2048,
                        steps: int = 8):
    """zamba2-2.7b's prefill through both kernels vs the plain versions;
    the prefill cache grafted for ``steps`` decode steps against the
    train-mode forward; greedy make_serve_step.  Returns the main path's
    launch counts (the bf16 prefill through the kernels)."""
    rng = np.random.default_rng(SEED + 4)
    toks = torch.from_numpy(rng.integers(1, cfg.vocab, (batch, seq + steps))
                            ).to(DEV)
    runs = _prefill_runs(cfg, params, toks[:, :seq])
    main_counts = runs[("bfloat16", "cuda")][2]
    n_shared = sum(g.repeats * sum(ls.shared_attn for ls in g.pattern)
                   for g in cfg.groups)
    want = {"flash_attention": n_shared, "linear_scan": cfg.n_layers}
    for dtype in ("bfloat16", "float32"):
        for impl, expect in (("cuda", want), ("torch", {})):
            got = {k: runs[(dtype, impl)][2][k] for k in want}
            if got != {k: expect.get(k, 0) for k in want}:
                raise AssertionError(f"{dtype} {impl} prefill launches "
                                     f"{got}, want {expect}")
    log(f"dense prefill {cfg.name}: launches per prefill through the "
        f"kernels {main_counts}; through the plain versions "
        f"{runs[('bfloat16', 'torch')][2]}")
    _check_prefill(cfg.name, runs, 1e-3)

    # decode after prefill vs the train-mode forward over the same tokens
    fwd = {}
    for dtype in ("float32", "bfloat16"):
        c = cfg.scaled(dtype=dtype)
        full, _, _ = apply_model(params, toks, cfg=c, mode="train")
        fwd[dtype] = full[:, seq:].float()
        del full
        free_cuda()
    own = within(fwd["bfloat16"], fwd["float32"], 0.0)[0]
    for dtype, tol in (("float32", 1e-3), ("bfloat16", max(0.25, 2 * own))):
        c = cfg.scaled(dtype=dtype)
        cache = _graft(c, runs[(dtype, "cuda")][1], batch, seq + steps)
        rows = []
        for t in range(seq, seq + steps):
            lg, cache, _ = apply_model(params, toks[:, t:t + 1], cfg=c,
                                       mode="decode", cache=cache)
            rows.append(lg[:, 0].float())
        err, ok = within(torch.stack(rows, 1), fwd[dtype], tol)
        log(f"decode after prefill {dtype}: {steps} steps vs the train-mode "
            f"forward, max |diff| {err:.4e} (tol {tol:.4g} abs + rel, the "
            f"rule of tests/test_models_smoke.py): {ok}")
        if not ok:
            raise AssertionError(f"decode after prefill {dtype}: {err}")
        del cache
    c = cfg.scaled(dtype="bfloat16")
    cache = _graft(c, runs[("bfloat16", "cuda")][1], batch, seq + steps)
    serve_step = make_serve_step(c)
    tok = runs[("bfloat16", "cuda")][0].argmax(-1).to(torch.int32)[:, None]
    gen = []
    for _ in range(steps):
        tok, cache = serve_step(params, cache, tok)
        gen.append(tok)
        tok = tok[:, None]
    gen = torch.stack(gen, 1).cpu()
    if not bool(((gen >= 0) & (gen < cfg.vocab)).all()):
        raise AssertionError(f"make_serve_step tokens out of range: {gen}")
    log(f"make_serve_step: {steps} greedy steps after the prefill, row 0 "
        f"tokens {gen[0].tolist()}, cache pos {cache['pos'].tolist()}")
    del runs, cache, fwd
    free_cuda()
    return main_counts


def phase_rwkv_prefill(cfg, params, batch: int = 2, seq: int = 2048):
    """rwkv6-1.6b's prefill through the vector-decay scan vs the plain
    version (one scan launch per layer)."""
    rng = np.random.default_rng(SEED + 6)
    toks = torch.from_numpy(rng.integers(1, cfg.vocab, (batch, seq))).to(DEV)
    runs = _prefill_runs(cfg, params, toks)
    got = runs[("bfloat16", "cuda")][2]["linear_scan"]
    if got != cfg.n_layers:
        raise AssertionError(f"rwkv6 prefill: {got} scan launches")
    _check_prefill(cfg.name, runs, 1e-3)
    del runs
    free_cuda()


def phase_dense_serve(cfg, params, card: str, max_new: int = 8):
    """ServeEngine(kv_store="dense") on zamba2-2.7b or olmoe-1b-7b: 6
    requests of 32-96 prompt tokens, 3 sharing a 32-token prefix (the first
    of them goes in alone until its prefix is published, so the other two
    can hit it).  This path prefills token by token through decode mode, as
    the reference's dense engine does: it launches neither new kernel."""
    rng = np.random.default_rng(SEED + 5)
    shared = rng.integers(1, cfg.vocab, 32).tolist()
    prompts = [shared + rng.integers(1, cfg.vocab, n).tolist()
               for n in (5, 20, 40)]
    prompts += [rng.integers(1, cfg.vocab, n).tolist() for n in (32, 60, 96)]
    eng = ServeEngine(cfg, params, kv_store="dense", device=DEV,
                      smr="EpochPOP-pool", n_engines=2, prefix_cache=True,
                      page_size=PAGE, num_pages=128, max_seq=128,
                      max_batch=4)
    pool = eng.pool
    build.reset_launch_counts()
    t0 = time.monotonic()
    eng.start()
    reqs = [eng.submit(prompts[0], max_new=max_new)]
    while pool.prefix_entries == 0 and not reqs[0].done.is_set():
        if time.monotonic() - t0 > 600:
            raise AssertionError("the shared prefix was never published")
        time.sleep(0.01)
    reqs += [eng.submit(p, max_new=max_new) for p in prompts[1:]]
    for r in reqs:
        if not r.done.wait(timeout=900):
            raise AssertionError(f"request {r.rid} did not finish")
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    eng.stop()
    launches = dict(build.launch_counts)
    if eng.error is not None:
        raise AssertionError(f"dense engine failed: {eng.error!r}")
    for r in reqs:
        if len(r.out) != max_new:
            raise AssertionError(f"request {r.rid}: {len(r.out)} tokens")
    hits = pool.stats.prefix_hits
    pool.evict_prefixes(0)
    pool.policy.flush()
    checks = {"no leaks": pool.check_no_leaks(),
              "freed > 0": pool.stats.freed > 0,
              "prefix hits > 0": hits > 0}
    for name, ok in checks.items():
        log(f"  dense serve check {name}: {ok}")
    if not all(checks.values()):
        raise AssertionError(f"dense serve checks failed: {checks}")
    tokens = sum(len(r.out) for r in reqs)
    lat = eng.metrics.snapshot().get("tok_latency_s", {})
    stats = eng.kv_copy_stats()
    log(f"dense serve: {cfg.name}, {len(reqs)} requests, "
        f"{sum(len(p) for p in prompts)} prompt tokens ({eng.prefill_tokens} "
        f"prefilled token by token, {hits} prefix hits), {tokens} generated "
        f"in {wall:.2f} s wall = {tokens / wall:.2f} generated tok/s; "
        f"inter-token p50 {1e3 * lat.get('p50', float('nan')):.2f} ms p99 "
        f"{1e3 * lat.get('p99', float('nan')):.2f} ms; cache bytes per "
        f"request {stats['bytes_per_miss']:.0f}; use-after-free: none; "
        f"launches {launches} (decode mode runs no kernel of this package); "
        f"{card}")


def phase_dense_profile(cfg, params, batch: int = 4, seq: int = 2048,
                        top: int = 8):
    """One bf16 zamba2 prefill through the kernels under torch.profiler,
    after a warm call."""
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(SEED + 4)
    toks = torch.from_numpy(rng.integers(1, cfg.vocab, (batch, seq))).to(DEV)
    step = make_prefill_step(cfg)
    step(params, toks)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        step(params, toks)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    log(f"dense profile: {cfg.name} prefill of {batch} x {seq} tokens")
    report_profile(prof, wall, 1, cfg.n_layers, top)
    free_cuda()


# ----------------------------------------------------------------------------
# 7. the paper's data-structure workloads and robustness gauntlet (host)
# ----------------------------------------------------------------------------

#: benchmarks/smr_throughput.py's settings, on the batch-stepped simulator
STRUCT_TRIAL = dict(key_range=128, duration=300_000.0, seed=7, backend="vec")
STRUCT_THREADS = 8
#: the paper's headline contrasts: each publish-on-ping scheme against the
#: scheme it replaces
STRUCT_RATIOS = (("HazardPtrPOP", "HP"), ("HazardPtrPOP", "HPAsym"),
                 ("HazardEraPOP", "HE"), ("EpochPOP", "EBR"))
STRUCT_TIMEOUT_S = 600.0


def _trial_row(res) -> dict:
    return {k: v for k, v in vars(res).items() if not k.startswith("_")}


def phase_structures() -> None:
    """The paper's throughput grid (4 structures x read/update x PAPER_SET)
    and ``run_gauntlet(quick=True)`` on both simulator backends.  Host work
    only: the simulators run on the CPU, so the throughputs are simulator
    units (ops per million simulated cycles), not the card's.  A
    use-after-free in a trial of a safe scheme raises out of ``run_trial``;
    in the gauntlet ``HP-broken`` must be the only scheme that trips, and
    on ``gen`` it trips in every fault mode.  One trial and one gauntlet
    cell, repeated, must give identical rows."""
    host = f"host of {_card()}"
    t_all = time.monotonic()
    for structure in STRUCTURES:
        for workload in ("read", "update"):
            t0 = time.monotonic()
            tp = {s: run_trial(structure, s, STRUCT_THREADS,
                               workload=workload, **STRUCT_TRIAL).throughput
                  for s in PAPER_SET}
            ratios = ", ".join(f"{a}/{b} {tp[a] / tp[b]:.3f}"
                               for a, b in STRUCT_RATIOS)
            log(f"structures {structure} {workload}: throughput in ops per "
                f"million simulated cycles (simulator units, not the "
                f"card's), {STRUCT_THREADS} threads, key range "
                f"{STRUCT_TRIAL['key_range']}, "
                f"{STRUCT_TRIAL['duration']:.0f} cycles, "
                f"{STRUCT_TRIAL['backend']}: "
                + ", ".join(f"{s} {v:.1f}" for s, v in tp.items())
                + f"; {ratios}; host wall {time.monotonic() - t0:.1f} s "
                f"({host})")
    args = ("HML", "HazardPtrPOP", STRUCT_THREADS)
    a = _trial_row(run_trial(*args, workload="update", **STRUCT_TRIAL))
    b = _trial_row(run_trial(*args, workload="update", **STRUCT_TRIAL))
    if a != b:
        raise AssertionError(f"repeated trial rows differ: {a} vs {b}")
    log(f"structures: repeated HML/HazardPtrPOP update trial, identical "
        f"rows: True; grid host wall {time.monotonic() - t_all:.1f} s "
        f"({host})")
    for backend in ("gen", "vec"):
        t0 = time.monotonic()
        rows = run_gauntlet(backends=(backend,), quick=True)
        uaf = sorted({r["scheme"] for r in rows if r["uaf"]})
        broken = [r["uaf"] for r in rows if r["scheme"] == "HP-broken"]
        safe = not any(r["uaf"] for r in rows if r["scheme"] != "HP-broken")
        ok = safe and (backend != "gen" or (uaf == ["HP-broken"]
                                            and all(broken)))
        head = summarize(rows)
        log(f"gauntlet {backend}: {len(rows)} rows, "
            f"{len({r['scheme'] for r in rows})} schemes; use-after-free "
            f"schemes {uaf} (HP-broken rows tripping {sum(broken)} of "
            f"{len(broken)}); desched-stall peak garbage vs EBR "
            f"{head.get(f'{backend}/desched_peak_vs_EBR')}; host wall "
            f"{time.monotonic() - t0:.1f} s ({host}): {ok}")
        if not ok:
            raise AssertionError(f"gauntlet {backend}: use-after-free "
                                 f"schemes {uaf}, HP-broken {broken}")
    cell = ("HazardPtrPOP", "gen", "signal-delay", 20_000.0)
    quick = dict(nthreads=4, duration=150_000.0)
    if gauntlet_cell(*cell, **quick) != gauntlet_cell(*cell, **quick):
        raise AssertionError("repeated gauntlet cell rows differ")
    log(f"structures: repeated gauntlet cell {cell}, identical rows: True; "
        f"phase host wall {time.monotonic() - t_all:.1f} s ({host})")


def start_structures():
    out = tempfile.TemporaryFile(mode="w+")
    proc = subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--structures"],
        stdout=out, stderr=subprocess.STDOUT, text=True)
    return proc, out, time.monotonic()


def finish_structures(started) -> None:
    """Wait for the structures process, print its lines, raise if it
    failed."""
    proc, out, t0 = started
    try:
        proc.wait(timeout=max(1.0, STRUCT_TIMEOUT_S - (time.monotonic()
                                                       - t0)))
    except subprocess.TimeoutExpired:
        raise AssertionError(f"structures: no end after "
                             f"{STRUCT_TIMEOUT_S:.0f} s")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        out.seek(0)
        text = out.read()
        out.close()
    if proc.returncode != 0:
        raise AssertionError(f"structures failed (exit {proc.returncode}):"
                             f"\n{text[-6000:]}")
    for line in text.splitlines():
        log(line)


# ----------------------------------------------------------------------------
# 8. olmoe-1b-7b: the MoE layer end to end
# ----------------------------------------------------------------------------


def _moe_profile(cfg, params, toks, top: int = 6):
    """One bf16 prefill under torch.profiler, each MoE layer inside a
    ``moe_layer`` range: device busy time, and the share of it that the
    kernels launched inside the ranges take (None when the profiler puts no
    device time on them)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    def traced(p, x, *, cfg):
        with record_function("moe_layer"):
            return plain(p, x, cfg=cfg)

    step = make_prefill_step(cfg)
    step(params, toks)
    torch.cuda.synchronize()
    plain, model_mod.apply_moe = model_mod.apply_moe, traced
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            step(params, toks)
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
    finally:
        model_mod.apply_moe = plain
    log(f"olmoe profile: {cfg.name} prefill of {toks.shape[0]} x "
        f"{toks.shape[1]} tokens")
    busy = report_profile(prof, wall, 1, cfg.n_layers, top,
                          skip=("moe_layer",))
    ranges = [e for e in prof.events() if e.name == "moe_layer"
              and e.device_type == DeviceType.CPU]
    moe_s = sum(e.device_time_total if hasattr(e, "device_time_total")
                else e.cuda_time_total for e in ranges) / 1e6
    return busy, (moe_s if moe_s > 0 else None), len(ranges)


def _routing_pinned(cfg, params, toks):
    """The prefill through the plain versions in f32, recording each MoE
    layer's routing (each token's experts and each expert's kept tokens),
    then through the kernels in f32 and through both paths in bf16 with
    that routing replayed.  The router's choices are discrete: a
    perturbation of the flash kernel's size (~5e-7 in f32) flips a near-tie
    somewhere among 16 layers x 8192 tokens x 64 experts, and the flipped
    token's output then differs by a whole expert's share; bf16 rounding
    flips many.  With one run's choices pinned, the runs differ only by the
    kernels' and the dtypes' numerics.  Returns {(dtype, impl): last
    logits over the real vocabulary} and, per replayed run, how many of
    its own choices differ from the recorded ones: tokens whose expert set
    differs, and (expert, token) pairs kept by one run only."""
    real, rec, at = moe_mod.route, [], [0]
    flips = {}

    def kept(cw, ci, T):
        m = torch.zeros((cw.shape[0], T + 1), dtype=torch.bool, device=DEV)
        return m.scatter_(1, torch.where(cw > 0, ci, T), True)[:, :T]

    def record(p, xt, cfg):
        out = real(p, xt, cfg)
        rec.append(out)
        return out

    def replay(key):
        flips[key] = [0, 0]

        def route(p, xt, cfg):
            own, want = real(p, xt, cfg), rec[at[0]]
            at[0] += 1
            T = xt.shape[0]
            flips[key][0] += int((own[0].sort(-1).values
                                  != want[0].sort(-1).values).any(-1).sum())
            flips[key][1] += int((kept(*own[1:3], T)
                                  != kept(*want[1:3], T)).sum())
            return want[0], want[1], want[2], own[3]
        return route

    out = {}
    try:
        for dtype, impl in (("float32", "torch"), ("float32", "cuda"),
                            ("bfloat16", "torch"), ("bfloat16", "cuda")):
            at[0] = 0
            moe_mod.route = (record if not rec else replay((dtype, impl)))
            lg = make_prefill_step(cfg.scaled(dtype=dtype), impl=impl)(
                params, toks)[0]
            out[(dtype, impl)] = lg.float()[..., :cfg.vocab]
            if at[0] not in (0, len(rec)):
                raise AssertionError(f"routing replay: {at[0]} of "
                                     f"{len(rec)} layers")
            free_cuda()
    finally:
        moe_mod.route = real
    return out, flips


def phase_olmoe(card: str, batch: int = 4, seq: int = 2048,
                steps: int = 4) -> int:
    """olmoe-1b-7b at full width and depth: the prefill through the flash
    kernel vs the plain path (16 flash launches through the kernels, none
    through the plain path; bf16 and f32 compared with the MoE routing
    pinned, the unpinned distances and routing flips printed), two more
    bf16 prefills bit-equal to the first, decode steps after a prefill
    against the train-mode forward, one MoE layer timed beside its bound,
    the MoE share of the prefill's device time, dense serving, and the
    paged path's refusal.  Returns the flash launches of one prefill
    through the kernels."""
    cfg = olmoe_1b_7b.CONFIG
    torch.cuda.reset_peak_memory_stats()
    params = _model(cfg, f"no cut: {cfg.moe.n_experts} experts, top-"
                         f"{cfg.moe.top_k}, expert d_ff {cfg.moe.d_ff}")
    rng = np.random.default_rng(SEED + 7)
    toks = torch.from_numpy(rng.integers(1, cfg.vocab, (batch, seq + steps))
                            ).to(DEV)
    runs = _prefill_runs(cfg, params, toks[:, :seq])
    want = {"flash_attention": cfg.n_layers, "linear_scan": 0}
    for dtype in ("bfloat16", "float32"):
        for impl, expect in (("cuda", want), ("torch", {})):
            got = {k: runs[(dtype, impl)][2][k] for k in want}
            if got != {k: expect.get(k, 0) for k in want}:
                raise AssertionError(f"olmoe {dtype} {impl} prefill "
                                     f"launches {got}, want {expect}")
    main_counts = runs[("bfloat16", "cuda")][2]
    log(f"olmoe prefill: launches per prefill through the kernels "
        f"{main_counts}; through the plain versions "
        f"{runs[('bfloat16', 'torch')][2]}")
    first = runs[("bfloat16", "cuda")][0]
    # the check holds the kernels' numerics with the MoE routing pinned
    # (see _routing_pinned); the unpinned distances are printed beside it
    free = {dt: within(runs[(dt, "cuda")][0][..., :cfg.vocab],
                       runs[(dt, "torch")][0][..., :cfg.vocab], 0.0)[0]
            for dt in ("float32", "bfloat16")}
    pinned, flips = _routing_pinned(cfg, params, toks[:, :seq])
    log(f"olmoe routing: recorded in the plain f32 prefill ({cfg.n_layers} "
        f"layers x {batch * seq} tokens) and replayed; the replayed runs' "
        f"own choices differing (token expert sets, kept pairs): "
        + ", ".join(f"{d} {i} {f[0]}, {f[1]}" for (d, i), f in flips.items())
        + f"; unpinned kernels vs plain max |diff| f32 "
        f"{free['float32']:.4e}, bf16 {free['bfloat16']:.4e}")
    for key, lg in pinned.items():
        runs[key] = (lg,) + runs[key][1:]
    _check_prefill(cfg.name + " (routing pinned)", runs, 1e-3)
    step = make_prefill_step(cfg)
    again = [step(params, toks[:, :seq])[0].float() for _ in range(2)]
    same = all(torch.equal(first, a) for a in again)
    log(f"olmoe determinism: three bf16 prefills through the kernels give "
        f"bit-identical last-position logits: {same}")
    if not same:
        raise AssertionError("olmoe bf16 prefills differ from run to run")
    t_prefill = runs[("bfloat16", "cuda")][3]
    del runs, again
    free_cuda()

    # decode after prefill vs the train-mode forward.  The forward's
    # capacity depends on the tokens in the batch (C = 1.25 T k / E drops
    # tokens over 8192 of them, never over a decode step's 4), so this
    # check runs the experts dropless (capacity factor E / k: C = T) in the
    # prefill, the decode and the forward alike
    m = cfg.moe
    dropless = cfg.scaled(moe=dataclasses.replace(
        m, capacity_factor=m.n_experts / m.top_k))
    fwd = {}
    for dtype in ("float32", "bfloat16"):
        full, _, _ = apply_model(params, toks, cfg=dropless.scaled(
            dtype=dtype), mode="train")
        fwd[dtype] = full[:, seq:, :cfg.vocab].float()
        del full
        free_cuda()
    own = within(fwd["bfloat16"], fwd["float32"], 0.0)[0]
    step_ms = {}
    for dtype, tol in (("float32", 1e-3), ("bfloat16", max(0.25, 2 * own))):
        c = dropless.scaled(dtype=dtype)
        _, pcache = make_prefill_step(c)(params, toks[:, :seq])
        cache = _graft(c, pcache, batch, seq + steps)
        del pcache
        rows, times = [], []
        for t in range(seq, seq + steps):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            lg, cache, _ = apply_model(params, toks[:, t:t + 1], cfg=c,
                                       mode="decode", cache=cache)
            torch.cuda.synchronize()
            times.append(time.monotonic() - t0)
            rows.append(lg[:, 0, :cfg.vocab].float())
        step_ms[dtype] = 1e3 * float(np.median(times[1:]))
        err, ok = within(torch.stack(rows, 1), fwd[dtype], tol)
        log(f"olmoe decode after prefill {dtype}: {steps} steps vs the "
            f"train-mode forward (experts dropless), max |diff| {err:.4e} "
            f"(tol {tol:.4g} abs + rel): {ok}; logits finite: "
            f"{bool(torch.isfinite(torch.stack(rows)).all())}")
        if not ok:
            raise AssertionError(f"olmoe decode after prefill {dtype}: {err}")
        del cache
        free_cuda()
    del fwd

    # one MoE layer at the prefill's shape, and the prefill's MoE share
    lp = layer_params(params["groups"]["g0"]["p0"], 0)["moe"]
    x = torch.randn((batch, seq, cfg.d_model), device=DEV,
                    generator=torch.Generator(device=DEV).manual_seed(SEED)
                    ).to(torch.bfloat16)
    out, aux = apply_moe(lp, x, cfg=cfg)
    if not (torch.isfinite(out).all() and all(torch.isfinite(v)
                                              for v in aux.values())):
        raise AssertionError("olmoe MoE layer: non-finite output")
    moe_ms = cuda_ms(lambda: apply_moe(lp, x, cfg=cfg), 10, 2)
    C = capacity(cfg, batch * seq)
    flops = 6 * m.n_experts * C * cfg.d_model * m.d_ff
    wbytes = sum(lp[k].numel() * lp[k].element_size()
                 for k in ("wi_gate", "wi_up", "wo"))
    moe_bound, moe_by = bound_ms(wbytes + 2 * x.numel() * x.element_size(),
                                 flops, torch.bfloat16)
    log(f"olmoe MoE layer: T={batch * seq}, C={C}, {moe_ms:.4f} ms a layer "
        f"(event time, max |out| {float(out.abs().max()):.3f}), bound "
        f"{moe_bound:.4f} ms ({moe_by}; 6 E C D F = {flops:.4g} FLOPs, "
        f"{wbytes / 1e9:.3f} GB of expert weights); {card}")
    del x, out
    free_cuda()
    busy, moe_s, n_ranges = _moe_profile(cfg, params, toks[:, :seq])
    share = ("not measured (the profiler put no device time on the MoE "
             "ranges)" if moe_s is None
             else f"{moe_s:.4f} s of {busy:.4f} s busy = {moe_s / busy:.4f}")
    log(f"olmoe MoE share of the prefill's device busy time: {share} "
        f"({n_ranges} layer ranges); {cfg.n_layers} x the layer's event "
        f"time = {cfg.n_layers * moe_ms / 1e3:.4f} s; {card}")
    expert_bytes = sum(
        w.numel() * w.element_size() for g in params["groups"].values()
        for lp in g.values() if "moe" in lp
        for k, w in lp["moe"].items() if k in ("wi_gate", "wi_up", "wo"))
    dec_bound = expert_bytes / HBM_BYTES_PER_S * 1e3
    log(f"olmoe times: prefill {batch} x {seq} bf16 through the kernels "
        f"{1e3 * t_prefill:.1f} ms host time; decode step (batch {batch}, "
        f"every expert read: C = T) bf16 {step_ms['bfloat16']:.2f} ms, f32 "
        f"{step_ms['float32']:.2f} ms host time, bound {dec_bound:.4f} ms "
        f"(bytes: {expert_bytes / 1e9:.2f} GB of expert weights a step); "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
        f" GiB; {card}")
    free_cuda()

    phase_dense_serve(cfg, params, card)
    try:
        ServeEngine(cfg, params, kv_store="paged", kv_storage="device",
                    device=DEV, page_size=PAGE, num_pages=64, max_batch=4)
    except ValueError as e:
        log(f"olmoe paged serving refused: ValueError: {e}")
    else:
        raise AssertionError("the paged path took an MoE config")
    del params
    free_cuda()
    return main_counts["flash_attention"]


# ----------------------------------------------------------------------------


def _model(cfg, note: str):
    log(f"model: {cfg.name} layers={cfg.n_layers} d_model={cfg.d_model} "
        f"heads={cfg.n_heads}/{cfg.n_kv_heads} d_ff={cfg.d_ff} "
        f"vocab={cfg.vocab} dtype={cfg.dtype} ({note})")
    t0 = time.monotonic()
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    params = init_params(cfg, gen, device=DEV)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"weights: {n_params} random bf16 parameters in "
        f"{time.monotonic() - t0:.1f} s")
    return params


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--smr-run"]:
        return smr_run_main(*sys.argv[2:4])
    if sys.argv[1:2] == ["--structures"]:
        phase_structures()      # the process start_structures starts
        return 0
    card = phase_card()
    structures = start_structures()      # host work, beside the card's
    try:
        phase_build()
        kres = phase_kernels()
    except BaseException:
        structures[0].kill()
        structures[0].wait()
        raise
    finish_structures(structures)

    cfg = starcoder2_7b.CONFIG
    params = _model(cfg, "no depth cut")
    launches = phase_serve(cfg, params, card)
    del params                 # the smr serve processes make their own
    free_cuda()
    phase_smr_serve()
    params = _model(cfg, "no depth cut, the same seed")
    phase_fleet_replay(cfg, params, card)
    phase_profile(cfg, params)
    phase_slice(cfg, params)
    phase_prefill_kv(cfg, params)
    del params
    free_cuda()

    cfg = zamba2_2p7b.CONFIG
    params = _model(cfg, "no depth cut")
    dense = phase_dense_prefill(cfg, params)
    for name in ("flash_attention", "linear_scan"):
        launches[name] = dense[name]
    phase_dense_serve(cfg, params, card)
    phase_dense_profile(cfg, params)
    del params
    free_cuda()

    cfg = rwkv6_1p6b.CONFIG
    params = _model(cfg, "no depth cut")
    phase_rwkv_prefill(cfg, params)
    del params
    free_cuda()

    # this slice's path runs flash at olmoe's shape: its line reads there
    launches["flash_attention"] = phase_olmoe(card)

    kernels = []
    for name in REPLACES:
        err_f32, t_f32 = kres[(name, torch.float32)]
        err_bf16, t_bf16 = kres[(name, torch.bfloat16)]
        if name == "paged_attention":
            ms, plain, bound, by, _ = t_bf16["decode"]
            lib = None
        elif name == "paged_scatter":
            ms, plain, bound, lib = t_bf16
            by = "bytes"
        elif name == "flash_attention":
            ms, plain, bound, by, lib = t_bf16["olmoe prefill"]
        else:
            ms, plain, bound, by, lib, _ = t_bf16["mamba2"]
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
