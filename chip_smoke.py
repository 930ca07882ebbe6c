#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU: build its kernels, hold
each against its plain PyTorch version, serve starcoder2-7b through the
paged runtime, run zamba2-2.7b's and rwkv6-1.6b's dense prefill through
the flash-attention and linear-scan kernels, serve zamba2-2.7b densely,
and compare every path's logits through the kernels with the same through
the plain versions.

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

The last two lines of standard output are the kernels' JSON line and the
device JSON line.  Without CUDA it exits non-zero before printing either.
"""

from __future__ import annotations

import ctypes
import gc
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.configs import (rwkv6_1p6b, starcoder2_7b,  # noqa: E402
                                 zamba2_2p7b)
from repro_torch.kernels import build, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import linear_scan as ls  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kernels.paged_attention import build_block_table  # noqa: E402
from repro_torch.models.model import (apply_model, init_cache,  # noqa: E402
                                      init_params)
from repro_torch.runtime.kv_store import PagedKVStore  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
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


def _engine(cfg, params):
    return ServeEngine(cfg, params, kv_store="paged", kv_storage="device",
                       device=DEV, smr="EpochPOP-pool", n_engines=2,
                       prefill_workers=1, prefix_cache=True, page_size=PAGE,
                       prefill_chunk=32, num_pages=POOL_PAGES, max_batch=8)


def phase_serve(cfg, params, card: str, max_new: int = 16):
    rng = np.random.default_rng(SEED + 1)
    prompts = _prompts(rng, cfg.vocab)
    eng = _engine(cfg, params)
    build.reset_launch_counts()
    t0 = time.monotonic()
    eng.start()
    reqs = [eng.submit(p, max_new=max_new) for p in prompts]
    for r in reqs:
        if not r.done.wait(timeout=900):
            raise AssertionError(f"request {r.rid} did not finish")
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    eng.stop()
    launches = dict(build.launch_counts)
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
                   top: int) -> None:
    """Device busy time and idle share over the window, host kernel
    launches and copies per forward, and the kernels that take the device
    time.  Only the device's
    own events count: a host op's row also carries the device time of the
    kernels it launched, which would count them twice."""
    from torch.autograd import DeviceType

    dev_us = _dev_us
    all_events = prof.key_averages()
    events = [e for e in all_events if e.device_type == DeviceType.CUDA]
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
            f"{float(b.abs().max()):.3f}; prefill host time kernels "
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
    """ServeEngine(kv_store="dense") on zamba2-2.7b: 6 requests of 32-96
    prompt tokens, 3 sharing a 32-token prefix (the first of them goes in
    alone until its prefix is published, so the other two can hit it).
    This path prefills token by token through decode mode, as the
    reference's dense engine does: it launches neither new kernel."""
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
    card = phase_card()
    phase_build()
    kres = phase_kernels()

    cfg = starcoder2_7b.CONFIG
    params = _model(cfg, "no depth cut")
    launches = phase_serve(cfg, params, card)
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
            ms, plain, bound, by, lib = t_bf16["zamba2 prefill"]
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
