#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU: build its kernels, hold
each against its plain PyTorch version, serve starcoder2-7b through the
paged runtime (under the native policy, under every SMR scheme of the
registry, and replaying a multi-tenant trace), run zamba2-2.7b's and
rwkv6-1.6b's dense prefill through the flash-attention and linear-scan
kernels, serve zamba2-2.7b densely, run olmoe-1b-7b's MoE model,
deepseek-v3's MLA (cut in depth), llama-3.2-vision's cross attention (cut
in depth) and whisper-small's encoder and decoder end to end, and compare
every path's logits through the kernels with the same through the plain
versions; train zamba2-2.7b, rwkv6-1.6b, deepseek-v3 (cut in depth) and
whisper-small through the kernels' gradients; run the sharded train step
(expert-parallel olmoe, context-parallel starcoder2 through the flash
kernel with its query offset), a sharded olmoe decode step, the int8 ring
all-reduce, the pipeline, the sharded loss and the dry-run on 8 ranks
sharing the card, and hold the dry-run's memory count to the card's
allocator; beside them, on the host, the paper's data-structure grid and
robustness gauntlet.

    python3 chip_smoke.py          # from the root of a checkout, one card
    python3 chip_smoke.py --dist   # the card, build, dist and dryrun memory alone
    python3 chip_smoke.py --runtime  # the card, build and runtime runs alone

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
              attention (``FLASH_SHAPES``: zamba2's prefill B=4, S=2048,
              H=Hkv=32, D=80, causal; a gemma2 local layer B=1, S=8192,
              H=32, Hkv=16, D=128, window 4096, softcap 50; olmoe's
              prefill; and the call shapes of phases 9-10: MLA B=2,
              S=2048, H=Hkv=128, D=192, Dv=128, causal; whisper's encoder
              B=4, S=1500, H=12, D=64, bidirectional, its decoder's self
              attention S=448, causal, and cross attention Sq=448,
              Sk=1500; llama-vision's self attention B=2, S=2048, H=64,
              Hkv=8, D=128, causal, and cross attention Sq=2048, Sk=1601;
              phase 11's deepseek MLA at B=2, S=1024 and its MTP block's
              attention, H=Hkv=128, D=Dv=56; phase 12's context-parallel
              shard (2, 256, 2048, 36, 4, 128, 128) at q_offset 0 and 1792,
              SDPA beside it with the offset mask; and the small edge cases of ``FLASH_EDGE_CASES``) within
              2e-5 (f32) / 2e-2 (bf16); the
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
   runtime d -- the same model and prompts (3-10 new tokens each, no
              prefix cache, reclaim at 4 retired pages) with decode worker
              0 stalled 50 ms mid-step every 4th step under EpochPOP-pool,
              HazardPtrPOP@vec and EBR@vec: no use-after-free, pings under
              the publish-on-ping schemes; retired peak, pings and the
              largest ping stall printed.
   runtime -- starcoder2-7b at full width cut to 4 of 32 layers, f32
              compute, each run against a baseline (the serve phase's
              engine, FIFO) on the same prompts: every request's tokens
              equal (a difference only at a near-tie of the baseline, top-2
              gap under 1e-4 of |top-1|, in one request at most), max_new
              tokens each, no use-after-free, no leaks, poisons == frees.
              a: 2 prefill workers, SJF, preemption at 32-token chunk
              boundaries, the 8 prompts and two of 2048 tokens
              (preemptions and queue reorders > 0); b: 4 engines, static
              placement skewed onto engine 0, migration (migrations and
              adopts > 0); c: host storage against device storage (KV bytes
              uploaded a step > 0 and 0); e: run a traced (the export
              validates); f: examples/serve_paged_torch.py as a user runs
              it, a process of its own beside a-e.  (g, after the train phase's tiny trainer: its
              checkpoint restored by a fresh Trainer and served, the tokens
              of the parameters in memory.)
   smr serve -- the traffic's first 2 prompts (sharing a prefix) at 4
              new tokens under every safe scheme
              of the SMR registry (SimulatedSMRPolicy, ``gen`` backend;
              the heavy schemes, HazardEraPOP, HP, HE, HPAsym and DEBRA+,
              on ``vec``, HP and HPAsym on the first prompt alone) and
              HazardPtrPOP and EpochPOP on ``vec``, in four processes
              at once (``chip_smoke.py --smr-run SCHEME BACKEND ...``:
              HP, HPAsym, and the others split over two): the same checks (NR: nothing freed), one line per
              run with tok/s, inter-token p50/p99, frees, pings,
              publishes, the largest ping stall and the policy's host
              time per decode step.
   fleet replay -- a trace of fleet_load.py's tenant mix (Poisson, 1.25
              requests/s for 4 s: 5 requests) replayed in real time under
              EpochPOP-pool, HazardPtrPOP and EBR, scored
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
              EpochPOP-pool, 2 decode engines, prefix cache, 4 requests;
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
9. mla     -- deepseek-v3-671b at full width (d=7168, 128 heads, MLA ranks
              1536/512, 256 experts top-8 + 1 shared, vocab 129280, MTP
              parameters), cut in depth from 3 dense + 58 MoE layers to 3
              dense + 1 MoE (15.8e9 parameters): make_prefill_step on 2 x
              2048 tokens (4 flash launches at D=192 / Dv=128), kernels vs
              plain in f32 and bf16 on the dense group alone (3 MLA
              layers) and on the 3 + 1 cut, where the f32 runs hold the
              expert weights in f32 for their span (cast at use, they
              would not fit beside the bf16 ones) and the plain f32 run's
              MoE routing is replayed in the others; three bf16 prefills
              bit-equal; 8 absorbed decode steps after the prefill vs the
              train-mode forward in f32 and bf16, on the dense group and
              on the 3 + 1 cut (there the f32 forward's routing replayed
              in the bf16 forward and in every decode step); 8 greedy
              make_serve_step steps on
              the 3 + 1 cut; flash at MLA's shape beside SDPA and its
              bound; prefill host and device busy time, decode step time
              against its bytes bound, peak memory; dense serving (4
              requests of 16-48 tokens, 8 new each); the paged path's
              ValueError.
10. cross  -- llama-3.2-vision-90b at full width (d=8192, 64/8 heads,
              d_ff=28672) cut from 20 pattern repeats to 2 (8 self + 2
              cross layers), 2 x 2048 tokens over 1601 image tokens (10
              flash launches a prefill); whisper-small whole (12 encoder +
              12 decoder patterns), 4 x 448 tokens over 1500 frames (36
              flash launches); frontends 0.02 N(0, 1) from the seed.  For
              each, kernels vs plain in bf16 and f32, 8 decode steps after
              the prefill vs the train-mode forward, flash at each of its
              call shapes beside SDPA and its bound, and the paged path's
              ValueError.
11. train  -- training through the kernels' autograd.Functions (kernel
              forward, plain VJP backward), each model in its own scope:
              zamba2-2.7b whole (remat "full", 4 x 2048 from the
              pipeline), rwkv6-1.6b whole, deepseek-v3 at full width cut
              to its first dense MLA layer with the MTP head (2 x 1024),
              whisper-small whole (4 x 448 over 1500 stub frames).  Each:
              loss_fn and its grads in f32 (leaves cast to f32) through
              the kernels vs the plain versions, every leaf the forward
              reads finite, nonzero and within 1e-3 relative (rwkv6: its
              first layer so; its first 6 layers' grads no further than
              2x the plain path's from the grads at the scan's f64
              forward, and every scan call's forward no further than
              1.1x the plain version's from f64); bf16
              Trainer steps with loss, step time, tokens/s, model TFLOP/s,
              launches a step and peak memory.  zamba2 also: launches a
              step exactly 2 x 9 flash and 2 x 54 scan calls (forward and
              remat recompute), one step of its first pattern repeat
              under torch.profiler (forward, backward, the plain VJPs'
              device time, AdamW), and one
              step's parameter delta kernels vs plain.  deepseek: a
              nonzero MTP loss and a nonzero grad on every ``mtp`` leaf.
              whisper: an async checkpoint at step 2 restored by a fresh
              Trainer, its final loss within 2e-2 of an uninterrupted run.
              Then examples/train_tiny_lm_torch.py's 200 steps: the loss
              drops; its checkpoint restored and served (runtime g).  Each train shape's plain VJP is timed beside its
              bound and, where SDPA computes the forward, SDPA's backward.
12. dist   -- distribution: 8 ranks (processes of their own) on the one
              card over gloo, the kernels built before by this process.
              Gloo's all-gather and send / recv on CUDA tensors are staged
              through host memory (``parallel/collectives.py``) and
              counted.  olmoe-1b-7b at full width cut to 1 layer on
              (data=2, model=4), expert parallel: loss_fn and its grads in
              f32 and bf16 against the unsharded run (rank 0), no token
              dropped and the aux losses off, the unsharded run's routing
              replayed: f32 loss and MoE outputs within 1e-4 relative,
              every grad within 1e-3; then one bf16 train step with the
              config's own capacity and aux.  The same olmoe on the same
              mesh, one decode step at B=8 after a 64-token prefill (no
              expert parallelism: each rank its own experts, every weight
              where it lies): logits and the written K/V against the
              unsharded step, f32 within 1e-4 relative, bf16 within
              max(5e-2, 2 x the unsharded bf16 step's own distance from
              f32), the unsharded f32 step's routing replayed.  The
              sharded layouts tests/test_torch_sharded_layout.py holds, at
              smoke width in f32 against the unsharded port (1e-4
              relative): llama-vision trained on (2, 4) (the "groups"
              layout: each rank its kv head) and zamba2 (Mamba2 by
              heads), each with a prefill's logits and cache;
              decode steps of starcoder2 (a cache sequence over model),
              deepseek (MLA's latent attention), rwkv6 at batch 1 on
              (4, 2) and zamba2 (stationary products) at batch 4 and at
              batch 1 (Mamba2 by heads, long_500k's case).  A sharded
              checkpoint: zamba2-smoke trained 2 steps on (2, 4), saved,
              restored onto (4, 2) with restore(shardings=), the third step
              against the uninterrupted run's (loss 1e-4, parameters 1e-4
              relative).
              starcoder2-7b at full width
              cut to 1 layer on (data=1, model=8), context parallel (36
              heads over 8): prefill logits (f32 1e-3, bf16 as the dense
              prefill checks) and an f32 step's grads (1e-3) against the
              unsharded ones, each rank's flash launches.  The int8 ring
              all-reduce (tests/test_parallel.py's bounds, and one olmoe
              layer's gradient size timed), the GPipe pipeline (4 stages
              x 2 replicas, d=4096, atol 1e-4), and six dry-run cells in
              subprocesses (rwkv6 decode_32k, whisper prefill_32k
              multi-pod, zamba2 and rwkv6 long_500k, their collective
              bytes within 1.10x of the reference's, gemma2 long_500k:
              SKIP, gemma2 prefill_32k multi-pod, its bytes, FLOPs and
              collective bytes a device within 1.10x of the
              reference's), each cell's FLOPs a device (the busiest of rank 0 and
              the last model position) and collective bytes beside the
              reference's dry-run of it (CPU counts).  The sharded loss: cross_entropy on f32
              logits (4, 128, 256000) laid out over (data=2, model=4)
              against the unsharded loss (value and gradient within
              1e-5 relative), its collectives as OpStats counts them
              (rows, never the logits).  The sharded step's memory
              count (``dist memory``): each rank's allocator peak over a
              bf16 value_and_grad of starcoder2-7b cut to 2 layers on
              (2, 4) within 15% of ``roofline/op_stats.py``'s live-bytes
              peak for the same call, the outputs of collectives among
              them; the same for a prefill of it without a gradient,
              where the embedding's lookup alone holds at most the rank's
              vocab slice, its output rows and its tokens' indices (the
              whole table before), its rows bit-equal to F.embedding on
              the whole table.  Then, in this process, the dry-run's memory count
              held to the card (``dryrun memory``): gemma2-27b at full
              width and vocab cut to a local and a global layer,
              unsharded bf16 at B=1, S=4096, value_and_grad alone and
              one train step; the card allocator's peak over each call
              (``max_memory_allocated`` less what was allocated before
              it) within 15% of the live-bytes peak for the same call on
              the meta device; a prefill of the same cut at B=1,
              S=32768 without a gradient (rms_norm in 4 row chunks, the
              residual sums in place), its peak 1.00-1.05x the count;
              and rms_norm at that size in chunks against one pass on
              the card (largest difference, bit equality).

After each group of phases a ``time: ... done at N s`` line gives the
time since the card phase began.  The last two lines of standard output
are the kernels' JSON line and the device JSON line.  Without CUDA it exits non-zero before printing either.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import gc
import io
import json
import math
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.configs import (deepseek_v3_671b,  # noqa: E402
                                 llama32_vision_90b, olmoe_1b_7b, rwkv6_1p6b,
                                 starcoder2_7b, whisper_small, zamba2_2p7b)
from repro_torch.configs.base import dense_stack  # noqa: E402
from repro_torch.configs.registry import get_smoke_config  # noqa: E402
from repro_torch.core.gauntlet import (gauntlet_cell,  # noqa: E402
                                       run_gauntlet, summarize)
from repro_torch.core.smr.registry import PAPER_SET  # noqa: E402
from repro_torch.core.workload import STRUCTURES, run_trial  # noqa: E402
from repro_torch.kernels import build, ref  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import linear_scan as ls  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kernels.paged_attention import build_block_table  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as model_mod  # noqa: E402
from repro_torch.models.model import (apply_model, init_cache,  # noqa: E402
                                      init_params, params_logical_axes,
                                      unstack)
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models.moe import apply_moe, capacity  # noqa: E402
from repro_torch.obs import SLOSpec, SLOTracker, Tracer  # noqa: E402
from repro_torch.obs.trace import validate_trace  # noqa: E402
from repro_torch.parallel import collectives  # noqa: E402
from repro_torch.parallel import sharding as sh  # noqa: E402
from repro_torch.parallel.compression import (compress_with_feedback,  # noqa: E402
                                              compressed_psum)
from repro_torch.parallel.pipeline import (make_mlp_stage,  # noqa: E402
                                           pipeline_forward)
from repro_torch.runtime.block_pool import BlockPool  # noqa: E402
from repro_torch.runtime.kv_store import PagedKVStore  # noqa: E402
from repro_torch.runtime.reclaim import (make_policy,  # noqa: E402
                                        supported_schemes)
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.serve.loadgen import (TenantSpec, WorkloadSpec,  # noqa: E402
                                       generate, replay)
from repro_torch.serve.paged_model import (paged_decode_step,  # noqa: E402
                                           prefill_kv, prefill_kv_chunked)
from repro_torch.data.pipeline import DataConfig, TokenPipeline  # noqa: E402
from repro_torch.optim.adamw import (adamw_init, adamw_update,  # noqa: E402
                                     cosine_schedule, tree_leaves, tree_map)
from repro_torch.train.checkpoint import flatten_with_paths  # noqa: E402
from repro_torch.train.train_step import (grad_tree, loss_fn,  # noqa: E402
                                          make_prefill_step, make_serve_step,
                                          make_train_step, value_and_grad,
                                          with_grad)
from repro_torch.train.trainer import (Trainer, TrainerConfig,  # noqa: E402
                                       stub_frontend)

sys.path.insert(0, str(Path(__file__).resolve().parent / "examples"))
import train_tiny_lm_torch as tiny_lm  # noqa: E402

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
    # the attention launch with the decode / chunk write folded in: it
    # takes the scatter's place on the serving path
    "paged_attention+write": "src/repro/kernels/paged_attention.py:176",
    "paged_scatter": "src/repro/kernels/paged_attention.py:176",
    "flash_attention": "src/repro/kernels/flash_attention.py:94",
    "linear_scan": "src/repro/kernels/linear_scan.py:81",
}
SOURCES = {name: f"src/repro_torch/kernels/csrc/{name.split('+')[0]}.cu"
           for name in REPLACES}
#: the paged serving path's launch counts
PAGED_KERNELS = ("paged_attention", "paged_attention+write", "paged_scatter")


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


PROFILE_TRIES = 3   # a trace that lost every kernel record is taken again


def device_ms(fn, names, calls: int = 20):
    """Device milliseconds per call of ``fn`` of the kernels whose names
    contain one of ``names``, from torch.profiler's kernel times (the
    wrapper's host work excluded), and each kernel's share:
    ``(total, {kernel: ms per call})``.  A trace with no such kernel is
    taken again, at most PROFILE_TRIES times (the card's CUPTI tracing
    has been seen to drop a whole window's kernel records), and said
    so."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(1, PROFILE_TRIES + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        per = {}
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA and any(n in e.key
                                                        for n in names):
                key = re.sub(r"^void |\(anonymous namespace\)::|\(.*$",
                             "", e.key)
                per[key] = per.get(key, 0.0) + _dev_us(e) / 1e3 / calls
        if per:
            return sum(per.values()), per
        log(f"  the profiler saw no kernel named {names} (trace {attempt} "
            f"of {PROFILE_TRIES})")
    raise AssertionError(f"the profiler saw no kernel named {names}")


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


def _att_bound_ms(table, lengths, elem: int, B: int, dtype, T: int = 0):
    """Least time for the work these inputs need: the live K/V token rows
    (each distinct (page, slot) once), q and out, over HBM bandwidth; vs
    4 * G * D flops per (row, kv head, live position) at the pages' type's
    peak rate.  With ``T`` new rows written in the same launch: each live
    slot still once (read from the pool, or written there), the new rows
    read once, and their index and the rows' new_lo / new_base."""
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
    bytes_ += 2 * T * HKV * D * elem + (2 * T + 2 * B) * 4 if T else 0
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
    dev, _ = device_ms(lambda: pa.paged_scatter_indexed(kp, vp, index, kv1,
                                                        vv1, layer=5),
                       ("paged_scatter_kernel",))
    bound = (2 * 2 * T * HKV * D * kp.element_size() + 2 * T * 4) \
        / HBM_BYTES_PER_S * 1e3
    log(f"  paged_scatter {str(dtype)[6:]} T={T} one layer: prepared index "
        f"{ms:.4f} ms (event time of a wrapper call), device {dev:.4f} ms a "
        f"launch (profiler), numpy indices {numpy_ms:.4f} ms, plain "
        f"{plain:.4f} ms, index_put_ x2 {lib:.4f} ms, bound {bound:.6f} ms; "
        f"prepared no slower than index_put_ x2: {ms <= lib}")
    del kp, vp, kr, vr
    torch.cuda.empty_cache()
    return 0.0, (ms, plain, bound, lib, dev)


def _fused_cases(rng):
    """The fused write's cases: name -> (blocks per row, stored lengths
    before the write, new_lo, new_base, pages that are fresh).  Decode
    B=8: the timed decode case's lengths with one token each (rows 4-7
    share a 4-page prefix; row 2's token opens a fresh page); the
    prefill chunk: 32 rows over one table, positions 96..127; long
    context: LONG_ROWS with the last token of each row new."""
    att = [1, 2, 17, 64, 100, 129, 200, 250]
    own = _decode_rows(rng, [a - 64 if b >= 4 else a
                             for b, a in enumerate(att)] + [64])
    prefix = own.pop()
    blocks = [bl if b < 4 else prefix + bl for b, bl in enumerate(own)]
    stored = [a - 1 for a in att]
    chunk_blocks = _decode_rows(rng, [128])[0]
    long_stored = [n - 1 for n in LONG_ROWS]
    return {
        "decode": (blocks, stored, stored, list(range(8)), [blocks[2][1]]),
        "prefill_chunk": ([chunk_blocks] * 32, list(range(96, 128)),
                          [96] * 32, [0] * 32, []),
        "long_context": (_decode_rows(rng, LONG_ROWS), long_stored,
                         long_stored, list(range(8)), []),
    }


def check_fused(rng, dtype):
    """The attention launch with the write folded in against the
    standalone scatter followed by the attention alone (two launches),
    bit-equal for pools and outputs, and within ATT_TOL of its plain
    version, at decode B=8, chunk B=32 and long context; then each timed
    beside the pair and the attention alone on the same inputs (event
    time of a wrapper call, device time a launch from the profiler)."""
    kp, vp = _pages(rng, dtype)
    scale = 1.0 / math.sqrt(D)
    tol = ATT_TOL[dtype]
    elem = kp.element_size()
    worst, times = 0.0, {}
    for name, (blocks, stored, lo, base, fresh) in _fused_cases(rng).items():
        if fresh:       # a freshly allocated page, as on_alloc leaves it
            kp[fresh] = 0
            vp[fresh] = 0
        B = len(blocks)
        if name == "prefill_chunk":
            pos = np.asarray(stored)
            blk = np.asarray(blocks[0])[pos // PAGE]
        else:
            blk = [bl[n // PAGE] for bl, n in zip(blocks, stored)]
        slot = np.asarray(stored) % PAGE
        att = [n + 1 for n in stored]
        table, lens = build_block_table(blocks, att, page=PAGE, device=DEV)
        wi = pa.write_index(blk, slot, lo, base, num_blocks=POOL_PAGES,
                            page=PAGE, device=DEV)
        T = wi.index.T
        q = torch.from_numpy(rng.standard_normal((B, H, D),
                                                 np.float32)).to(DEV)
        kn, vn = (torch.from_numpy(rng.standard_normal((T, HKV, D),
                                                       np.float32))
                  .to(DEV, dtype) for _ in range(2))
        write = (wi.index, kn, vn, wi.new_lo, wi.new_base)
        kf, vf, k2, v2 = kp.clone(), vp.clone(), kp.clone(), vp.clone()
        got = pa.paged_attention(q, kf, vf, table, lens, scale=scale,
                                 write=write)

        def pair():
            pa.paged_scatter_indexed(k2[None], v2[None], wi.index, kn, vn,
                                     layer=0)
            return pa.paged_attention(q, k2, v2, table, lens, scale=scale)

        two = pair()
        kr, vr = kp.clone(), vp.clone()
        want = ref.paged_attention_write_ref(q, kr, vr, table, lens,
                                             wi.index.idx[0],
                                             wi.index.idx[1], kn, vn,
                                             scale=scale)
        torch.cuda.synchronize()
        same = (torch.equal(got, two) and torch.equal(kf, k2)
                and torch.equal(vf, v2))
        err = float((got - want).abs().max())
        pools_plain = torch.equal(kf, kr) and torch.equal(vf, vr)
        log(f"  paged_attention+write {str(dtype)[6:]} {name} B={B} T={T}: "
            f"vs standalone scatter + attention: pools and output bit-equal "
            f"{same}; vs plain max |err| {err:.3e} (tol {tol:g}), pools "
            f"bit-equal {pools_plain}")
        if not (same and pools_plain and err <= tol):
            raise AssertionError(f"paged_attention+write {name} {dtype}: "
                                 f"bit-equal {same}, pools {pools_plain}, "
                                 f"err {err}")
        worst = max(worst, err)

        fused = lambda: pa.paged_attention(q, kf, vf, table, lens,
                                           scale=scale, write=write)
        alone = lambda: pa.paged_attention(q, kf, vf, table, lens,
                                           scale=scale)
        ms, pair_ms, att_ms = cuda_ms(fused), cuda_ms(pair), cuda_ms(alone)
        dev, _ = device_ms(fused, ("paged_attention_kernel",))
        pair_dev, per = device_ms(pair, ("paged_attention_kernel",
                                         "paged_scatter_kernel"))
        att_dev, _ = device_ms(alone, ("paged_attention_kernel",))
        plain = cuda_ms(lambda: ref.paged_attention_write_ref(
            q, kr, vr, table, lens, wi.index.idx[0], wi.index.idx[1], kn,
            vn, scale=scale), *((10, 2) if name == "long_context" else ()))
        bound, by = _att_bound_ms(table, lens, elem, B, dtype, T)
        split = ", ".join(f"{k.split('<')[0].split('::')[-1]} {v:.4f}"
                          for k, v in sorted(per.items()))
        times[name] = (ms, plain, bound, by, dev, att_ms, att_dev, pair_ms,
                       pair_dev)
        log(f"  paged_attention+write {str(dtype)[6:]} {name} B={B}: fused "
            f"{ms:.4f} ms (event time of a wrapper call), device {dev:.4f} "
            f"ms a launch (profiler); attention alone {att_ms:.4f} / "
            f"{att_dev:.4f} ms; standalone scatter + attention "
            f"{pair_ms:.4f} ms, device {pair_dev:.4f} ms ({split}); plain "
            f"{plain:.4f} ms; bound {bound:.6f} ms ({by})")
        del kf, vf, k2, v2, kr, vr
    del kp, vp
    torch.cuda.empty_cache()
    return worst, times


FLASH_SHAPES = {
    # name: (B, Sq, Sk, H, Hkv, D, Dv, causal, window, softcap)
    "zamba2 prefill": (4, 2048, 2048, 32, 32, 80, 80, True, 0, 0.0),
    "gemma2 local": (1, 8192, 8192, 32, 16, 128, 128, True, 4096, 50.0),
    "olmoe prefill": (4, 2048, 2048, 16, 16, 128, 128, True, 0, 0.0),
    # this slice's callers: MLA's explicit form, an encoder's bidirectional
    # self attention, cross attention over a frontend's tokens, GQA
    "deepseek MLA": (2, 2048, 2048, 128, 128, 192, 128, True, 0, 0.0),
    "whisper encoder": (4, 1500, 1500, 12, 12, 64, 64, False, 0, 0.0),
    "whisper self": (4, 448, 448, 12, 12, 64, 64, True, 0, 0.0),
    "whisper cross": (4, 448, 1500, 12, 12, 64, 64, False, 0, 0.0),
    "llama-vision self": (2, 2048, 2048, 64, 8, 128, 128, True, 0, 0.0),
    "llama-vision cross": (2, 2048, 1601, 64, 8, 128, 128, False, 0, 0.0),
    # the train phase's own: deepseek's MLA at its train length, and the
    # MTP block's standard attention (D = 56, the guarded instantiation)
    "deepseek MLA train": (2, 1024, 1024, 128, 128, 192, 128, True, 0, 0.0),
    "deepseek MTP": (2, 1024, 1024, 128, 128, 56, 56, True, 0, 0.0),
}
# the dist phase's context-parallel shards: starcoder2-7b's 36 heads over
# model=8 at B=2, S=2048, each rank's 256 query rows against all 2048 keys,
# at the first and the last shard's offset: name -> (shape, q_offset)
FLASH_CP_SHAPES = {
    "starcoder2 CP shard 0": ((2, 256, 2048, 36, 4, 128, 128, True, 0, 0.0),
                              0),
    "starcoder2 CP shard 7": ((2, 256, 2048, 36, 4, 128, 128, True, 0, 0.0),
                              1792),
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


def flash_work(shape, q_offset: int = 0):
    """(bytes, operations) of one flash call at a FLASH_SHAPES entry, for
    an element size of 1: each input read once -- of K and V only the rows
    some query sees, from the lowest row's window start to the highest
    row's position when causal (the kernel loads no other) -- and the
    output written once; 2 (D + Dv) operations per unmasked (query, key,
    head), the query rows at ``q_offset`` on."""
    B, Sq, Sk, H, Hkv, D, Dv, causal, window, _ = shape
    hi = min(Sk, q_offset + Sq) if causal else Sk
    lo = max(q_offset - window + 1, 0) if window else 0
    elems = B * (Sq * H * D + (hi - lo) * Hkv * (D + Dv) + Sq * H * Dv)
    pairs = kops.flash_pairs(Sq, Sk, causal, window, q_offset)
    return elems, 2 * (D + Dv) * B * H * pairs


def check_flash(g, dtype):
    """Flash attention against its plain version at the main paths' shapes
    (``FLASH_SHAPES``) and the edge cases; returns the worst error and, per
    shape, the kernel / plain / bound / SDPA times."""
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
    cases = [(name, shape, 0) for name, shape in FLASH_SHAPES.items()] + [
        (name, shape, off) for name, (shape, off) in FLASH_CP_SHAPES.items()]
    for name, shape, off in cases:
        B, Sq, Sk, H, Hkv, D, Dv, causal, window, cap = shape
        q = _randn(g, (B, Sq, H, D), dtype)
        k = _randn(g, (B, Sk, Hkv, D), dtype)
        v = _randn(g, (B, Sk, Hkv, Dv), dtype)
        kw = dict(causal=causal, window=window, softcap=cap)
        if off:
            kw["q_offset"] = off
        got = fa.flash_attention(q, k, v, **kw)
        want = ref.flash_attention_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        err, ok = within(got, want, tol)
        log(f"  flash_attention {str(dtype)[6:]} {name} {shape}"
            f"{f' q_offset {off}' if off else ''}: max |err| "
            f"{err:.3e} (tol {tol:g} abs + rel)")
        if not ok:
            raise AssertionError(f"flash_attention {name} {dtype}: {err}")
        worst = max(worst, err)
        ms = cuda_ms(lambda: fa.flash_attention(q, k, v, **kw), 10, 2)
        plain = cuda_ms(lambda: ref.flash_attention_ref(q, k, v, **kw), 3, 1)
        elems, flops = flash_work(shape, off)
        bound, by = bound_ms(elems * q.element_size(), flops, dtype)
        lib = None
        if off:
            # the shard's causal mask at its offset, explicit
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            mask = (torch.arange(Sk, device=DEV)[None, :]
                    <= torch.arange(Sq, device=DEV)[:, None] + off)
            lib = cuda_ms(lambda: torch.nn.functional
                          .scaled_dot_product_attention(
                              qt, kt, vt, attn_mask=mask,
                              enable_gqa=H != Hkv), 10, 2)
            del qt, kt, vt, mask
        elif not window and not cap:
            # the same function in one PyTorch call, as a yardstick only
            # (its efficient backends take Dv != D, Sq != Sk and GQA)
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            lib = cuda_ms(lambda: torch.nn.functional
                          .scaled_dot_product_attention(
                              qt, kt, vt, is_causal=causal,
                              enable_gqa=H != Hkv), 10, 2)
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
        results[("paged_attention+write", dtype)] = check_fused(rng, dtype)
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


def _engine(cfg, params, smr: str = "EpochPOP-pool", backend: str = "gen",
            **kw):
    """The serve phase's engine (``kw`` overrides an option)."""
    opts = dict(kv_store="paged", kv_storage="device", device=DEV, smr=smr,
                sim_backend=backend, n_engines=2, prefill_workers=1,
                prefix_cache=True, page_size=PAGE, prefill_chunk=32,
                num_pages=POOL_PAGES, max_batch=8)
    opts.update(kw)
    return ServeEngine(cfg, params, **opts)


def _serve(eng, prompts, max_new: int, label: str):
    """Start ``eng``, submit ``prompts`` at ``max_new`` tokens each (or
    each its own, from a list), wait for every request, stop: (requests,
    wall seconds, kernel launches)."""
    news = max_new if isinstance(max_new, list) else [max_new] * len(prompts)
    build.reset_launch_counts()
    t0 = time.monotonic()
    eng.start()
    reqs = [eng.submit(p, max_new=n) for p, n in zip(prompts, news)]
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
        # device storage: every decode / chunk write goes into its layer's
        # attention launch
        "paged_attention+write launched":
            launches["paged_attention+write"] > 0,
        "no standalone paged_scatter launch": launches["paged_scatter"] == 0,
        "no paged_attention launch without its write":
            launches["paged_attention"] == 0,
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
# 4a. runtime: the serving runtime's options on the card
# ----------------------------------------------------------------------------

#: the f32 runs' cut: starcoder2-7b at full width, 4 of its 32 layers
RUNTIME_LAYERS = 4
RUNTIME_MAX_NEW = 8
RUNTIME_LONG = 2048              # run a's two long prompts, tokens each
#: a differing request is accepted only where the baseline's top-2 logit
#: gap at its first differing step is under this share of |top-1 logit|
NEAR_TIE = 1e-4
#: the stalled-reader runs (d): scheme, backend
STALL_RUNS = (("EpochPOP-pool", "gen"), ("HazardPtrPOP", "vec"),
              ("EBR", "vec"))
POP_SCHEMES = ("EpochPOP-pool", "HazardPtrPOP", "HazardEraPOP", "EpochPOP")
STALL_MAX_NEW = (3, 4, 5, 6, 7, 8, 9, 10)


def _runtime_prompts(rng, vocab, long_len: int = RUNTIME_LONG):
    """(two prompts of ``long_len`` tokens, the serve phase's 8)."""
    short = _prompts(rng, vocab)
    long = [rng.integers(1, vocab, long_len).tolist() for _ in range(2)]
    return long, short


def _run_stream(eng, long, short, max_new: int, label: str,
                chunk: int = 32, fillers: int = 0):
    """Start ``eng``; submit the long prompts, wait until each has a chunk
    in its pages (so a shorter prompt can preempt it), then the short
    ones, each after ``fillers`` empty requests (which static placement
    puts on the other engines: every real request's rid is then a multiple
    of ``fillers + 1``); wait for all, stop.  Returns (the real requests,
    wall seconds, kernel launches)."""
    build.reset_launch_counts()
    t0 = time.monotonic()
    eng.start()
    reqs = [eng.submit(p, max_new=max_new) for p in long]
    deadline = time.monotonic() + 120
    while (any(r.prefilled < chunk and not r.done.is_set() for r in reqs)
           and time.monotonic() < deadline):
        time.sleep(0.001)
    pads = []
    for p in short:
        pads += [eng.submit([], max_new=1) for _ in range(fillers)]
        reqs.append(eng.submit(p, max_new=max_new))
    for r in reqs + pads:
        if not r.done.wait(timeout=900):
            raise AssertionError(f"{label}: request {r.rid} did not finish")
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    eng.stop()
    return reqs, wall, dict(build.launch_counts)


@torch.no_grad()
def _same_tokens(cfg, params, base, got):
    """(ok, note): ``got``'s tokens against the baseline's, request by
    request.  A request that differs is accepted only at a near-tie of the
    baseline (its top-2 logit gap at the first differing step, from a
    full-sequence forward of the prompt and the baseline's tokens before
    it, under NEAR_TIE of |top-1|), and in one request at most."""
    diffs = []
    for b, g in zip(base, got):
        n = min(len(b.out), len(g.out))
        if b.out[:n] == g.out[:n]:
            continue
        k = next(i for i in range(n) if b.out[i] != g.out[i])
        toks = torch.tensor([b.prompt + b.out[:k]], device=DEV)
        logits = apply_model(params, toks, cfg=cfg, mode="prefill")[0]
        top = torch.topk(logits[0, -1, :cfg.vocab].float(), 2).values
        gap = float(top[0] - top[1])
        diffs.append((b.rid, k, gap, gap / max(abs(float(top[0])), 1e-30)))
    ok = len(diffs) <= 1 and all(rel < NEAR_TIE for *_, rel in diffs)
    if not diffs:
        return ok, f"tokens equal the baseline's in {len(got)} requests"
    return ok, "tokens differ from the baseline's in " + "; ".join(
        f"rid {rid} at step {k} (the baseline's top-2 gap {gap:.3e}, "
        f"{rel:.2e} of |top-1|, near-tie tol {NEAR_TIE:g})"
        for rid, k, gap, rel in diffs)


def _runtime_checks(eng, reqs, launches, max_new: int, host: bool = False):
    """The serve phase's checks of a run (every request ``max_new``
    tokens, no engine error, so no use-after-free; after eviction and a
    flush no leaks and poisons == frees; the fused launch alone).  Host
    storage uploads KV bytes every step instead of none, and its pages,
    in host memory, are written there: the attention launches alone, and
    neither the scatter kernel nor the fused write, which write device
    pages, is launched."""
    checks = _serve_checks(eng, reqs, launches, [max_new] * len(reqs))
    if host:
        for k in ("bytes_h2d_per_step == 0", "paged_attention+write launched",
                  "no paged_attention launch without its write"):
            del checks[k]
        checks["bytes_h2d_per_step > 0"] = \
            eng.kv_copy_stats()["bytes_h2d_per_step"] > 0
        checks["paged_attention launched"] = launches["paged_attention"] > 0
        checks["pages written in host memory"] = (
            launches["paged_scatter"] == launches["paged_attention+write"]
            == 0)
    return checks


def _runtime_line(label: str, checks: dict, extra: str, card: str) -> None:
    ok = all(checks.values())
    failed = [k for k, v in checks.items() if not v]
    log(f"runtime {label}: {extra}; checks {len(checks)} passed"
        f"{'' if ok else f', FAILED {failed}'}; {card}: {ok}")
    if not ok:
        raise AssertionError(f"runtime {label}: {failed}")


def _chunk_ms(cfg, params, tokens, chunk: int = 32) -> float:
    """One ``chunk``-token prefill forward through the paged kernels into
    a scratch store (after one warm-up), host clock around a sync."""
    store = PagedKVStore(cfg, 8, PAGE, storage="device", device=DEV)
    blocks = list(range(-(-chunk // PAGE)))
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in prefill_kv_chunked(params, cfg, store, blocks,
                                    tokens[:chunk], chunk):
            pass
        torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0)


def _runtime_runs(cfg, params, card: str, long_len: int,
                  max_new: int) -> dict:
    """Runs a-c and e, each against the baseline: the serve phase's engine
    (FIFO) on the same prompts, in ``cfg``'s f32.  Returns the paged
    kernels' launches over the runs."""
    long, short = _runtime_prompts(np.random.default_rng(SEED + 2),
                                   cfg.vocab, long_len)
    seq = long_len + 64
    total = dict.fromkeys(PAGED_KERNELS, 0)

    def add(launches):
        for k in total:
            total[k] += launches.get(k, 0)

    def lat(eng) -> str:
        snap = eng.metrics.snapshot().get("tok_latency_s", {})
        return (f"inter-token p50 {1e3 * snap.get('p50', float('nan')):.2f}"
                f" ms p99 {1e3 * snap.get('p99', float('nan')):.2f} ms")

    base_eng = _engine(cfg, params, max_seq=seq)
    base, wall, launches = _run_stream(base_eng, long, short, max_new,
                                       "baseline")
    add(launches)
    checks = _runtime_checks(base_eng, base, launches, max_new)
    base_h2d = base_eng.kv_copy_stats()["bytes_h2d_per_step"]
    _runtime_line(
        "baseline (FIFO, 2 decode engines, 1 prefill worker)", checks,
        f"{len(base)} requests ({len(long)} of {long_len} tokens) x "
        f"{max_new} new in {wall:.2f} s; {lat(base_eng)}", card)
    del base_eng
    free_cuda()

    # a. the async prefill stage, SJF, preemption at chunk boundaries
    eng = _engine(cfg, params, max_seq=seq, prefill_workers=2,
                  sched_policy="sjf", preempt_prefill=True)
    reqs, wall, launches = _run_stream(eng, long, short, max_new, "a")
    add(launches)
    stall = eng.pool.stats.max_ping_stall_s     # before the checks' flush
    same, note = _same_tokens(cfg, params, base, reqs)
    checks = _runtime_checks(eng, reqs, launches, max_new)
    sched = eng.scheduler
    checks.update({"tokens": same, "preemptions > 0": sched.preemptions > 0,
                   "queue_reorders > 0": sched.queue_reorders > 0})
    _runtime_line(
        "a prefill_workers=2 chunk=32 sjf preempt_prefill", checks,
        f"{note}; preemptions {sched.preemptions}, queue reorders "
        f"{sched.queue_reorders}; max ping stall {1e3 * stall:.3f} ms "
        f"beside one 32-token chunk's "
        f"forward {_chunk_ms(cfg, params, short[4]):.3f} ms; {wall:.2f} s",
        card)
    del eng
    free_cuda()

    # b. static placement skewed onto engine 0, the migration monitor
    eng = _engine(cfg, params, max_seq=seq, n_engines=4, max_batch=2,
                  place_policy="static", migrate=True, migrate_threshold=2)
    reqs, wall, launches = _run_stream(eng, [], short, max_new, "b",
                                       fillers=3)
    add(launches)
    same, note = _same_tokens(cfg, params, base[len(long):], reqs)
    checks = _runtime_checks(eng, reqs, launches, max_new)
    sched, st = eng.scheduler, eng.pool.stats
    checks.update({"tokens": same, "migrations > 0": sched.migrations > 0,
                   "adopts > 0": st.adopts > 0})
    _runtime_line(
        "b n_engines=4 place_policy=static migrate migrate_threshold=2",
        checks, f"{note}; every request's rid a multiple of 4 (3 empty "
        f"requests before each); migrations {sched.migrations}, adopts "
        f"{st.adopts} ({st.adopted_blocks} blocks), stale_handoffs "
        f"{st.stale_handoffs}; {wall:.2f} s", card)
    del eng
    free_cuda()

    # c. host storage against device storage, the 4 prompts that share
    # no prefix (host storage uploads every layer's whole pool a forward)
    runs = {}
    for storage in ("device", "host"):
        eng = _engine(cfg, params, max_seq=seq, kv_storage=storage)
        reqs, wall, launches = _run_stream(eng, [], short[4:], max_new,
                                           f"c {storage}")
        add(launches)
        checks = _runtime_checks(eng, reqs, launches, max_new,
                                 host=storage == "host")
        runs[storage] = (reqs, checks, eng.kv_copy_stats(), lat(eng), wall)
        del eng
        free_cuda()
    same, note = _same_tokens(cfg, params, base[len(long) + 4:],
                              runs["host"][0])
    same_dev, _ = _same_tokens(cfg, params, runs["device"][0],
                               runs["host"][0])
    checks = {f"host {k}": v for k, v in runs["host"][1].items()}
    checks.update({f"device {k}": v for k, v in runs["device"][1].items()})
    checks.update({"tokens": same and same_dev,
                   "baseline bytes_h2d_per_step == 0": base_h2d == 0})
    h, d = runs["host"][2], runs["device"][2]
    _runtime_line(
        "c kv_storage=host vs device", checks,
        f"{note}; bytes_h2d per decode step host "
        f"{h['bytes_h2d_per_step']:.0f}, device {d['bytes_h2d_per_step']:.0f}"
        f"; host {runs['host'][3]} ({runs['host'][4]:.2f} s), device "
        f"{runs['device'][3]} ({runs['device'][4]:.2f} s)", card)
    del runs
    free_cuda()

    # e. run a again at 4 new tokens, traced
    tracer = Tracer()
    eng = _engine(cfg, params, max_seq=seq, prefill_workers=2,
                  sched_policy="sjf", preempt_prefill=True, trace=tracer)
    reqs, wall, launches = _run_stream(eng, long, short, 4, "e")
    add(launches)
    same, note = _same_tokens(cfg, params, base, reqs)
    checks = _runtime_checks(eng, reqs, launches, 4)
    path = Path(tempfile.mkdtemp(prefix="chip_smoke_trace_")) / "serve.json"
    try:
        obj = tracer.export(str(path))
        with open(path) as f:
            evs = validate_trace(json.load(f))
    finally:
        shutil.rmtree(path.parent, ignore_errors=True)
    names = [e["name"] for e in evs]
    checks.update({"tokens": same,
                   "trace validates": len(evs) == len(obj["traceEvents"]) > 0,
                   "prefill_chunk spans": "prefill_chunk" in names})
    _runtime_line(
        "e run a at 4 new tokens, trace=Tracer()", checks,
        f"{note}; {len(evs)} trace events, {names.count('pop_pass')} "
        f"pop_pass spans, {names.count('prefill_chunk')} prefill_chunk; "
        f"{wall:.2f} s", card)
    del eng, tracer, obj, evs
    free_cuda()
    return total


def phase_runtime(cfg, params, card: str, long_len: int = RUNTIME_LONG,
                  max_new: int = RUNTIME_MAX_NEW) -> dict:
    """The serving runtime's options on the card: runs a-c and e
    (:func:`_runtime_runs`), with run f's process beside them.  Returns
    the paged kernels' launches over the runs."""
    t_phase = time.monotonic()
    example = start_example()
    try:
        total = _runtime_runs(cfg, params, card, long_len, max_new)
    except BaseException:
        example[0].kill()          # stop the example's process too
        example[0].wait()
        raise
    finish_example(card, example)
    log(f"time: runtime a-c, e, f {time.monotonic() - t_phase:.1f} s")
    return total


def phase_stalled_reader(cfg, params, card: str,
                         max_new: tuple = STALL_MAX_NEW) -> dict:
    """Run d: the serve phase's model and prompts with decode worker 0
    stalled ``stall_s`` = 50 ms mid-step (its reader session open) every
    4th step, under EpochPOP-pool, HazardPtrPOP@vec and EBR@vec: the
    paper's delayed reader on device pages.  The requests ask for 3-10 new
    tokens (they finish, and retire their pages, one after another, while
    the stalls go on), no prefix cache holds their pages, and the pool
    reclaims at 4 retired pages (the serve phase's: 16, and
    publish-on-ping at 32), so a stall meets garbage.
    Returns the paged kernels' launches over the runs."""
    prompts = _prompts(np.random.default_rng(SEED + 1), cfg.vocab)
    max_new = list(max_new)
    total = dict.fromkeys(PAGED_KERNELS, 0)
    for scheme, backend in STALL_RUNS:
        pool = BlockPool(POOL_PAGES, n_engines=4, reclaim_threshold=4,
                         pressure_factor=1, ping_timeout_s=1.0,
                         policy=make_policy(scheme, backend=backend))
        eng = _engine(cfg, params, smr=None, backend="gen", pool=pool,
                      prefix_cache=False, stall_every=4, stall_s=0.05,
                      stall_workers=[0])
        reqs, wall, launches = _serve(eng, prompts, max_new,
                                      f"{scheme}@{backend}")
        for k in total:
            total[k] += launches.get(k, 0)
        st = eng.pool.stats
        # the run's own: the checks' flush after stop pings stopped threads
        stall, pings, peak = st.max_ping_stall_s, st.pings, st.retired_peak
        checks = _serve_checks(eng, reqs, launches, max_new)
        checks["stalls injected"] = eng.injected_stalls > 0
        if scheme in POP_SCHEMES:
            checks["pings > 0"] = pings > 0
        _runtime_line(
            f"d stalled reader {scheme}@{backend} (worker 0, 50 ms every "
            f"4th step)", checks,
            f"{eng.injected_stalls} stalls; retired_peak {peak}, freed "
            f"{st.freed}, pings {pings}, max ping stall {1e3 * stall:.3f} "
            f"ms (the run's, before the checks' flush); {wall:.2f} s", card)
        del eng
        free_cuda()
    return total


def start_example():
    """Run f: ``examples/serve_paged_torch.py`` as a user runs it, on the
    card, in a process of its own, started beside runs a-e (it takes ~20
    s, 5 of them its own shutdown flush waiting out a ping timeout, as the
    reference script's does).  Returns what :func:`finish_example`
    reads."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_example_")
    cmd = [sys.executable, str(ROOT / "examples" / "serve_paged_torch.py"),
           "--kv-store", "paged", "--prefix-cache", "--engines", "2",
           "--prefill-workers", "2", "--trace", f"{tmp}/serve.json"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = open(f"{tmp}/out.txt", "w+")
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=out,
                            stderr=subprocess.STDOUT, text=True)
    return proc, out, tmp, time.monotonic()


def finish_example(card: str, started) -> None:
    proc, out, tmp, t0 = started
    try:
        try:
            proc.wait(timeout=600)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            raise
        out.seek(0)
        lines = out.read().strip().splitlines()
    finally:
        out.close()
        shutil.rmtree(tmp, ignore_errors=True)
    said = [ln for ln in lines if ln.startswith(("trace:", "prefill stage:"))]
    checks = {"exit 0": proc.returncode == 0,
              "use-after-free: none": lines[-2:-1] == [
                  "use-after-free: none (hard error if one had occurred)"],
              "no leaks: True": lines[-1:] == ["no leaks: True"]}
    if not all(checks.values()):
        log("\n".join(lines[-40:]))
    _runtime_line(
        "f examples/serve_paged_torch.py --kv-store paged --prefix-cache "
        "--engines 2 --prefill-workers 2 --trace", checks,
        f"{' | '.join(said)}; {time.monotonic() - t0:.1f} s (process start "
        f"included, beside runs a-e)", card)


def _runtime_system(card: str, out: dict, ckpt_dir: str) -> dict:
    """Run g: the tiny trainer's checkpoint restored by a fresh Trainer
    and served by the paged engine, against the same traffic served from
    the trainer's parameters in memory.  Returns the paged kernels'
    launches."""
    cfg = tiny_lm.tiny_lm_config()
    tr = Trainer(cfg, TrainerConfig(ckpt_dir=ckpt_dir), None, device=DEV)
    restored = tr.try_restore()
    if restored is None:
        raise AssertionError(f"runtime g: no checkpoint in {ckpt_dir}")
    params, _, start = restored
    rng = np.random.default_rng(SEED + 3)
    shared = rng.integers(1, cfg.vocab, 32).tolist()
    prompts = [shared + rng.integers(1, cfg.vocab, int(n)).tolist()
               for n in (3, 7, 11)]
    prompts += [rng.integers(1, cfg.vocab, int(n)).tolist()
                for n in (9, 40, 77)]
    total = dict.fromkeys(PAGED_KERNELS, 0)
    runs = []
    for p in (out["params"], params):
        eng = _engine(cfg, p)
        reqs, wall, launches = _serve(eng, prompts, RUNTIME_MAX_NEW,
                                      "g system")
        for k in total:
            total[k] += launches.get(k, 0)
        runs.append((reqs, _runtime_checks(eng, reqs, launches,
                                           RUNTIME_MAX_NEW)))
        del eng
    same, note = _same_tokens(cfg, out["params"], runs[0][0], runs[1][0])
    checks = {f"restored {k}": v for k, v in runs[1][1].items()}
    checks.update({f"in memory {k}": v for k, v in runs[0][1].items()})
    checks.update({"restored at the last step": start == out["step"],
                   "tokens": same})
    _runtime_line(
        "g system (examples/train_tiny_lm_torch.py's checkpoint -> a fresh "
        "Trainer -> the paged engine)", checks,
        f"restored step {start} of {out['step']}; against the same traffic "
        f"served from the parameters in memory: {note}", card)
    return total


# ----------------------------------------------------------------------------
# 4b. the paper's SMR schemes guarding the device pages
# ----------------------------------------------------------------------------

#: the schemes whose simulated work grows with the pool (every step or
#: every ping stores or scans max_hp = POOL_PAGES slots): their runs take
#: minutes on the discrete-event backend, the others seconds
SMR_HEAVY = ("HazardEraPOP", "HP", "HE", "HPAsym", "DEBRA+")
#: every safe scheme of the registry, on the discrete-event backend but for
#: the heavy ones, which run on the batch-stepped one (the runtime phase's
#: time); the two publish-on-ping schemes on the batch-stepped one too
SMR_RUNS = ([(s, "vec" if s in SMR_HEAVY else "gen")
             for s in supported_schemes()]
            + [("HazardPtrPOP", "vec"), ("EpochPOP", "vec")])
#: the heavy schemes serve the first 2 prompts (sharing a 6-page prefix)
#: of the 8 (4 before, and 8 before that): their host time is the
#: reclaimer's passes over max_hp = POOL_PAGES slots, every 2 ms for as
#: long as the run lasts, and the script's time limit holds every phase
#: after them
SMR_HEAVY_PROMPTS = 2
#: the slowest of them serve the first prompt alone: HP and HPAsym took
#: 57-66 s each on 2 prompts (the phase's longest runs, on the H100's host)
SMR_SLOWEST = ("HP", "HPAsym")
SMR_SLOWEST_PROMPTS = 1
#: the others serve the first 2 of the 4 prompts that share the prefix
#: (4 before, all 8 before that: the script took 1205.7 s once on a slow
#: host), the heavy schemes' traffic
SMR_LIGHT_PROMPTS = 2
#: smr serve processes, all at once: four copies of the weights (14.8 GB)
#: and the pages (2.1 GB) fit the card's 80 GB beside the script's own
#: process, which drops its copy during the phase
SMR_PROCS = 4
SMR_TIMEOUT_S = 1000.0           # one process's limit
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
#: the native policy, a publish-on-ping scheme and the epoch baseline
#: (EpochPOP and HP too before the runtime phase came: HP's replay took
#: 19.5 s of the phase's ~61 s)
FLEET_SCHEMES = ("EpochPOP-pool", "HazardPtrPOP", "EBR")


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


# new tokens a request in the smr serve runs: 4 since the distribution
# slice (8 before) -- the heavy schemes' runs are the simulator's host
# time per decode step, and the script's time limit holds the dist phase
SMR_MAX_NEW = 4


def smr_serve_run(cfg, params, scheme: str, backend: str, card: str,
                  max_new: int = SMR_MAX_NEW) -> None:
    """The serve phase's traffic (its first SMR_LIGHT_PROMPTS requests,
    which share a 96-token prefix; a heavy scheme the first
    SMR_HEAVY_PROMPTS of those, the slowest the first SMR_SLOWEST_PROMPTS) at ``max_new`` tokens each under one
    scheme of the SMR registry: the
    simulator-backed policy decides when each device page is freed (and
    poisoned).  Raises on a failed check; prints one line."""
    prompts = _prompts(np.random.default_rng(SEED + 1), cfg.vocab)
    prompts = prompts[:SMR_SLOWEST_PROMPTS if scheme in SMR_SLOWEST
                      else SMR_HEAVY_PROMPTS if scheme in SMR_HEAVY
                      else SMR_LIGHT_PROMPTS]
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
        f"ms; {_policy_ms_per_step(eng)}; launches "
        f"{', '.join(f'{k} {launches[k]}' for k in PAGED_KERNELS)}; peak "
        f"device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; checks "
        f"passed; use-after-free: none; {card}")


def smr_run_main(pairs) -> int:
    """``chip_smoke.py --smr-run SCHEME BACKEND [SCHEME BACKEND ...]``: runs
    of the smr serve phase one after another in a process of their own,
    on starcoder2-7b's weights from the script's seed (the same weights as
    every other phase), each run's peak device memory its own."""
    card = _card()
    cfg = starcoder2_7b.CONFIG
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    params = init_params(cfg, gen, device=DEV)
    for scheme, backend in zip(pairs[0::2], pairs[1::2]):
        free_cuda()
        torch.cuda.reset_peak_memory_stats()
        smr_serve_run(cfg, params, scheme, backend, card)
    return 0


def _smr_jobs():
    """``SMR_RUNS`` as SMR_PROCS processes' lists of runs: the slowest
    schemes a process each, the others split over the rest, heaviest
    first (a process start and the weights cost each run ~15-20 s of
    host time when every run had a process of its own: 14 processes)."""
    slow = [[r] for h in SMR_SLOWEST for r in SMR_RUNS if r[0] == h]
    rest = ([r for r in SMR_RUNS if r[0] in SMR_HEAVY and r[0] not in
             SMR_SLOWEST] + [r for r in SMR_RUNS if r[0] not in SMR_HEAVY])
    n = SMR_PROCS - len(slow)
    return slow + [rest[i::n] for i in range(n)]


def phase_smr_serve() -> None:
    """Every run of ``SMR_RUNS``, in ``SMR_PROCS`` processes at once on the
    one card (``_smr_jobs``).  A run's cost is host time under its
    process's one GIL and the policy's one lock (the device idles most of
    a serve step), so the processes share only the host's cores and the
    card.  The first failure stops the other processes and raises."""
    running = []               # (runs, process, output, t0)
    t_all = time.monotonic()
    try:
        for runs in _smr_jobs():
            out = tempfile.TemporaryFile(mode="w+")
            proc = subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), "--smr-run"]
                + [w for run in runs for w in run],
                stdout=out, stderr=subprocess.STDOUT, text=True)
            running.append((runs, proc, out, time.monotonic()))
        while running:
            time.sleep(0.5)
            for item in list(running):
                runs, proc, out, t0 = item
                if proc.poll() is None:
                    if time.monotonic() - t0 > SMR_TIMEOUT_S:
                        proc.kill()
                        proc.wait()
                        raise AssertionError(
                            f"smr serve {runs}: no end after "
                            f"{SMR_TIMEOUT_S:.0f} s")
                    continue
                running.remove(item)
                out.seek(0)
                text = out.read()
                out.close()
                if proc.returncode != 0:
                    raise AssertionError(
                        f"smr serve {runs} failed (exit "
                        f"{proc.returncode}):\n{text[-6000:]}")
                for line in text.splitlines():
                    if line.startswith("smr serve "):
                        log(line)
    finally:
        for _, proc, out, _ in running:
            proc.kill()
            proc.wait()
            out.close()
    log(f"smr serve: {len(SMR_RUNS)} runs passed in "
        f"{time.monotonic() - t_all:.1f} s, {SMR_PROCS} processes")


def phase_fleet_replay(cfg, params, card: str, duration_s: float = 4.0,
                       rate_rps: float = 1.25) -> None:
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
    n = build.launch_counts
    forwards = (n["paged_attention"] + n["paged_attention+write"]) \
        / cfg.n_layers
    report_profile(prof, wall, forwards, cfg.n_layers, top)
    fused, alone = n["paged_attention+write"], n["paged_scatter"]
    log(f"  profile scatter index uploads per forward: "
        f"{eng.kv_store.index_builds / forwards:.2f} (one per forward); "
        f"launches per forward: fused attention + write "
        f"{fused / forwards:.1f}, standalone scatter {alone / forwards:.1f},"
        f" attention alone {n['paged_attention'] / forwards:.1f} (device "
        f"storage; one fused launch a layer)")
    if alone or n["paged_attention"] or not fused:
        raise AssertionError(f"profile: launches {dict(n)}")


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
    total = dict.fromkeys(PAGED_KERNELS, 0)
    for dtype in ("float32", "bfloat16"):
        c = cfg.scaled(dtype=dtype)
        full = PagedKVStore(c, len(blocks) + 1, PAGE, storage="device",
                            device=DEV)
        build.reset_launch_counts()
        k, v = prefill_kv(params, c, prompt)
        full.write_prefill(blocks, k, v)      # the standalone scatter's path
        chunked = PagedKVStore(c, len(blocks) + 1, PAGE, storage="device",
                               device=DEV)
        for _ in prefill_kv_chunked(params, c, chunked, blocks, prompt,
                                    chunk):
            pass
        torch.cuda.synchronize()
        counts = dict(build.launch_counts)
        for name in total:
            total[name] += counts[name]
        want = {"paged_scatter": 1, "paged_attention": 0,
                "paged_attention+write": cfg.n_layers * -(-n_prompt // chunk)}
        if any(counts[k] != n for k, n in want.items()):
            raise AssertionError(f"prefill_kv {dtype}: launches {counts}, "
                                 f"want {want}")
        pages[dtype] = (torch.stack([full.k[:, blocks], full.v[:, blocks]]),
                        torch.stack([chunked.k[:, blocks],
                                     chunked.v[:, blocks]]),
                        counts["flash_attention"])
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
    log(f"prefill_kv launches: {total} (the full-sequence prefill's one "
        f"all-layer scatter a dtype; the chunked path's fused launches)")
    return total


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


def _prefill_runs(cfg, params, toks, frontend=None):
    """make_prefill_step through the kernels and through the plain
    versions, in bf16 and f32 compute: {(dtype, impl): (last logits over
    the real vocabulary, cache, launch counts, host seconds of a second,
    warm call)}."""
    runs = {}
    for dtype in ("bfloat16", "float32"):
        c = cfg.scaled(dtype=dtype)
        for impl in ("cuda", "torch"):
            step = make_prefill_step(c, impl=impl)
            build.reset_launch_counts()
            logits, cache = step(params, toks, frontend)
            torch.cuda.synchronize()
            counts = dict(build.launch_counts)
            t0 = time.monotonic()
            step(params, toks, frontend)
            torch.cuda.synchronize()
            runs[(dtype, impl)] = (logits.float()[..., :cfg.vocab], cache,
                                   counts, time.monotonic() - t0)
            free_cuda()
    return runs


def _check_prefill(name, runs, f32_tol: float) -> None:
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


def _decode_vs_forward(label, cfg, params, toks, seq, steps, runs,
                       frontend=None, pin=None):
    """The bf16 and f32 prefill caches through the kernels (``runs``)
    grafted into init_cache, then ``steps`` decode steps against the
    train-mode forward over the same tokens: f32 within 1e-3, bf16 within
    max(0.25, 2 e), e the forward's own bf16 distance from its f32 logits
    (the rule of tests/test_models_smoke.py).  With ``pin`` (a fresh
    _Pin), each dtype's pass holds the expert weights in its dtype
    (_experts_in), the f32 forward's MoE routing is recorded, and the bf16
    forward and every decode step replay it at their tokens.  Returns each
    dtype's median decode step host time in ms (the first step left
    out)."""
    batch = toks.shape[0]
    fwd, rows, step_ms = {}, {}, {}
    for dtype in ("float32", "bfloat16"):
        c = cfg.scaled(dtype=dtype)
        held = (contextlib.nullcontext() if pin is None
                else _experts_in(params, dtype))
        with held:
            with (contextlib.nullcontext() if pin is None
                  else pin.run(("forward", dtype))):
                full, _, _ = apply_model(params, toks, cfg=c, mode="train",
                                         frontend=frontend)
            fwd[dtype] = full[:, seq:, :cfg.vocab].float()
            del full
            free_cuda()
            cache = _graft(c, runs[(dtype, "cuda")][1], batch, seq + steps)
            out, times = [], []
            for t in range(seq, seq + steps):
                with (contextlib.nullcontext() if pin is None
                      else pin.run(("decode", dtype), pos=t)):
                    torch.cuda.synchronize()
                    t0 = time.monotonic()
                    lg, cache, _ = apply_model(params, toks[:, t:t + 1],
                                               cfg=c, mode="decode",
                                               cache=cache)
                    torch.cuda.synchronize()
                times.append(time.monotonic() - t0)
                out.append(lg[:, 0, :cfg.vocab].float())
            rows[dtype] = torch.stack(out, 1)
            step_ms[dtype] = 1e3 * float(np.median(times[1:]))
            del cache, out
            free_cuda()
    if pin is not None:
        log(f"{label}routing: recorded in the f32 forward and replayed in "
            f"the bf16 forward and each decode step; their own choices "
            f"differing (token expert sets, kept pairs; a decode step keeps "
            f"every pair it routes, C = T, where the forward's capacity "
            f"drops some): " + ", ".join(
                f"{w} {d} {f[0]}, {f[1]}" for (w, d), f in pin.flips.items()
                if (w, d) != ("forward", "float32")))
    own = within(fwd["bfloat16"], fwd["float32"], 0.0)[0]
    for dtype, tol in (("float32", 1e-3), ("bfloat16", max(0.25, 2 * own))):
        err, ok = within(rows[dtype], fwd[dtype], tol)
        log(f"{label}decode after prefill {dtype}: {steps} steps vs the "
            f"train-mode forward, max |diff| {err:.4e} (tol {tol:.4g} abs + "
            f"rel, the rule of tests/test_models_smoke.py; e {own:.4e}): "
            f"{ok}")
        if not ok:
            raise AssertionError(f"{label}decode after prefill {dtype}: {err}")
    return step_ms


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
    _decode_vs_forward("", cfg, params, toks, seq, steps, runs)
    _greedy_steps("", cfg, params, runs[("bfloat16", "cuda")], seq, steps)
    del runs
    free_cuda()
    return main_counts


def _greedy_steps(label, cfg, params, run, seq: int, steps: int):
    """``steps`` greedy make_serve_step steps (bf16) from a bf16 prefill
    run's last logits and cache; every token in the vocabulary.  Returns
    the median step host time in ms (the first step left out)."""
    logits, pcache = run[0], run[1]
    c = cfg.scaled(dtype="bfloat16")
    cache = _graft(c, pcache, logits.shape[0], seq + steps)
    serve_step = make_serve_step(c)
    tok = logits.argmax(-1).to(torch.int32)[:, None]
    gen, times = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        tok, cache = serve_step(params, cache, tok)
        torch.cuda.synchronize()
        times.append(time.monotonic() - t0)
        gen.append(tok)
        tok = tok[:, None]
    gen = torch.stack(gen, 1).cpu()
    if not bool(((gen >= 0) & (gen < cfg.vocab)).all()):
        raise AssertionError(f"make_serve_step tokens out of range: {gen}")
    log(f"{label}make_serve_step: {steps} greedy steps after the prefill, "
        f"row 0 tokens {gen[0].tolist()}, cache pos {cache['pos'].tolist()}")
    del cache
    free_cuda()
    return 1e3 * float(np.median(times[1:]))


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


def phase_dense_serve(cfg, params, card: str, max_new: int = 8,
                      shared_len: int = 16, tails=(4, 32), alone=(16, 40)):
    """ServeEngine(kv_store="dense"): requests of ``shared_len`` + each of
    ``tails`` prompt tokens sharing a prefix (the first of them goes in
    alone until its prefix is published, so the others can hit it) and of
    each of ``alone``: 4 requests of 16-48 tokens (6 of 32-96 before:
    zamba2's and olmoe's runs took 64 s each, prefilling 285 tokens one
    at a time).  This path prefills token by token through decode mode,
    as the reference's dense engine does: it launches no kernel of this
    package."""
    rng = np.random.default_rng(SEED + 5)
    shared = rng.integers(1, cfg.vocab, shared_len).tolist()
    prompts = [shared + rng.integers(1, cfg.vocab, n).tolist()
               for n in tails]
    prompts += [rng.integers(1, cfg.vocab, n).tolist() for n in alone]
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
    rng = np.random.default_rng(SEED + 4)
    toks = torch.from_numpy(rng.integers(1, cfg.vocab, (batch, seq))).to(DEV)
    _prefill_profile("dense", cfg, params, toks, top=top)


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


PIN_RUNS = (("float32", "torch"), ("float32", "cuda"), ("bfloat16", "torch"),
            ("bfloat16", "cuda"))


class _Pin:
    """One run's MoE routing, recorded and replayed in others.  The
    router's choices are discrete: a perturbation of the flash kernel's
    size (~5e-7 in f32) flips a near-tie somewhere among olmoe's 16 layers
    x 8192 tokens x 64 experts, and the flipped token's output then differs
    by a whole expert's share; bf16 rounding flips many.  With one run's
    choices pinned, the runs differ only by the kernels' and the dtypes'
    numerics.  The first ``run`` records each MoE call's (top_i, cw, ci);
    each later one replays them in call order and counts in
    ``flips[key]`` its own choices that differ: tokens whose expert set
    differs, and (expert, token) pairs kept by one run only."""

    def __init__(self):
        self.rec, self.flips = [], {}

    @staticmethod
    def _kept(cw, ci, T):
        m = torch.zeros((cw.shape[0], T + 1), dtype=torch.bool, device=DEV)
        return m.scatter_(1, torch.where(cw > 0, ci, T), True)[:, :T]

    def _at_step(self, j, pos, B, C):
        """The recorded (forward's) call ``j`` at a decode step's tokens,
        each row's token at ``pos``: those tokens' experts, and each
        expert's recorded weights for them ordered as route's top-C
        orders them."""
        top_i, cw, ci, _ = self.rec[j]
        T = top_i.shape[0]
        idx = torch.arange(B, device=DEV) * (T // B) + pos
        w = torch.zeros((cw.shape[0], T + 1), dtype=cw.dtype, device=DEV)
        w = w.scatter_(1, torch.where(cw > 0, ci, T), cw)[:, :T]
        cw_s, ci_s = moe_mod._top_k(w[:, idx], C)
        return top_i[idx], cw_s, ci_s

    @contextlib.contextmanager
    def run(self, key, pos=None):
        """Route through the pin; ``pos``: a decode step at this position
        replays the recorded forward's choices at its tokens."""
        real, at, recording = moe_mod.route, [0], not self.rec
        flips = self.flips.setdefault(key, [0, 0])

        def route(p, xt, cfg):
            own = real(p, xt, cfg)
            if recording:
                self.rec.append(own)
                return own
            T = xt.shape[0]
            want = (self.rec[at[0]][:3] if pos is None else
                    self._at_step(at[0], pos, T, own[2].shape[1]))
            at[0] += 1
            flips[0] += int((own[0].sort(-1).values
                             != want[0].sort(-1).values).any(-1).sum())
            flips[1] += int((self._kept(*own[1:3], T)
                             != self._kept(*want[1:3], T)).sum())
            return want[0], want[1], want[2], own[3]

        moe_mod.route = route
        try:
            yield
        finally:
            moe_mod.route = real
        if not recording and at[0] != len(self.rec):
            raise AssertionError(f"routing replay {key}: {at[0]} of "
                                 f"{len(self.rec)} layers")


@contextlib.contextmanager
def _experts_in(params, dtype):
    """The MoE layers' expert weights held in ``dtype`` for the block, then
    back in their own dtype (bf16 -> f32 -> bf16 is exact).  The forward
    casts each weight to the compute dtype at use: an f32 pass over
    deepseek's MoE layer would cast its 11.3e9 expert weights to f32 (45
    GB) beside the 31.6 GB held; held in f32 they take 45 GB in place of
    22.5 and the cast at use is none."""
    moes = [lp["moe"] for g in params["groups"].values() for lp in g.values()
            if "moe" in lp]
    names = ("wi_gate", "wi_up", "wo")
    own = {k: moes[0][k].dtype for k in names} if moes else {}

    def cast(dtypes):
        for m in moes:
            for k in names:
                m[k] = m[k].to(dtypes[k])
        free_cuda()

    cast({k: getattr(torch, dtype) for k in names})
    try:
        yield
    finally:
        cast(own)


def _routing_pinned(cfg, params, toks, keys=PIN_RUNS, hold=False):
    """The prefill through the plain versions in f32, recording each MoE
    layer's routing, then through the kernels in f32 and through both paths
    in bf16 with that routing replayed (``keys``: the (dtype, impl) runs in
    order, the first recording; ``hold``: the expert weights held in each
    run's dtype, see _experts_in).  Returns {(dtype, impl): (last logits
    over the real vocabulary, the cache of a run through the kernels,
    launch counts, host seconds)} as _prefill_runs does, and the replayed
    runs' flips (see _Pin)."""
    pin, out = _Pin(), {}
    for dtype, impl in keys:
        held = (_experts_in(params, dtype) if hold
                else contextlib.nullcontext())
        with held, pin.run((dtype, impl)):
            build.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.monotonic()
            lg, cache = make_prefill_step(cfg.scaled(dtype=dtype),
                                          impl=impl)(params, toks)
            torch.cuda.synchronize()
            out[(dtype, impl)] = (lg.float()[..., :cfg.vocab],
                                  cache if impl == "cuda" else None,
                                  dict(build.launch_counts),
                                  time.monotonic() - t0)
        del lg, cache
        free_cuda()
    return out, pin.flips


def phase_olmoe(card: str, batch: int = 4, seq: int = 2048,
                steps: int = 4) -> None:
    """olmoe-1b-7b at full width and depth: the prefill through the flash
    kernel vs the plain path (16 flash launches through the kernels, none
    through the plain path; bf16 and f32 compared with the MoE routing
    pinned, the unpinned distances and routing flips printed), two more
    bf16 prefills bit-equal to the first, decode steps after a prefill
    against the train-mode forward, one MoE layer timed beside its bound,
    the MoE share of the prefill's device time, dense serving, and the
    paged path's refusal."""
    cfg = olmoe_1b_7b.CONFIG
    torch.cuda.reset_peak_memory_stats()
    params = _model(cfg, f"no cut: {cfg.moe.n_experts} experts, top-"
                         f"{cfg.moe.top_k}, expert d_ff {cfg.moe.d_ff}")
    rng = np.random.default_rng(SEED + 7)
    toks = torch.from_numpy(rng.integers(1, cfg.vocab, (batch, seq + steps))
                            ).to(DEV)
    runs = _prefill_runs(cfg, params, toks[:, :seq])
    _check_launches("olmoe", runs, cfg.n_layers)
    first = runs[("bfloat16", "cuda")][0]
    # the check holds the kernels' numerics with the MoE routing pinned
    # (see _routing_pinned); the unpinned distances are printed beside it
    free = {dt: within(runs[(dt, "cuda")][0], runs[(dt, "torch")][0], 0.0)[0]
            for dt in ("float32", "bfloat16")}
    pinned, flips = _routing_pinned(cfg, params, toks[:, :seq])
    log(f"olmoe routing: recorded in the plain f32 prefill ({cfg.n_layers} "
        f"layers x {batch * seq} tokens) and replayed; the replayed runs' "
        f"own choices differing (token expert sets, kept pairs): "
        + ", ".join(f"{d} {i} {f[0]}, {f[1]}" for (d, i), f in flips.items())
        + f"; unpinned kernels vs plain max |diff| f32 "
        f"{free['float32']:.4e}, bf16 {free['bfloat16']:.4e}")
    for key, run in pinned.items():
        runs[key] = (run[0],) + runs[key][1:]
    _check_prefill(cfg.name + " (routing pinned)", runs, 1e-3)
    step = make_prefill_step(cfg)
    again = [step(params, toks[:, :seq])[0].float()[..., :cfg.vocab]
             for _ in range(2)]
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
    caches = {}
    for dtype in ("float32", "bfloat16"):
        caches[(dtype, "cuda")] = (None, make_prefill_step(
            dropless.scaled(dtype=dtype))(params, toks[:, :seq])[1])
    step_ms = _decode_vs_forward("olmoe (experts dropless): ", dropless,
                                 params, toks, seq, steps, caches)
    del caches
    free_cuda()

    # one MoE layer at the prefill's shape, and the prefill's MoE share
    lp = unstack(params["groups"]["g0"]["p0"])[0]["moe"]
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
    _paged_refused("olmoe", cfg, params)
    del params
    free_cuda()


def _paged_refused(label: str, cfg, params) -> None:
    """The paged path refuses ``cfg`` with check_paged_support's
    ValueError (the reference's text)."""
    try:
        ServeEngine(cfg, params, kv_store="paged", kv_storage="device",
                    device=DEV, page_size=PAGE, num_pages=64, max_batch=4)
    except ValueError as e:
        log(f"{label} paged serving refused: ValueError: {e}")
    else:
        raise AssertionError(f"the paged path took {cfg.name}")


def _check_launches(label: str, runs, n_flash: int) -> None:
    """Each prefill through the kernels launched flash ``n_flash`` times
    and the scan never; through the plain versions, no kernel."""
    want = {"flash_attention": n_flash, "linear_scan": 0}
    for (dtype, impl), run in runs.items():
        got = {k: run[2][k] for k in want}
        expect = want if impl == "cuda" else {k: 0 for k in want}
        if got != expect:
            raise AssertionError(f"{label} {dtype} {impl} prefill launches "
                                 f"{got}, want {expect}")
    log(f"{label} prefill: launches per prefill through the kernels "
        f"{runs[('bfloat16', 'cuda')][2]}; through the plain versions "
        f"{runs[('bfloat16', 'torch')][2]}")


def _flash_line(label: str, name: str, times, card: str) -> None:
    """The kernels phase's bf16 timing of flash at this model's call shape
    ``name`` (same shapes, random inputs)."""
    ms, _, bound, by, lib = times[name]
    _, flops = flash_work(FLASH_SHAPES[name])
    sdpa = ("n/a" if lib is None else
            f"{lib:.4f} ms ({flops / lib / 1e9:.1f} TFLOP/s), kernel / SDPA "
            f"{ms / lib:.2f}x")
    log(f"{label} flash bf16 at {name} {FLASH_SHAPES[name]}: kernel "
        f"{ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), SDPA {sdpa}, bound "
        f"{bound:.6f} ms ({by}; {flops:.4g} FLOPs); from the kernels phase; "
        f"{card}")


def _prefill_profile(label: str, cfg, params, toks, frontend=None,
                     top: int = 6):
    """One bf16 prefill through the kernels under torch.profiler, after a
    warm call: returns (device busy s, window s)."""
    from torch.profiler import ProfilerActivity, profile

    step = make_prefill_step(cfg)
    step(params, toks, frontend)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        step(params, toks, frontend)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    log(f"{label} profile: {cfg.name} prefill of {toks.shape[0]} x "
        f"{toks.shape[1]} tokens")
    busy = report_profile(prof, wall, 1, cfg.n_layers, top)
    free_cuda()
    return busy, wall


# ----------------------------------------------------------------------------
# 9. deepseek-v3: MLA and the MTP head's parameters
# ----------------------------------------------------------------------------


def phase_deepseek(card: str, flash_times, batch: int = 2, seq: int = 2048,
                   steps: int = 8) -> int:
    """deepseek-v3-671b at full width, cut in depth to 3 dense + 1 MoE
    layers (MTP parameters built): f32 and bf16 prefill through the kernels
    vs the plain versions, and the absorbed decode against the train-mode
    forward, on the dense group alone (3 MLA layers) and on the 3 + 1 cut
    (the expert weights held in each run's dtype; the plain f32 prefill's
    MoE routing replayed in the other prefills, the f32 forward's in the
    bf16 forward and the decode steps); on the cut in bf16, the launches
    (flash at MLA's D=192 / Dv=128 shape once a layer), three prefills
    bit-equal, and greedy make_serve_step; the prefill under the profiler;
    dense serving; the paged path's refusal.  Returns the flash launches of
    one prefill through the kernels."""
    full = deepseek_v3_671b.CONFIG
    dense_g, moe_g = full.groups
    cfg = full.scaled(groups=(dense_g, dataclasses.replace(moe_g, repeats=1)))
    dense = full.scaled(groups=(dense_g,))
    m, e = cfg.mla, cfg.moe
    torch.cuda.reset_peak_memory_stats()
    params = _model(cfg, f"cut: groups {dense_g.repeats} dense + "
                         f"{moe_g.repeats} MoE -> {dense_g.repeats} dense + 1 "
                         f"MoE; full width: MLA ranks {m.q_lora_rank}/"
                         f"{m.kv_lora_rank}, {e.n_experts} experts top-"
                         f"{e.top_k} + {e.n_shared} shared, MTP parameters")
    dparams = dict(params, groups={"g0": params["groups"]["g0"]})
    rng = np.random.default_rng(SEED + 8)
    toks = torch.from_numpy(rng.integers(1, cfg.vocab, (batch, seq + steps))
                            ).to(DEV)

    # f32 and bf16 on the dense group
    label = f"deepseek dense group ({dense.n_layers} MLA layers)"
    runs = _prefill_runs(dense, dparams, toks[:, :seq])
    _check_launches(label, runs, dense.n_layers)
    _check_prefill(f"{cfg.name} {label}", runs, 1e-3)
    _decode_vs_forward(f"{label}: absorbed ", dense, dparams, toks, seq,
                       steps, runs)
    del runs
    free_cuda()

    # bf16 on the 3 + 1 cut
    step = make_prefill_step(cfg)
    build.reset_launch_counts()
    first = step(params, toks[:, :seq])
    torch.cuda.synchronize()
    counts = dict(build.launch_counts)
    if (counts["flash_attention"], counts["linear_scan"]) != (cfg.n_layers,
                                                              0):
        raise AssertionError(f"deepseek prefill launches {counts}")
    log(f"deepseek prefill: launches per prefill through the kernels "
        f"{counts} ({cfg.n_layers} MLA layers)")
    again, times = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        again.append(step(params, toks[:, :seq])[0])
        torch.cuda.synchronize()
        times.append(time.monotonic() - t0)
    same = all(torch.equal(first[0], a) for a in again)
    log(f"deepseek determinism: three bf16 prefills through the kernels give "
        f"bit-identical last-position logits: {same}")
    if not same:
        raise AssertionError("deepseek bf16 prefills differ from run to run")
    del again
    plain = make_prefill_step(cfg, impl="torch")
    unpinned = plain(params, toks[:, :seq])[0].float()[..., :cfg.vocab]
    free_d = within(first[0].float()[..., :cfg.vocab], unpinned, 0.0)[0]
    del plain, unpinned
    free_cuda()

    # f32 and bf16 on the 3 + 1 cut, the expert weights held in each run's
    # dtype (_experts_in), the plain f32 prefill's routing replayed
    runs, flips = _routing_pinned(cfg, params, toks[:, :seq], hold=True)
    log(f"deepseek routing: recorded in the plain f32 prefill (1 MoE layer "
        f"x {batch * seq} tokens, {e.n_experts} experts top-{e.top_k}, C="
        f"{capacity(cfg, batch * seq)}) and replayed; the replayed runs' "
        f"own choices differing (token expert sets, kept pairs): "
        + ", ".join(f"{d} {i} {f[0]}, {f[1]}" for (d, i), f in flips.items()
                    if (d, i) != PIN_RUNS[0])
        + f"; unpinned bf16 kernels vs plain max |diff| {free_d:.4e}")
    _check_prefill(f"{cfg.name} 3 dense + 1 MoE (routing pinned)", runs, 1e-3)
    _decode_vs_forward("deepseek 3 dense + 1 MoE: absorbed ", cfg, params,
                       toks, seq, steps, runs, pin=_Pin())
    del runs
    free_cuda()

    step_ms = _greedy_steps("deepseek: ", cfg, params,
                            (first[0].float(), first[1]), seq, steps)
    del first
    free_cuda()
    _flash_line("deepseek", "deepseek MLA", flash_times, card)
    busy, wall = _prefill_profile("deepseek", cfg, params, toks[:, :seq])
    read = sum(t.numel() * t.element_size() for t in tree_leaves(
        {k: params[k] for k in ("groups", "lm_head", "final_norm")}))
    log(f"deepseek times: prefill {batch} x {seq} bf16 through the kernels "
        f"{1e3 * float(np.median(times)):.1f} ms host time, device busy "
        f"{1e3 * busy:.1f} ms of a {1e3 * wall:.1f} ms profiled window; "
        f"decode step (batch {batch}, every expert read: C = T) bf16 "
        f"{step_ms:.2f} ms host time, bound "
        f"{read / HBM_BYTES_PER_S * 1e3:.4f} ms (bytes: {read / 1e9:.2f} GB "
        f"of weights a step); peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {card}")
    phase_dense_serve(cfg, params, card)
    _paged_refused("deepseek", cfg, params)
    del params, dparams
    free_cuda()
    return counts["flash_attention"]


# ----------------------------------------------------------------------------
# 10. cross attention and the encoder: llama-3.2-vision, whisper-small
# ----------------------------------------------------------------------------


def _frontend_model(label: str, cfg, params, card: str, flash_times, shapes,
                    batch: int, seq: int, steps: int, seed: int) -> int:
    """Prefill with a frontend (0.02 N(0, 1) embeddings, the reference
    trainer's stub) through the kernels vs the plain versions in bf16 and
    f32, then decode steps against the train-mode forward; flash at each
    of ``shapes``; the paged path's refusal.  Returns the flash launches
    of one prefill through the kernels."""
    gen = torch.Generator(device=DEV).manual_seed(SEED + seed)
    frontend = 0.02 * torch.randn((batch, cfg.n_frontend_tokens,
                                   cfg.d_model), generator=gen, device=DEV)
    rng = np.random.default_rng(SEED + seed)
    toks = torch.from_numpy(rng.integers(1, cfg.vocab, (batch, seq + steps))
                            ).to(DEV)
    runs = _prefill_runs(cfg, params, toks[:, :seq], frontend)
    n_flash = sum(g.repeats * sum(ls.mixer == "attn" for ls in g.pattern)
                  for g in cfg.groups + cfg.encoder_groups)
    _check_launches(label, runs, n_flash)
    launched = runs[("bfloat16", "cuda")][2]["flash_attention"]
    _check_prefill(cfg.name, runs, 1e-3)
    _decode_vs_forward(f"{label}: ", cfg, params, toks, seq, steps, runs,
                       frontend)
    del runs
    free_cuda()
    for name in shapes:
        _flash_line(label, name, flash_times, card)
    _paged_refused(label, cfg, params)
    return launched


def phase_cross(card: str, flash_times) -> int:
    """llama-3.2-vision-90b at full width cut to 2 pattern repeats (8 self
    + 2 cross layers; 2 x 2048 text tokens over 1601 image tokens) and
    whisper-small whole (12 encoder + 12 decoder patterns; 4 x 448 text
    tokens over 1500 frames).  Returns the flash launches of one prefill
    of each, summed."""
    full = llama32_vision_90b.CONFIG
    (g,) = full.groups
    cfg = full.scaled(groups=(dataclasses.replace(g, repeats=2),))
    params = _model(cfg, f"cut: {g.repeats} pattern repeats -> 2 (8 self + "
                         f"2 cross layers); full width, "
                         f"{cfg.n_frontend_tokens} image tokens")
    n = _frontend_model("llama-vision", cfg, params, card, flash_times,
                        ("llama-vision self", "llama-vision cross"),
                        batch=2, seq=2048, steps=8, seed=9)
    del params
    free_cuda()
    cfg = whisper_small.CONFIG
    params = _model(cfg, f"no cut: {cfg.encoder_groups[0].repeats} encoder "
                         f"+ {cfg.groups[0].repeats} decoder patterns, "
                         f"{cfg.n_frontend_tokens} frames")
    n += _frontend_model("whisper", cfg, params, card, flash_times,
                         ("whisper encoder", "whisper self",
                          "whisper cross"),
                         batch=4, seq=448, steps=8, seed=10)
    del params
    free_cuda()
    return n


# ----------------------------------------------------------------------------
# 11. training: loss (with the MTP head), autograd through the kernels,
#     AdamW, remat, the trainer, its checkpoints and its launcher
# ----------------------------------------------------------------------------


TRAIN_GRAD_TOL = 1e-3   # f32 per-leaf ||g_kernels - g_plain|| / ||g_plain||
RESTART_TOL = 2e-2      # the reference's tests/test_trainer.py bound
# rwkv6-1.6b whole: its f32 gradient at random weights amplifies the
# scan's f32 rounding so far that two f32 evaluations of the same scan
# (the plain version and its chunked split) give grads ~1e-2 apart, so the
# kernels are held against the gradient taken at the scan's f64 forward:
# no further from it than F64_SCAN_RATIO x the plain path, and each
# recorded call's forward no further from f64 than FWD_ERR_RATIO x the
# plain version's (PERF.md, section 6)
F64_SCAN_RATIO = 2.0
FWD_ERR_RATIO = 1.1
# (batch, sequence) of each model's train runs
TRAIN_SHAPES = {"zamba2": (4, 2048), "rwkv6": (4, 2048),
                "deepseek": (2, 1024), "whisper": (4, 448)}
# zamba2's profiled step runs on the first of its 9 pattern repeats (3
# before the dry-run's memory checks came): the profiler's host work grows
# with the ops a step runs (the plain VJPs' small ops: 142 s of host time
# whole, 48.6 s on 3 repeats, on the H100's host), and the script's time
# limit holds every phase after it
PROFILE_REPEATS = 1
# rwkv6's f32 grad check against the scan's f64 forward runs on its first
# 6 of 24 layers (~56 s whole, of a train phase of 213 s; its first layer
# is checked alone as before), for the script's time limit.  zamba2's
# stays whole: on 3 of its 9 pattern repeats its worst leaf (dt_bias)
# read 2.261e-03 against the 1e-3 its whole model meets (3.807e-04)
RWKV6_GRAD_LAYERS = 6
TINY_STEPS = 200


def _pipeline_batch(cfg, batch: int, seq: int, seed: int, step: int = 0):
    """The synthetic pipeline's batch on the card, with the trainer's stub
    frontend where the config takes one."""
    pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                    global_batch=batch, seed=seed))
    out = {k: torch.from_numpy(v).to(DEV)
           for k, v in pipe.batch(step).items()}
    if cfg.n_frontend_tokens:
        out["frontend"] = stub_frontend(cfg, batch, seed, step, DEV)
    return out


def _train_launches(cfg):
    """Kernel calls of one train step: each attention and scan call site
    once in the forward, and once more in the backward's recompute under
    remat."""
    runs = 1 if cfg.remat == "none" else 2
    count = lambda pred: runs * sum(g.repeats * sum(map(pred, g.pattern))
                                    for g in cfg.groups)
    return {"flash_attention": count(lambda ls: (ls.mixer == "attn")
                                     + ls.shared_attn),
            "linear_scan": count(lambda ls: ls.mixer in ("mamba2",
                                                         "rwkv6"))}


def _scan_f64(q, k, v, log_decay, *, state=None, bonus=None, chunk=128,
              clamp=75.0):
    """The scan's plain version evaluated in f64, its output rounded to
    v's dtype: the scan's forward with f32's rounding taken out."""
    out, st = ref.linear_scan_ref(q, k, v, log_decay, state=state,
                                  bonus=bonus, chunk=chunk, clamp=clamp,
                                  acc=torch.float64)
    return out, st.float()


def _scan_chunked(q, k, v, log_decay, *, state=None, bonus=None,
                  chunk=128, clamp=75.0):
    """The kernels' three-phase split in plain PyTorch (f32)."""
    assert state is None
    return ref.linear_scan_chunked_ref(q, k, v, log_decay, bonus=bonus,
                                       chunk=chunk, clamp=clamp)


def _f64_scan_check(label, p32, batch, cfg32, gk, gp) -> str:
    """The kernels' and the plain path's grads against the grads with the
    scan's forward in f64 (``_scan_f64`` in the kernels' place, the
    backward the same plain VJP), and the kernels' forward against f64 at
    the first forward's calls; the kernels' split in plain PyTorch
    (``_scan_chunked`` in their place) beside them, printed only.  Raises
    past F64_SCAN_RATIO / FWD_ERR_RATIO; returns the summary."""
    calls = []

    def recording(q, k, v, ld, **kw):     # a no-grad forward: once a layer
        calls.append((q, k, v, ld, kw))
        return kernel(q, k, v, ld, **kw)

    kernel = ls.linear_scan
    try:
        ls.linear_scan = _scan_chunked
        _, _, gc = _grads(p32, batch, cfg32, "cuda")
        ls.linear_scan = _scan_f64
        _, _, gt = _grads(p32, batch, cfg32, "cuda")
        ls.linear_scan = recording
        with torch.no_grad():
            loss_fn(p32, batch, cfg32, impl="cuda")
    finally:
        ls.linear_scan = kernel

    def worst(ga):
        return max((float((ga[k].float() - b.float()).norm()
                          / b.float().norm()), k)
                   for k, b in gt.items() if b is not None)

    (ek, at_k), (ep, at_p), (ec, at_c) = worst(gk), worst(gp), worst(gc)
    del gc
    fwd = []
    with torch.no_grad():
        for q, k, v, ld, kw in calls:
            t = _scan_f64(q, k, v, ld, **kw)[0].double()
            fwd.append([float((o.double() - t).norm() / t.norm()) for o in (
                kernel(q, k, v, ld, **kw)[0],
                ref.linear_scan_ref(q, k, v, ld, **kw)[0],
                _scan_chunked(q, k, v, ld, **kw)[0])])
    fk, fp, fc = max(fwd, key=lambda e: e[0] / e[1])
    del gt, calls
    free_cuda()
    line = (f"against the grads at the scan's f64 forward: kernels {ek:.3e} "
            f"({at_k}), plain {ep:.3e} ({at_p}), ratio {ek / ep:.3f} (tol "
            f"{F64_SCAN_RATIO:g}; the kernels' split in plain PyTorch "
            f"{ec:.3e} ({at_c})); forward of {len(fwd)} calls vs f64, "
            f"||o - o64|| / ||o64||, at the worst ratio: kernel {fk:.4e}, "
            f"plain {fp:.4e} ({fk / fp:.4f}, tol {FWD_ERR_RATIO:g}), split "
            f"{fc:.4e}")
    if ek > F64_SCAN_RATIO * ep or fk > FWD_ERR_RATIO * fp:
        raise AssertionError(f"{label}: {line}")
    return line


def _grads(params, batch, cfg, impl):
    """(loss, metrics, {leaf path: grad, or None for a leaf the forward
    never reads})."""
    leaves = with_grad(params)
    loss, metrics = loss_fn(leaves, batch, cfg, impl=impl)
    named = list(flatten_with_paths(leaves))
    got = torch.autograd.grad(loss, [t for _, t in named], allow_unused=True)
    return (float(loss.detach()),
            {k: float(v.detach()) for k, v in metrics.items()},
            {k: g for (k, _), g in zip(named, got)})


def _train_grad_check(label: str, cfg, params, batch, card: str,
                      f64_scan: bool = False):
    """f32 compute over the leaves cast to f32: loss_fn and its grads
    through the kernels (their autograd.Functions) against the same
    through the plain versions.  Every leaf the forward reads has a
    finite, nonzero grad within ``tol`` (relative, in norm) of the plain
    one; a leaf it never reads (rwkv6's ``cm_norm``, declared but unused
    in the reference too) has none on either path.  With ``f64_scan``
    the kernels are held instead against the grads at the scan's f64
    forward (``_f64_scan_check``), kernels against plain printed only.
    Returns the kernels' launches."""
    cfg32 = cfg.scaled(dtype="float32")
    p32 = tree_map(lambda t: t.float(), params)
    t0 = time.monotonic()
    build.reset_launch_counts()
    lk, mk, gk = _grads(p32, batch, cfg32, None)
    torch.cuda.synchronize()
    launched = dict(build.launch_counts)
    t_k = time.monotonic() - t0
    t0 = time.monotonic()
    lp, mp, gp = _grads(p32, batch, cfg32, "torch")
    torch.cuda.synchronize()
    t_p = time.monotonic() - t0
    if build.launch_counts != launched:
        raise AssertionError(f"{label}: the plain run launched a kernel")
    tol, held = TRAIN_GRAD_TOL, ""
    if f64_scan:
        tol, held = math.inf, "; " + _f64_scan_check(label, p32, batch,
                                                     cfg32, gk, gp)
    unread = [k for k, g in gp.items() if g is None]
    if [k for k, g in gk.items() if g is None] != unread:
        raise AssertionError(f"{label}: the kernels' path leaves other "
                             f"leaves without a grad than the plain one")
    errs, bad = [], []
    for key, b in gp.items():
        if b is None:
            continue
        a, b = gk[key].float(), b.float()
        na, nb = float(a.norm()), float(b.norm())
        if not (math.isfinite(na) and na > 0 and math.isfinite(nb)):
            bad.append(key)
            continue
        errs.append((float((a - b).norm()) / nb, key))
    errs.sort(reverse=True)
    worst, worst_at = errs[0]
    runners = ", ".join(f"{k} {e:.2e}" for e, k in errs[1:4])
    metrics = {k: f"{mk[k]:.6f}/{mp[k]:.6f}" for k in mk}
    log(f"train {label} f32 grads: loss kernels {lk:.6f} plain {lp:.6f} "
        f"(|diff| {abs(lk - lp):.3e}); metrics kernels/plain {metrics}; "
        f"{len(gp)} leaves, {len(unread)} never read by the forward "
        f"{unread}, the others' grads finite and nonzero: {not bad}; worst "
        f"leaf {worst_at} ||g_k - g_p|| / ||g_p|| {worst:.3e} (tol {tol:g};"
        f" next {runners}){held}; launches {launched}; kernels {t_k:.1f} "
        f"s, plain {t_p:.1f} s; {card}")
    if bad:
        raise AssertionError(f"{label}: leaves without a finite nonzero "
                             f"grad: {bad[:8]}")
    if worst > tol:
        raise AssertionError(f"{label}: grad of {worst_at} off by {worst}")
    if not any(launched.values()):
        raise AssertionError(f"{label}: no kernel launched")
    del gk, gp, p32
    free_cuda()
    return launched


def _model_flops(cfg, params, batch: int, seq: int) -> float:
    """Model FLOPs of one train step: 6 N per token over the parameters
    that multiply (every leaf but the embedding table, which is looked up;
    a tied table counts, as the head), plus attention's 12 D per (query,
    key, head) pair (forward 4 D, backward twice that) at every causal
    self-attention call."""
    n = sum(t.numel() for key, t in flatten_with_paths(params)
            if key != "embed" or cfg.tie_embeddings)
    calls = sum(g.repeats * sum((ls.mixer == "attn") + ls.shared_attn
                                for ls in g.pattern) for g in cfg.groups)
    att = 12 * cfg.head_dim_ * cfg.n_heads * batch * kops.flash_pairs(
        seq, seq, True, 0)
    return 6.0 * n * batch * seq + calls * att


def _range_ms(prof, name: str):
    """(device ms, calls) of the kernels launched inside the profiler
    ranges called ``name`` (their host event, children included)."""
    from torch.autograd import DeviceType
    evs = [e for e in prof.events()
           if e.name == name and e.device_type == DeviceType.CPU]
    us = sum(e.device_time_total if hasattr(e, "device_time_total")
             else e.cuda_time_total for e in evs)
    return us / 1e3, len(evs)


def _profiled_step(label: str, cfg, params, opt, batch, card: str):
    """One bf16 train step under torch.profiler, its phases in ranges:
    device busy time and idle share, and the device time of the forward,
    the backward (with the remat recompute, which reruns the forward's
    ops), the plain VJPs of flash and the scan, and AdamW.  Returns the
    step's metrics and grads (taken before its update)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from torch.autograd import DeviceType

    lr = cosine_schedule(3e-4, warmup=20, total=100)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        leaves = with_grad(params)
        with record_function("train.forward"):
            loss, metrics = loss_fn(leaves, batch, cfg)
        grads = grad_tree(loss, leaves)
        with record_function("train.adamw"):
            adamw_update(grads, opt, params, lr=lr)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    ranges = ("train.forward", "train.adamw", "flash_attention.vjp",
              "linear_scan.vjp")
    busy = sum(_dev_us(e) for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.key not in ranges
               ) / 1e3
    got = {name: _range_ms(prof, name) for name in ranges}
    fwd, adam = got["train.forward"][0], got["train.adamw"][0]
    log(f"train {label} profile (one bf16 step): window {wall * 1e3:.1f} ms, "
        f"device busy {busy:.1f} ms, idle share {1 - busy / 1e3 / wall:.4f}; "
        f"forward {fwd:.1f} ms, backward {busy - fwd - adam:.1f} ms (of it "
        f"the remat recompute, which reruns the forward's ops, ~{fwd:.1f} "
        f"ms; flash plain VJP {got['flash_attention.vjp'][0]:.1f} ms over "
        f"{got['flash_attention.vjp'][1]} calls, scan plain VJP "
        f"{got['linear_scan.vjp'][0]:.1f} ms over "
        f"{got['linear_scan.vjp'][1]} calls), AdamW {adam:.1f} ms; {card}")
    return {k: float(v.detach()) for k, v in metrics.items()}, grads


def _train_run(label: str, cfg, batch: int, seq: int, steps: int, card: str,
               ckpt_dir: str, seed: int = SEED, **tkw):
    """The launcher's path: ``Trainer`` over the pipeline, bf16, on the
    card.  Prints per step the loss, step time, tokens/s and model
    TFLOP/s; checks each loss finite; returns (trainer, its output, the
    kernels' launches per step, peak device memory GiB)."""
    tcfg = TrainerConfig(steps=steps, ckpt_every=max(steps // 2, 10),
                         log_every=10 ** 6, ckpt_dir=ckpt_dir, seed=seed,
                         **tkw)
    gen = torch.Generator(device=DEV).manual_seed(seed)
    tr = Trainer(cfg, tcfg, DataConfig(vocab=cfg.vocab, seq_len=seq,
                                       global_batch=batch, seed=seed),
                 device=DEV, generator=gen)
    free_cuda()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    out = tr.run()
    torch.cuda.synchronize()
    per_step = {k: v / max(1, len(out["history"]))
                for k, v in build.launch_counts.items()}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    flops = _model_flops(cfg, out["params"], batch, seq)
    for h in out["history"]:
        if not math.isfinite(h["loss"]):
            raise AssertionError(f"{label}: loss {h['loss']} at step "
                                 f"{h['step']}")
        log(f"train {label} step {h['step']}: loss {h['loss']:.4f}, "
            f"{h['dt'] * 1e3:.1f} ms, {batch * seq / h['dt']:.0f} tokens/s, "
            f"model {flops / h['dt'] / 1e12:.1f} TFLOP/s ("
            f"{flops / h['dt'] / PEAK_FLOPS[torch.bfloat16]:.4f} of 989 "
            f"TFLOP/s bf16); {card}")
    log(f"train {label}: launches per step {per_step}; peak device memory "
        f"{peak:.2f} GiB; model FLOPs a step {flops:.4g}; {card}")
    return tr, out, per_step, peak


def _step_delta(label: str, cfg, params, batch, card: str):
    """One bf16 train step (lr 1e-3) through the kernels and the same from
    the same params through the plain versions: each leaf's parameter
    delta compared (printed; both checked finite)."""
    p0 = tree_map(lambda t: t.clone(), params)
    lr = cosine_schedule(1e-3, warmup=0, total=100)
    stepped = {}
    for impl in (None, "torch"):
        tree_map(lambda t, s: t.copy_(s), params, p0)
        opt = adamw_init(params)
        make_train_step(cfg, lr=lr, impl=impl)(params, opt, batch)
        del opt
        stepped[impl] = (tree_map(lambda t: t.clone(), params)
                         if impl is None else params)
        free_cuda()
    worst, at, same, total = 0.0, None, 0, 0
    for (k, s0), (_, tk), (_, tp) in zip(
            flatten_with_paths(p0), flatten_with_paths(stepped[None]),
            flatten_with_paths(stepped["torch"])):
        dk, dp = tk.float() - s0.float(), tp.float() - s0.float()
        if not bool(torch.isfinite(dk).all()):
            raise AssertionError(f"{label}: non-finite delta at {k}")
        same += int((tk == tp).sum())
        total += dp.numel()
        nb = float(dp.norm())
        rel = float((dk - dp).norm()) / nb if nb else 0.0
        if rel > worst:
            worst, at = rel, k
    tree_map(lambda t, s: t.copy_(s), params, p0)
    log(f"train {label} bf16 step delta, kernels vs plain (lr 1e-3): "
        f"{same / total:.4f} of {total} new parameters equal; worst leaf "
        f"{at} ||d_k - d_p|| / ||d_p|| {worst:.3e} (informational: AdamW's "
        f"first step is about lr sign(g), so a grad element near 0 may "
        f"flip); {card}")


def _first_repeats(cfg, tree, n: int):
    """(cfg cut to the first ``n`` repeats of its one group, the same cut
    of a parameter tree: every stacked leaf's first ``n``)."""
    (g,) = cfg.groups
    return (cfg.scaled(groups=(dataclasses.replace(g, repeats=n),)),
            {**tree, "groups": tree_map(lambda t: t[:n], tree["groups"])})


def _train_zamba2(card: str, tmp: str):
    """zamba2-2.7b whole: the grad check, 2 trainer steps, one profiled
    step, one step's delta kernels vs plain.  Returns the trainer run's
    flash and scan launches."""
    cfg = zamba2_2p7b.CONFIG
    B, S = TRAIN_SHAPES["zamba2"]
    params = _model(cfg, f"no cut, remat={cfg.remat}; train B={B} S={S}")
    batch = _pipeline_batch(cfg, B, S, SEED)
    _train_grad_check("zamba2-2.7b", cfg, params, batch, card)
    (g,) = cfg.groups
    del params
    free_cuda()
    # 2 trainer steps (4 before the distribution slice: the script's time
    # limit holds the dist phase)
    tr, out, per_step, _ = _train_run("zamba2-2.7b", cfg, B, S, 2, card,
                                      f"{tmp}/zamba2")
    want = _train_launches(cfg)         # 2 x 9 and 2 x 54 at full depth
    got = {k: per_step[k] for k in want}
    if got != want:
        raise AssertionError(f"zamba2 train launches per step {got}, want "
                             f"{want} (remat: forward and recompute)")
    launches = {k: build.launch_counts[k] for k in want}
    params, opt = out["params"], out["opt"]
    del tr, out
    free_cuda()
    cut, _ = _first_repeats(cfg, params, PROFILE_REPEATS)
    first = lambda tree: _first_repeats(cfg, tree, PROFILE_REPEATS)[1]
    t0 = time.monotonic()
    _profiled_step(f"zamba2-2.7b ({PROFILE_REPEATS} of {g.repeats} pattern "
                   f"repeats)", cut, first(params),
                   opt._replace(m=first(opt.m), v=first(opt.v)), batch, card)
    del opt
    free_cuda()
    log(f"time: train zamba2 profiled step {time.monotonic() - t0:.1f} s")
    _step_delta("zamba2-2.7b", cfg, params, batch, card)
    del params, batch
    free_cuda()
    return launches


def _train_rwkv6(card: str, tmp: str) -> None:
    """rwkv6-1.6b: the grad check on its first layer and on its first
    RWKV6_GRAD_LAYERS layers (the scan's vector decay and bonus) and
    2 trainer steps.  (Its step is not profiled: the plain scan VJP's thousands of small ops a call cost the
    profiler minutes of host time; ``_vjp_times`` times that VJP.)"""
    cfg = rwkv6_1p6b.CONFIG
    B, S = TRAIN_SHAPES["rwkv6"]
    params = _model(cfg, f"no cut, remat={cfg.remat}; train B={B} S={S}")
    batch = _pipeline_batch(cfg, B, S, SEED)
    (g,) = cfg.groups
    n = RWKV6_GRAD_LAYERS
    _train_grad_check("rwkv6-1.6b first layer",
                      *_first_repeats(cfg, params, 1), batch, card)
    _train_grad_check(f"rwkv6-1.6b ({n} of {g.repeats} layers)",
                      *_first_repeats(cfg, params, n), batch, card,
                      f64_scan=True)
    del params
    free_cuda()
    del batch
    _train_run("rwkv6-1.6b", cfg, B, S, 2, card, f"{tmp}/rwkv6")
    free_cuda()


def _train_deepseek(card: str, tmp: str) -> None:
    """deepseek-v3 at full width cut to its first dense layer (the MoE
    group dropped) with the MTP head: the grad check, 2 trainer steps,
    and a profiled third whose MTP loss and ``mtp`` grads are checked."""
    full = deepseek_v3_671b.CONFIG
    g0 = full.groups[0]
    cfg = full.scaled(groups=(dataclasses.replace(g0, repeats=1),))
    B, S = TRAIN_SHAPES["deepseek"]
    params = _model(cfg, f"cut: groups {g0.repeats} dense + "
                         f"{full.groups[1].repeats} MoE -> 1 dense, MoE "
                         f"group dropped; full width, MTP head; train B={B} "
                         f"S={S}")
    batch = _pipeline_batch(cfg, B, S, SEED)
    _train_grad_check("deepseek-v3 (1 dense + MTP)", cfg, params, batch, card)
    del params
    free_cuda()
    tr, out, _, _ = _train_run("deepseek-v3 (1 dense + MTP)", cfg, B, S, 2,
                               card, f"{tmp}/deepseek")
    del tr
    free_cuda()
    m, grads = _profiled_step("deepseek-v3 (1 dense + MTP)", cfg,
                              out["params"], out["opt"], batch, card)
    mtp = list(flatten_with_paths(grads["mtp"]))
    zero = [k for k, g in mtp if not float(g.float().abs().max()) > 0]
    log(f"train deepseek-v3 bf16 after 2 steps: ce {m['ce']:.4f}, mtp "
        f"{m['mtp']:.4f}, loss {m['loss']:.4f}; mtp/* leaves with a nonzero "
        f"grad: {len(mtp) - len(zero)} of {len(mtp)}; {card}")
    if zero or not m["mtp"] > 0:
        raise AssertionError(f"deepseek mtp: loss {m['mtp']}, zero grads "
                             f"{zero}")
    del out, grads, batch
    free_cuda()


def _train_whisper(card: str, tmp: str) -> None:
    """whisper-small whole: the grad check (encoder, cross attention),
    then an uninterrupted 4-step run (and a profiled fifth step) against
    one saved asynchronously at step 2 and finished by a fresh trainer
    from the checkpoint."""
    cfg = whisper_small.CONFIG
    B, S = TRAIN_SHAPES["whisper"]
    params = _model(cfg, f"no cut, remat={cfg.remat}; train B={B} S={S}, "
                         f"{cfg.n_frontend_tokens} frames")
    batch = _pipeline_batch(cfg, B, S, SEED)
    _train_grad_check("whisper-small", cfg, params, batch, card)
    del params
    free_cuda()
    _, a, _, _ = _train_run("whisper-small", cfg, B, S, 4, card,
                            f"{tmp}/whisper_a")
    _profiled_step("whisper-small", cfg, a.pop("params"), a.pop("opt"),
                   batch, card)
    del batch
    restart = lambda **kw: Trainer(
        cfg, TrainerConfig(steps=4, ckpt_every=2, ckpt_dir=f"{tmp}/whisper_b",
                           log_every=10 ** 6, seed=SEED),
        DataConfig(vocab=cfg.vocab, seq_len=S, global_batch=B, seed=SEED),
        device=DEV, **kw)
    t1 = restart(generator=torch.Generator(device=DEV).manual_seed(SEED))
    t1.run(max_steps=2)                     # async save at step 2
    waits = t1.ckpt.async_waits
    del t1
    free_cuda()
    t2 = restart()
    b = t2.run()                            # restores at 2, finishes 4
    la, lb = a["history"][-1]["loss"], b["history"][-1]["loss"]
    log(f"train whisper-small checkpoint restart: async save at step 2 "
        f"(trainer pings {waits}), restored run resumed at step "
        f"{b['history'][0]['step']} and ended at step {b['step']}; final "
        f"loss {lb:.5f} vs uninterrupted {la:.5f} (|diff| {abs(la - lb):.2e}"
        f", tol {RESTART_TOL:g}); {card}")
    if b["step"] != 4 or b["history"][0]["step"] != 2 or \
            abs(la - lb) >= RESTART_TOL:
        raise AssertionError("whisper checkpoint restart diverged")
    del a, b, t2
    free_cuda()


def _train_tiny(card: str, tmp: str) -> dict:
    """The twin of examples/train_tiny_lm.py, TINY_STEPS steps on the
    card: the mean of the last 10 losses below that of the first 10."""
    t0 = time.monotonic()
    # the example installs the trainer's SIGTERM handler: this process's
    # own comes back once the run is over
    sigterm = signal.getsignal(signal.SIGTERM)
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            out = tiny_lm.main(["--steps", str(TINY_STEPS), "--device", DEV,
                                "--ckpt-dir", f"{tmp}/tiny"])
    finally:
        signal.signal(signal.SIGTERM, sigterm)
    first = sum(h["loss"] for h in out["history"][:10]) / 10
    last = sum(h["loss"] for h in out["history"][-10:]) / 10
    log(f"train tiny-lm (examples/train_tiny_lm_torch.py): loss {first:.3f}"
        f" -> {last:.3f} over {out['step']} steps in "
        f"{time.monotonic() - t0:.1f} s; {card}")
    if not last < first:
        raise AssertionError("tiny-lm did not learn")
    return out


# the kernels' call shapes in the train runs above: (kind, shape) as in
# FLASH_SHAPES / SCAN_SHAPES
TRAIN_VJP_SHAPES = {
    "zamba2 attention": ("flash", FLASH_SHAPES["zamba2 prefill"]),
    "mamba2 scan": ("scan", SCAN_SHAPES["mamba2"]),
    "rwkv6 scan": ("scan", SCAN_SHAPES["rwkv6"]),
    "deepseek MLA": ("flash", FLASH_SHAPES["deepseek MLA train"]),
    "deepseek MTP attention": ("flash", FLASH_SHAPES["deepseek MTP"]),
    "whisper encoder": ("flash", FLASH_SHAPES["whisper encoder"]),
    "whisper self": ("flash", FLASH_SHAPES["whisper self"]),
    "whisper cross": ("flash", FLASH_SHAPES["whisper cross"]),
}


# SDPA's backward beside the plain VJP, at the callers' shapes whose
# forward SDPA computes (no window, no softcap)
SDPA_BWD_SHAPES = ("zamba2 attention", "deepseek MLA",
                   "deepseek MTP attention", "whisper encoder",
                   "whisper self", "whisper cross")


def _vjp_bound(kind: str, shape, leaves, grad_out, dtype):
    """(ms, what bounds it) for a backward's work.  Flash: its products,
    2.5x the forward's operations (S = Q K^T recomputed, dV = P^T dO,
    dP = dO V^T, dQ = dS K, dK = dS^T Q against the forward's two),
    against q, k, v, o and dO read and dq, dk, dv written once.  The scan:
    its bytes -- the inputs and the output's grad read, a grad of every
    input written once (its products, a few per element, lie far below
    the bytes at these shapes)."""
    if kind == "flash":
        elems, flops = flash_work(shape)
        B, Sq, Sk, H, Hkv, D, Dv = shape[:7]
        elems += B * Sq * H * Dv + B * (Sq * H * D + Sk * Hkv * (D + Dv))
        return bound_ms(elems * 2, 2.5 * flops, dtype)
    ins = [t for t in leaves if t is not None]
    nbytes = 2 * sum(_stored_bytes(t) for t in ins) + _stored_bytes(grad_out)
    return bound_ms(nbytes, 0.0, dtype)


def _vjp_times(card: str) -> None:
    """bf16, CUDA events, random inputs at each of TRAIN_VJP_SHAPES: one
    plain VJP (the backward of the kernel's autograd.Function: the plain
    forward recomputed, then its grads) against the kernel's forward, the
    backward's bound and, where SDPA computes the forward, SDPA's backward
    (``enable_gqa``, through ``torch.autograd.grad``) as the library's
    time."""
    g = torch.Generator(device=DEV).manual_seed(SEED + 18)
    dt = torch.bfloat16
    for name, (kind, shape) in TRAIN_VJP_SHAPES.items():
        if kind == "flash":
            B, Sq, Sk, H, Hkv, D, Dv, causal, window, cap = shape
            ins = [_randn(g, (B, Sq, H, D), dt), _randn(g, (B, Sk, Hkv, D), dt),
                   _randn(g, (B, Sk, Hkv, Dv), dt)]
            kw = dict(causal=causal, window=window, softcap=cap)
            fwd = lambda: fa.flash_attention(*ins, **kw)
            plain = lambda q, k, v: ref.flash_attention_ref(q, k, v, **kw)
        else:
            (q, k, v, ld), bonus = _scan_inputs(g, shape, dt)
            ins = [q, k, v, ld, bonus]
            chunk = shape[6]
            fwd = lambda: ls.linear_scan(*ins[:4], bonus=ins[4], chunk=chunk)
            plain = lambda q, k, v, ld, u: ref.linear_scan_ref(
                q, k, v, ld, bonus=u, chunk=chunk)[0]
        with torch.no_grad():
            kernel = cuda_ms(fwd, iters=5, warmup=1)
            out = fwd()
        grad_out = torch.randn((out[0] if kind == "scan" else out).shape,
                               generator=g, device=DEV).to(dt)
        leaves = [None if t is None else t.detach().requires_grad_(True)
                  for t in ins]
        op = "flash_attention" if kind == "flash" else "linear_scan"
        vjp = cuda_ms(lambda: build.vjp(op, plain, leaves, grad_out),
                      iters=3, warmup=1)
        bound, by = _vjp_bound(kind, shape, leaves, grad_out, dt)
        lib = "none (no single call)"
        if name in SDPA_BWD_SHAPES:
            qt, kt, vt = (t.detach().transpose(1, 2).contiguous()
                          .requires_grad_(True) for t in ins)
            o = torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=H != Hkv)
            go = grad_out.transpose(1, 2).contiguous()
            sdpa = cuda_ms(lambda: torch.autograd.grad(
                o, (qt, kt, vt), go, retain_graph=True), iters=5, warmup=1)
            lib = f"SDPA backward {sdpa:.4f} ms"
            del qt, kt, vt, o, go
        log(f"train VJP bf16 at {name} {shape}: plain VJP {vjp:.3f} ms a "
            f"call, kernel forward {kernel:.4f} ms ({vjp / kernel:.0f}x); "
            f"{lib}; backward bound {bound:.6f} ms ({by}); CUDA events; "
            f"{card}")
        del ins, leaves, out, grad_out
        free_cuda()


def phase_train(card: str):
    """The training slice on the card.  Returns the flash and scan
    launches of the zamba2 trainer run (the slice's main path)."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    t0 = time.monotonic()

    def done(what: str) -> None:
        log(f"time: train {what} at {time.monotonic() - t0:.1f} s into the "
            f"phase")
    try:
        launches = _train_zamba2(card, tmp)
        done("zamba2")
        _train_rwkv6(card, tmp)
        done("rwkv6")
        _train_deepseek(card, tmp)
        done("deepseek")
        _train_whisper(card, tmp)
        done("whisper")
        out = _train_tiny(card, tmp)
        done("tiny-lm")
        # runtime g: the tiny trainer's checkpoint, restored and served
        for name, n in _runtime_system(card, out, f"{tmp}/tiny").items():
            launches[name] = launches.get(name, 0) + n
        done("runtime g")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    _vjp_times(card)
    done("VJP times")
    return launches


# ----------------------------------------------------------------------------
# 12. dist
# ----------------------------------------------------------------------------

DIST_RANKS = 8
EP_STEPS = 1                     # olmoe EP bf16 train steps (2 before)
# the depth of the olmoe EP and starcoder2 CP cases (2 layers each before:
# the script took 1205.7 s once on a slow host)
EP_LAYERS = 1
CP_LAYERS = 1
DIST_TIMEOUT_S = 480.0           # the ranks' limit, spawn included
# Gloo on CUDA tensors (an H100, torch 2.11.0+cu128; each collective tried
# alone in 8 processes of their own): its all-gather into a tensor crashes
# the process (SIGSEGV) and send / recv abort (SIGABRT: a device pointer
# handed to its TCP transport).  Those two are staged through host memory
# (``parallel/collectives.py``), and counted; all-reduce, reduce-scatter,
# all-to-all and broadcast run on CUDA tensors as they are, in this phase.
GLOO_STAGED = ("all_gather_into_tensor", "send_recv")
DIST_LOSS_TOL = 1e-4             # f32 loss and MoE outputs, relative
DIST_BF16_LOSS_TOL = 2e-2        # bf16 loss, relative (rounding order)
DIST_F32_FLIPS = 1e-3            # f32 token-layers choosing other experts
COMPRESS_TOL = 0.02              # tests/test_parallel.py's bounds
FEEDBACK_TOL = 0.005
PIPE_ATOL = 1e-4
DRYRUN_CELLS = (("rwkv6_1p6b", "decode_32k", False),
                ("whisper_small", "prefill_32k", True),
                ("zamba2_2p7b", "long_500k", False),
                ("rwkv6_1p6b", "long_500k", False),
                ("gemma2_27b", "long_500k", False),
                ("gemma2_27b", "prefill_32k", True))
# the reference's dry-run of the same cells, FLOPs a device: counts of
# work, from `python -m repro.launch.dryrun` run on a CPU with jax.make_mesh
# defaulting to Auto axes (tests/test_torch_dryrun_parity.py's wrapper),
# not a time on any chip; gemma2 long_500k is a skip in both packages
REF_DRYRUN_FLOPS = {("rwkv6_1p6b", "decode_32k", False): 1452277760.0,
                    ("whisper_small", "prefill_32k", True): 3554671337472.0,
                    ("zamba2_2p7b", "long_500k", False): 215923456.0,
                    ("rwkv6_1p6b", "long_500k", False): 12451840.0,
                    ("gemma2_27b", "prefill_32k", True): 125258573676544.0}
# and its collective bytes a device (ring formulas over its HLO's
# collectives): the same run's counts
REF_DRYRUN_COLLECTIVE = {("rwkv6_1p6b", "decode_32k", False): 351316928.0,
                         ("whisper_small", "prefill_32k", True):
                         4489163776.0,
                         ("zamba2_2p7b", "long_500k", False): 991447.5,
                         ("rwkv6_1p6b", "long_500k", False): 674215.5,
                         ("gemma2_27b", "prefill_32k", True):
                         110612989888.0}
# and its bytes a device (``per_device_total_gib``) where the cell's is
# held to it: a prefill on the multi-pod mesh, whose embedding lookup
# gathered the whole table onto every rank before (5.564 GiB)
REF_DRYRUN_MEMORY = {("gemma2_27b", "prefill_32k", True): 3.558}
# a batch-1 decode cell's collective bytes over the reference's
# (tests/test_torch_dryrun_parity.py's GATHERED_LIMIT)
DRYRUN_LONG_LIMIT = 1.10
# a prefill cell's FLOPs, collective bytes and bytes a device over the
# reference's (the parity tests' FLOPS_LIMIT, GATHERED_LIMIT, MEMORY_LIMIT)
DRYRUN_PREFILL_LIMIT = 1.10
DRYRUN_TIMEOUT_S = 600.0


def _rel(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm()) / max(float(b.norm()), 1e-30)


class _Worst:
    """The largest ||a - b|| / ||b|| over pairs added, whether every pair
    was finite with b nonzero, and the keys whose distance passed their
    limit (``limit``: one number, or a dict by key)."""

    def __init__(self, limit=math.inf):
        self.limit, self.over = limit, []
        self.value, self.at, self.finite, self.n = 0.0, None, True, 0

    def tol(self, key) -> float:
        return self.limit[key] if isinstance(self.limit, dict) else self.limit

    def add(self, key, a, b) -> None:
        self.n += 1
        na, nb = float(a.float().norm()), float(b.float().norm())
        if not (math.isfinite(na) and math.isfinite(nb) and nb > 0):
            self.finite = False
            return
        e = _rel(a, b)
        if e > self.value:
            self.value, self.at = e, key
        if e > self.tol(key):
            self.over.append(key)

    @property
    def ok(self) -> bool:
        return self.finite and not self.over


class _MoETap:
    """Records every MoE layer's output during a forward (the model's
    ``apply_moe`` wrapped)."""

    def __enter__(self):
        self.outs, self._was = [], model_mod.apply_moe

        def tap(p, x, *, cfg):
            out, aux = self._was(p, x, cfg=cfg)
            self.outs.append(out.detach())
            return out, aux
        model_mod.apply_moe = tap
        return self

    def __exit__(self, *exc):
        model_mod.apply_moe = self._was


class _EPPin:
    """The unsharded run's expert choices, recorded and replayed in the
    sharded run.  The router's top-k is discrete: f32 noise of a
    reduction order flips a near-tie now and then among 8192 tokens x 64
    experts, and the flipped token's output then differs by a whole
    expert's share (at 2 layers on an H100, unpinned: MoE outputs 6.4e-3
    apart).  Pinned, the two runs differ only by their numerics.
    ``record`` keeps each layer's router top-k indices (T, k) from the
    forward; ``replay`` hands each expert-parallel shard its own tokens'
    recorded choices (the shard at mesh coordinate (d, m) holds batch rows
    d*B_l.. and sequence positions m*S_l..) with its own gates' weights,
    and counts the tokens whose own choice differed.  Under remat "full"
    the backward reruns the layers' forwards in reverse order: call j of
    the 2L a step makes is layer j, then layer 2L - 1 - j."""

    def __init__(self, top_k: int, n_layers: int):
        self.k, self.n, self.rec, self.flips = top_k, n_layers, [], 0

    def _patched(self, fn):
        real = moe_mod._top_k

        def top_k(x, k):
            if k != self.k:             # the capacity selection: not pinned
                return real(x, k)
            return fn(real, x, k)
        moe_mod._top_k = top_k
        return real

    @contextlib.contextmanager
    def record(self):
        def fn(real, x, k):
            v, i = real(x, k)
            if len(self.rec) < self.n:      # the forward's; not the rerun
                self.rec.append(i)
            return v, i
        real = self._patched(fn)
        try:
            yield self
        finally:
            moe_mod._top_k = real

    @contextlib.contextmanager
    def replay(self, coord, B: int, S: int, shape_local):
        d, m = coord
        Bl, Sl = shape_local
        rows = (torch.arange(Bl, device=DEV)[:, None] + d * Bl) * S \
            + m * Sl + torch.arange(Sl, device=DEV)[None, :]
        at = [0]

        def fn(real, x, k):
            own = real(x, k)[1]
            j = at[0] if at[0] < self.n else 2 * self.n - 1 - at[0]
            idx = self.rec[j][rows.reshape(-1)]
            if at[0] < self.n:
                self.flips += int((torch.sort(own, -1).values
                                   != torch.sort(idx, -1).values)
                                  .any(-1).sum())
            at[0] += 1
            return x.gather(-1, idx), idx
        real = self._patched(fn)
        try:
            yield self
        finally:
            moe_mod._top_k = real


class _RoutePin:
    """The unsharded f32 decode step's expert choices (each MoE layer's
    router top-k, (T, k)), recorded there and replayed in the other decode
    steps, as _EPPin does for the train step.  Without expert parallelism
    every rank routes the whole batch, so each layer's call gets the whole
    recorded choice back; the router's top-k is told from the capacity's
    (C = T = top_k at B = 8) by its last dim, the experts'.  ``flips``
    counts the token-layers whose own choice differed."""

    def __init__(self, cfg):
        self.k, self.E = cfg.moe.top_k, cfg.moe.n_experts
        self.rec, self.flips = [], 0

    @contextlib.contextmanager
    def _patched(self, fn):
        real = moe_mod._top_k

        def top_k(x, k):
            if k != self.k or x.shape[-1] != self.E:
                return real(x, k)
            return fn(real, x, k)
        moe_mod._top_k = top_k
        try:
            yield self
        finally:
            moe_mod._top_k = real

    def record(self):
        def fn(real, x, k):
            v, i = real(x, k)
            self.rec.append(i)
            return v, i
        return self._patched(fn)

    def replay(self):
        at = [0]

        def fn(real, x, k):
            own, idx = real(x, k)[1], self.rec[at[0]].to(x.device)
            at[0] += 1
            self.flips += int((torch.sort(own, -1).values
                               != torch.sort(idx, -1).values).any(-1).sum())
            return x.gather(-1, idx), idx
        return self._patched(fn)


def _compare_sharded(rank, mesh, dp, batch, cfg, ref,
                     pin=contextlib.nullcontext(), moe_tol=math.inf,
                     grad_tol=math.inf):
    """value_and_grad on ``mesh`` over the DTensor parameters ``dp`` (under
    ``pin``: a routing replay), held leaf by leaf against ``ref`` = (loss,
    MoE outputs, grads by path) of the unsharded run, which rank 0 holds:
    each sharded tensor is gathered whole (a collective) and compared on
    rank 0, one at a time, under its limit (``_Worst``).  Returns
    (sharded loss, worst MoE output, worst grad) on rank 0."""
    sh.set_mesh(mesh)
    try:
        db = {k: sh.distribute(v, mesh, sh.batch_spec(mesh))
              for k, v in batch.items()}
        with _MoETap() as tap, pin:
            (loss, _), grads = value_and_grad(dp, db, cfg)
        free_cuda()     # the step's cached blocks back before the gathers
        loss = float(sh.full(loss))
        moe, grad = _Worst(moe_tol), _Worst(grad_tol)
        for i, o in enumerate(tap.outs):
            o = sh.full(o)
            if rank == 0:
                moe.add(f"layer {i}", o, ref[1][i])
        del tap
        for key, g in flatten_with_paths(grads):
            g = sh.full(g)
            if rank == 0:
                grad.add(key, g, ref[2][key])
            del g
        return loss, moe, grad
    finally:
        sh.set_mesh(None)


def _whole(params, batch, cfg, pin=contextlib.nullcontext()):
    """The unsharded run: (loss, MoE outputs, grads by path)."""
    with _MoETap() as tap, pin:
        (loss, _), grads = value_and_grad(params, batch, cfg)
    return float(loss), tap.outs, dict(flatten_with_paths(grads))


def _f32(tree):
    return tree_map(lambda t: t.float(), tree)


def _dist_olmoe(rank: int, failed: list) -> dict:
    """olmoe-1b-7b cut to EP_LAYERS on (data=2, model=4): expert parallelism
    over model, FSDP over data.  Held against the unsharded step (rank 0
    runs it first, the others waiting) with no token dropped and the aux
    losses off; then one bf16 train step with the config's own capacity
    and aux."""
    full = olmoe_1b_7b.CONFIG
    base = full.scaled(groups=(dataclasses.replace(full.groups[0],
                                                   repeats=EP_LAYERS),))
    cmp_cfg = base.scaled(moe=dataclasses.replace(
        base.moe, capacity_factor=8.0, aux_coef=0.0, router_z_coef=0.0))
    B, S = 4, 2048
    mesh = make_host_mesh((2, 4), ("data", "model"))
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    params = init_params(base, gen, device=DEV)
    dp16 = sh.tree_distribute(mesh, params, params_logical_axes(base))
    if rank != 0:
        del params              # only rank 0 runs the unsharded step
        free_cuda()
    batch = _pipeline_batch(base, B, S, SEED + 19)
    if rank == 0:
        log(
            f"model: {base.name} layers={base.n_layers} d_model="
            f"{base.d_model} experts={base.moe.n_experts} top-"
            f"{base.moe.top_k} (cut: {full.n_layers} -> {base.n_layers} "
            f"layers; full width; mesh data=2 x model=4, EP over model, FSDP "
            f"over data; the comparison's overrides: capacity_factor 8.0 (no "
            f"token drops: C = T on every shard), aux_coef = router_z_coef = "
            f"0 (EP's aux is a mean over shards); remat {base.remat}; train "
            f"B={B} S={S})")
    out = {}
    T = base.n_layers * B * S
    # every run under the unsharded f32 run's routing (recorded there,
    # replayed in the others): the runs then differ by their numerics only
    pin = _EPPin(base.moe.top_k, base.n_layers)
    ref32 = None        # rank 0: the unsharded f32 run's MoE outputs, grads
    own = ({}, {})      # rank 0: the unsharded bf16 run's distance from it
    for dtype in ("float32", "bfloat16"):
        cfg = cmp_cfg.scaled(dtype=dtype)
        f32 = dtype == "float32"
        ref = None
        moe_tol, grad_tol = DIST_LOSS_TOL, TRAIN_GRAD_TOL
        if rank == 0 and f32:
            ref = _whole(_f32(params), batch, cfg, pin.record())
        elif rank == 0:
            # the bf16 limits: max(SLICE_TOL, 2 x the unsharded bf16 run's
            # own distance from the f32 one), per MoE layer and grad leaf
            ref = _whole(params, batch, cfg, pin.replay((0, 0), B, S, (B, S)))
            own = ({f"layer {i}": _rel(o, ref32[1][i])
                    for i, o in enumerate(ref[1])},
                   {k: _rel(g, ref32[2][k].to(DEV))
                    for k, g in ref[2].items()})
            moe_tol, grad_tol = ({k: max(SLICE_TOL, 2 * e)
                                  for k, e in d.items()} for d in own)
            ref32 = None
        free_cuda()
        if f32:         # the unsharded run's choices to every rank
            rec = torch.stack(pin.rec) if rank == 0 else torch.empty(
                (base.n_layers, B * S, cfg.moe.top_k), dtype=torch.long,
                device=DEV)
            dist.broadcast(rec, 0)
            pin.rec = list(rec)
        pin.flips = 0
        t0 = time.monotonic()
        ls, moe, grad = _compare_sharded(
            rank, mesh, _f32(dp16) if f32 else dp16, batch, cfg, ref,
            pin.replay(mesh.get_coordinate(), B, S, (B // 2, S // 4)),
            moe_tol, grad_tol)
        t_s = time.monotonic() - t0
        flips = torch.tensor([pin.flips], device=DEV)
        dist.all_reduce(flips)
        if rank == 0:
            lu = ref[0]
            loss_rel = abs(ls - lu) / abs(lu)
            tol = DIST_LOSS_TOL if f32 else DIST_BF16_LOSS_TOL
            # f32 noise flips a near-tie now and then; a wrong router or
            # wrong tokens on a shard would flip most of them
            flips_ok = not f32 or int(flips) <= DIST_F32_FLIPS * T
            held = loss_rel <= tol and moe.ok and grad.ok and flips_ok
            lim = ((lambda w, o: f"tol {w.limit:g}") if f32 else
                   (lambda w, o: f"tol max({SLICE_TOL:g}, 2 x the "
                    f"unsharded bf16 run's own distance from f32, "
                    f"{min(o.values()):.3e}-{max(o.values()):.3e})"))
            log(
                f"dist olmoe EP {dtype}: loss sharded {ls:.6f} unsharded "
                f"{lu:.6f} (rel {loss_rel:.3e}, tol {tol:g}); {moe.n} MoE "
                f"layers' outputs max rel {moe.value:.3e} "
                f"({lim(moe, own[0])}; over: {moe.over}); grads {grad.n} "
                f"leaves finite and nonzero: {grad.finite}, worst {grad.at} "
                f"{grad.value:.3e} ({lim(grad, own[1])}; over: {grad.over}); "
                f"the unsharded f32 run's routing replayed (the run's own "
                f"choice differed at {int(flips)} of {T} token-layers"
                + (f", tol {DIST_F32_FLIPS * T:g}" if f32 else "")
                + f"); sharded value_and_grad with the comparison "
                f"{1e3 * t_s:.0f} ms: {held}")
            if not held:
                failed.append(f"dist olmoe {dtype}: sharded vs unsharded")
            if f32:     # kept for the bf16 limits; the grads on the host
                ref32 = (ref[0], ref[1],
                         {k: g.cpu() for k, g in ref[2].items()})
        del ref
        free_cuda()
    if rank == 0:
        del params
    # bf16 steps with the config's own capacity and aux (one since the
    # runtime phase came: 8-10 s a step, the script's time limit)
    sh.set_mesh(mesh)
    try:
        db = {k: sh.distribute(v, mesh, sh.batch_spec(mesh))
              for k, v in batch.items()}
        opt = adamw_init(dp16)
        step = make_train_step(base)
        free_cuda()
        torch.cuda.reset_peak_memory_stats()
        times, losses = [], []
        for _ in range(EP_STEPS):
            torch.cuda.synchronize()
            dist.barrier()
            t0 = time.monotonic()
            dp16, opt, m = step(dp16, opt, db)
            losses.append(float(sh.full(m["loss"])))
            torch.cuda.synchronize()
            times.append(1e3 * (time.monotonic() - t0))
        out["steps_ms"], out["losses"] = times, losses
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    finally:
        sh.set_mesh(None)
    if not all(math.isfinite(x) for x in losses):
        failed.append(f"dist olmoe bf16 steps: losses {losses}")
    del dp16, opt, db
    free_cuda()
    return out


def _dist_olmoe_decode(rank: int, failed: list) -> dict:
    """olmoe-1b-7b cut to 2 layers on (data=2, model=4): one decode step at
    B = 8 after a 64-token prefill, laid out as decode is -- no expert
    parallelism (S = 1 does not divide ``model``): every rank routes the
    whole batch and runs its own 16 experts on the weights where they lie,
    and every matrix of the step is used where it lies -- against the same
    step unsharded (rank 0; its prefill's cache handed to every rank).
    f32 logits within DIST_LOSS_TOL relative; bf16 within max(SLICE_TOL,
    2 x the unsharded bf16 step's own distance from f32); every step under
    the unsharded f32 step's routing; the token's K and V, written into
    the cache shard by shard, against the unsharded step's."""
    full = olmoe_1b_7b.CONFIG
    base = full.scaled(groups=(dataclasses.replace(full.groups[0],
                                                   repeats=2),))
    B, S0 = 8, 64
    mesh = make_host_mesh((2, 4), ("data", "model"))
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    params = init_params(base, gen, device=DEV)
    dp16 = sh.tree_distribute(mesh, params, params_logical_axes(base))
    if rank != 0:
        del params
        free_cuda()
    toks = _pipeline_batch(base, B, S0 + 1, SEED + 24)["tokens"]
    if rank == 0:
        log(f"model: {base.name} layers={base.n_layers} (cut: "
            f"{full.n_layers} -> {base.n_layers} layers; full width; mesh "
            f"data=2 x model=4, decode: no EP, the weights where they lie; "
            f"one decode step at B={B} after a {S0}-token prefill)")
    pin = _RoutePin(base)
    ref32, out = None, {}
    for dtype in ("float32", "bfloat16"):
        c = base.scaled(dtype=dtype)
        f32 = dtype == "float32"
        ref = None
        if rank == 0:
            p = _f32(params) if f32 else params
            _, pc, _ = apply_model(p, toks[:, :S0], cfg=c, mode="prefill")
            cache = _graft(c, pc, B, S0 + 1)
            del pc
            cu = tree_map(torch.clone, cache)
            with pin.record() if f32 else pin.replay():
                lg, cu, _ = apply_model(p, toks[:, S0:], cfg=c,
                                        mode="decode", cache=cu)
            kv = cu["groups"]["g0"]["p0"]
            ref = (lg[:, 0, :base.vocab].float(),
                   {n: kv[n][:, :, S0].float() for n in ("k", "v")})
            del p, cu, lg
        else:
            cache = init_cache(c, B, S0 + 1, c.dtype, device=DEV)
        for leaf in tree_leaves(cache):
            dist.broadcast(leaf, 0)
        if f32:         # the unsharded step's choices to every rank
            rec = torch.stack(pin.rec) if rank == 0 else torch.empty(
                (base.n_layers, B, base.moe.top_k), dtype=torch.long,
                device=DEV)
            dist.broadcast(rec, 0)
            pin.rec = list(rec)
        pin.flips = 0
        sh.set_mesh(mesh)
        try:
            dc = sh.tree_distribute(mesh, cache, model_mod.cache_axes(c))
            dtok = sh.distribute(toks[:, S0:], mesh, sh.batch_spec(mesh))
            torch.cuda.synchronize()
            t0 = time.monotonic()
            with pin.replay():
                lg, dc, _ = apply_model(_f32(dp16) if f32 else dp16, dtok,
                                        cfg=c, mode="decode", cache=dc)
            torch.cuda.synchronize()
            t_s = 1e3 * (time.monotonic() - t0)
            lg = sh.full(lg)[:, 0, :base.vocab].float()
            kv = {n: sh.full(dc["groups"]["g0"]["p0"][n])[:, :, S0].float()
                  for n in ("k", "v")}
        finally:
            sh.set_mesh(None)
        del cache, dc
        flips = torch.tensor([pin.flips], device=DEV)
        dist.all_reduce(flips)
        if rank == 0:
            if f32:
                tol, lim = DIST_LOSS_TOL, f"tol {DIST_LOSS_TOL:g}"
                ref32 = ref
            else:
                e = _rel(ref[0], ref32[0])
                tol = max(SLICE_TOL, 2 * e)
                lim = (f"tol max({SLICE_TOL:g}, 2 x the unsharded bf16 "
                       f"step's own distance from f32, {e:.3e})")
            e_lg = _rel(lg, ref[0])
            e_kv = max(_rel(kv[n], ref[1][n]) for n in ("k", "v"))
            ok = (bool(torch.isfinite(lg).all()) and e_lg <= tol
                  and e_kv <= tol)
            T = base.n_layers * B
            log(f"dist olmoe decode {dtype}: logits {tuple(lg.shape)} "
                f"sharded vs unsharded rel {e_lg:.3e}, the token's K/V in "
                f"the cache rel {e_kv:.3e} ({lim}); the unsharded f32 "
                f"step's routing replayed (each rank's own choice differed "
                f"at {int(flips)} of {T} token-layers, summed over the "
                f"{DIST_RANKS} ranks); sharded step {t_s:.0f} ms (host "
                f"clock, {DIST_RANKS} ranks on one card): {ok}")
            if not ok:
                failed.append(f"dist olmoe decode {dtype}: sharded vs "
                              f"unsharded")
            out[dtype] = {"logits_rel": e_lg, "kv_rel": e_kv, "ms": t_s}
        del lg, kv, ref
        free_cuda()
    if rank == 0:
        del params
    del dp16, ref32
    free_cuda()
    return out


def _dist_cp(rank: int, failed: list) -> dict:
    """starcoder2-7b cut to CP_LAYERS on (data=1, model=8): 36 heads do not
    divide 8, so attention runs context parallel (each rank the flash
    kernel on its 256 query rows at q_offset = rank x 256).  The prefill
    logits (bf16, f32) and one f32 step's grads against the unsharded
    ones (rank 0)."""
    full = starcoder2_7b.CONFIG
    cfg = full.scaled(groups=(dataclasses.replace(full.groups[0],
                                                  repeats=CP_LAYERS),))
    B, S = 2, 2048
    mesh = make_host_mesh((1, 8), ("data", "model"))
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    params = init_params(cfg, gen, device=DEV)
    dp16 = sh.tree_distribute(mesh, params, params_logical_axes(cfg))
    if rank != 0:
        del params
        free_cuda()
    batch = _pipeline_batch(cfg, B, S, SEED + 20)
    if rank == 0:
        log(
            f"model: {cfg.name} layers={cfg.n_layers} d_model={cfg.d_model}"
            f" heads={cfg.n_heads}/{cfg.n_kv_heads} (cut: {full.n_layers} -> "
            f"{cfg.n_layers} layers; full width; mesh data=1 x model=8, "
            f"context parallel: {cfg.n_heads} % 8 != 0; prefill and train "
            f"B={B} S={S})")
    out, logits = {"flash": {}}, {}
    for dtype in ("bfloat16", "float32"):
        c = cfg.scaled(dtype=dtype)
        cast = _f32 if dtype == "float32" else (lambda t: t)
        sh.set_mesh(mesh)
        try:
            dt = sh.distribute(batch["tokens"], mesh, sh.batch_spec(mesh))
            build.reset_launch_counts()
            got = make_prefill_step(c)(cast(dp16), dt)[0]
            torch.cuda.synchronize()
            out["flash"][dtype] = build.launch_counts["flash_attention"]
            got = sh.full(got)
        finally:
            sh.set_mesh(None)
        if rank == 0:
            logits[dtype] = (got, make_prefill_step(c)(cast(params),
                                                       batch["tokens"])[0])
        del got
        free_cuda()
    if rank == 0:
        own = within(logits["bfloat16"][1], logits["float32"][1], 0.0)[0]
        for dtype, tol in (("float32", 1e-3),
                           ("bfloat16", max(SLICE_TOL, 2 * own))):
            a, b = logits[dtype]
            err, ok = within(a, b, tol)
            ok = ok and bool(torch.isfinite(a).all())
            log(
                f"dist starcoder2 CP prefill {dtype}: last-position logits "
                f"{tuple(a.shape)} sharded vs unsharded max |diff| "
                f"{err:.4e} (tol {tol:.4g} abs + rel): {ok}")
            if not ok:
                failed.append(f"dist starcoder2 CP {dtype} logits")
    del logits
    c = cfg.scaled(dtype="float32")
    ref = None
    if rank == 0:
        ref = _whole(_f32(params), batch, c)
        del params
        free_cuda()
    dist.barrier()
    build.reset_launch_counts()
    ls, _, grad = _compare_sharded(rank, mesh, _f32(dp16), batch, c, ref)
    out["flash"]["train"] = build.launch_counts["flash_attention"]
    if rank == 0:
        ok = grad.finite and grad.value <= TRAIN_GRAD_TOL
        log(
            f"dist starcoder2 CP train f32: loss sharded {ls:.6f} unsharded "
            f"{ref[0]:.6f}; {grad.n} leaves finite and nonzero: "
            f"{grad.finite}, worst {grad.at} {grad.value:.3e} (tol "
            f"{TRAIN_GRAD_TOL:g}): {ok}")
        if not ok:
            failed.append("dist starcoder2 CP grads")
    del ref, dp16
    free_cuda()
    return out


# the sharded layouts tests/test_torch_sharded_layout.py holds on the CPU's
# gloo ranks, at smoke width: (arch, step, mesh (data, model), batch)
LAYOUT_CASES = (
    ("llama32_vision_90b", "train", (2, 4), 4),   # the "groups" layout
    ("zamba2_2p7b", "train", (2, 4), 4),          # Mamba2 by heads
    ("starcoder2_7b", "decode", (2, 4), 4),       # cache sequence over model
    ("deepseek_v3_671b", "decode", (2, 4), 4),    # MLA's latent attention
    ("rwkv6_1p6b", "decode", (4, 2), 1),          # stationary, batch 1
    ("zamba2_2p7b", "decode", (2, 4), 4),         # stationary matmuls
    ("zamba2_2p7b", "decode", (2, 4), 1),         # Mamba2 by heads, batch 1
)
LAYOUT_SEQ, LAYOUT_CACHE = 16, 16      # train / prefill tokens; cache length


def _layout_batch(cfg, B, rng):
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (B, LAYOUT_SEQ)))
    batch = {"tokens": toks, "targets": torch.roll(toks, -1, 1)}
    if cfg.n_frontend_tokens:
        batch["frontend"] = torch.from_numpy(0.02 * rng.standard_normal(
            (B, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32))
    return {k: v.to(DEV) for k, v in batch.items()}


def _layout_train(cfg, mesh, params, dp, B, rank):
    """(the unsharded run's tensors on rank 0, the sharded run's gathered
    whole, the sharded run's launches): loss and every grad, and a
    prefill's last logits and every leaf of its cache."""
    batch = _layout_batch(cfg, B, np.random.default_rng(SEED + 31))

    def run(p, b):
        (loss, _), grads = value_and_grad(p, b, cfg)
        got = {"loss": loss.reshape(1)}
        got.update((f"grad {k}", g) for k, g in flatten_with_paths(grads))
        lg, cache = make_prefill_step(cfg)(p, b["tokens"], b.get("frontend"))
        got["prefill logits"] = lg
        got.update((f"prefill cache {k}", c) for k, c in
                   flatten_with_paths(cache["groups"]))
        return got

    ref = run(params, batch) if rank == 0 else None
    sh.set_mesh(mesh)
    try:
        db = {k: sh.distribute(v, mesh, sh.spec_for(
            mesh, ("batch",) + (None,) * (v.dim() - 1), tuple(v.shape)))
            for k, v in batch.items()}
        build.reset_launch_counts()
        got = run(dp, db)
        launches = dict(build.launch_counts)
        got = {k: sh.full(v) for k, v in got.items()}
    finally:
        sh.set_mesh(None)
    return ref, got, launches


def _layout_decode(cfg, mesh, params, dp, B, rank):
    """As :func:`_layout_train` for one decode step over a random cache
    (position 12 of 16): the logits and every cache leaf after it."""
    rng = np.random.default_rng(SEED + 30)
    cache = init_cache(cfg, B, LAYOUT_CACHE, dtype="float32", device=DEV)
    for leaf in tree_leaves(cache["groups"]):
        leaf.copy_(torch.from_numpy(0.5 * rng.standard_normal(
            tuple(leaf.shape)).astype(np.float32)))
    cache["pos"].fill_(12)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (B, 1))).to(DEV)

    def run(p, c, t):
        lg, c, _ = apply_model(p, t, cfg=cfg, mode="decode", cache=c)
        got = {"logits": lg}
        got.update((f"cache {k}", v) for k, v in
                   flatten_with_paths(c["groups"]))
        return got

    ref = run(params, tree_map(torch.clone, cache), toks) \
        if rank == 0 else None
    sh.set_mesh(mesh)
    try:
        dc = sh.tree_distribute(mesh, cache, model_mod.cache_axes(cfg))
        dt = sh.distribute(toks, mesh, sh.spec_for(mesh, ("batch", None),
                                                    tuple(toks.shape)))
        build.reset_launch_counts()
        got = run(dp, dc, dt)
        launches = dict(build.launch_counts)
        got = {k: sh.full(v) for k, v in got.items()}
    finally:
        sh.set_mesh(None)
    return ref, got, launches


def _dist_layouts(rank: int, failed: list) -> dict:
    """The sharded layouts that only the CPU's gloo ranks held before
    (LAYOUT_CASES), on the card at smoke width in f32 (TF32 off) against
    the unsharded port (rank 0): the "groups" layout (llama-vision: each
    rank projects its one kv head; a prefill's self-attention cache on
    sequence slices), Mamba2 by heads (zamba2: the weights re-laid, the
    activations never gathered), each trained and prefilled; decode over a
    cache whose sequence holds ``model`` (starcoder2's 2 kv heads over 4:
    the softmax combined over slices), MLA's latent attention over its
    sharded cache (deepseek), and the stationary products of decode at
    batch 1 (rwkv6) and 4 (zamba2), and zamba2's at batch 1 (Mamba2 by
    heads: in_proj's and the conv's shards realigned by all-to-all, the
    vectors used where they lie).  Every tensor within DIST_LOSS_TOL
    relative (a norm ratio); a leaf the unsharded run leaves all zero must
    be all zero.  Returns each case's kernel launches on this rank."""
    out = {}
    for arch, step, shape, B in LAYOUT_CASES:
        cfg = get_smoke_config(arch).scaled(dtype="float32")
        mesh = make_host_mesh(shape, ("data", "model"))
        params = _f32(init_params(cfg, torch.Generator(
            device=DEV).manual_seed(SEED), device=DEV))
        dp = sh.tree_distribute(mesh, params, params_logical_axes(cfg))
        t0 = time.monotonic()
        run = _layout_train if step == "train" else _layout_decode
        ref, got, launches = run(cfg, mesh, params, dp, B, rank)
        ms = 1e3 * (time.monotonic() - t0)
        name = f"{cfg.name} {step} {shape} B={B}"
        out[name] = {k: launches[k] for k in ("flash_attention",
                                              "linear_scan")}
        if rank == 0:
            worst, at, bad = 0.0, None, []
            for key, want in ref.items():
                a, b = got[key].float(), want.float()
                if not bool(torch.isfinite(a).all()):
                    bad.append(key)
                    continue
                if float(b.norm()) == 0.0:
                    if float(a.norm()) != 0.0:
                        bad.append(key)
                    continue
                e = _rel(a, b)
                if e > worst:
                    worst, at = e, key
                if e > DIST_LOSS_TOL:
                    bad.append(key)
            ok = not bad and set(got) == set(ref)
            log(f"dist layout {name} float32: {len(ref)} tensors sharded vs "
                f"unsharded, worst {at} rel {worst:.3e} (tol "
                f"{DIST_LOSS_TOL:g}; over: {bad}); launches on rank 0 "
                f"{out[name]}; {ms:.0f} ms (host clock, both runs): {ok}")
            if not ok:
                failed.append(f"dist layout {name}: {bad}")
        del params, dp, ref, got
        free_cuda()
    return out


#: the checkpoint case: LAYOUT_CASES' zamba2 train case, saved on (2, 4)
#: after two steps and restored on (4, 2) for the third
CKPT_CASE = ("zamba2_2p7b", (2, 4), (4, 2), 4)
CKPT_PARAM_TOL = 1e-4            # relative, the worst parameter leaf


def _dist_checkpoint(rank: int, failed: list, out_dir: str) -> dict:
    """A sharded train run checkpointed on one mesh and resumed on
    another: zamba2-smoke in f32, two steps on (2, 4), a save (every rank
    gathers its DTensor leaves whole, rank 0 writes), then the third step
    uninterrupted on (2, 4) and, after ``restore(shardings=)`` onto
    (4, 2), again there.  The resumed step's loss within DIST_LOSS_TOL and
    every parameter within CKPT_PARAM_TOL relative of the uninterrupted
    one's.  Returns the resumed step's kernel launches on this rank."""
    from repro_torch.optim.adamw import opt_state_axes
    from repro_torch.train.checkpoint import CheckpointManager
    arch, shape_a, shape_b, B = CKPT_CASE
    cfg = get_smoke_config(arch).scaled(dtype="float32")
    params = _f32(init_params(cfg, torch.Generator(device=DEV).manual_seed(
        SEED), device=DEV))
    axes = params_logical_axes(cfg)
    step = make_train_step(cfg, lr=cosine_schedule(1e-2, warmup=1,
                                                   total=10))
    rng = np.random.default_rng(SEED + 32)
    batches = [_layout_batch(cfg, B, rng) for _ in range(3)]
    t0 = time.monotonic()

    def run(mesh, p, o, b):
        db = {k: sh.distribute(v, mesh, sh.spec_for(
            mesh, ("batch",) + (None,) * (v.dim() - 1), tuple(v.shape)))
            for k, v in b.items()}
        return step(p, o, db)

    mesh_a = make_host_mesh(shape_a, ("data", "model"))
    sh.set_mesh(mesh_a)
    try:
        dp = sh.tree_distribute(mesh_a, params, axes)
        do = adamw_init(dp)
        for b in batches[:2]:
            dp, do, _ = run(mesh_a, dp, do, b)
        mgr = CheckpointManager(os.path.join(out_dir, "ckpt"))
        mgr.save(2, {"params": dp, "opt": do}, extra={"data_step": 2},
                 async_=True)
        dp, do, m = run(mesh_a, dp, do, batches[2])    # uninterrupted
        mgr.wait()
        loss_a = float(sh.full(m["loss"]))
        whole_a = {k: sh.full(v) for k, v in flatten_with_paths(dp)}
        seen = mgr.latest_step()
    finally:
        sh.set_mesh(None)
    del dp, do
    mesh_b = make_host_mesh(shape_b, ("data", "model"))
    sh.set_mesh(mesh_b)
    try:
        tmpl = {"params": params, "opt": adamw_init(params)}
        shardings = sh.tree_shardings(
            mesh_b, {"params": axes, "opt": opt_state_axes(axes)}, tmpl)
        state, meta = mgr.restore(tmpl, shardings=shardings, mesh=mesh_b)
        placed = all(tuple(v.placements) == tuple(want) for (_, v), (_, want)
                     in zip(flatten_with_paths(state),
                            flatten_with_paths(shardings)))
        build.reset_launch_counts()
        dp, _, m = run(mesh_b, state["params"], state["opt"], batches[2])
        launches = {k: build.launch_counts[k]
                    for k in ("flash_attention", "linear_scan")}
        loss_b = float(sh.full(m["loss"]))
        worst, at = max((_rel(sh.full(v).float(), whole_a[k].float()), k)
                        for k, v in flatten_with_paths(dp))
    finally:
        sh.set_mesh(None)
    if rank == 0:
        lrel = abs(loss_b - loss_a) / abs(loss_a)
        ok = (seen == 2 and meta["extra"]["data_step"] == 2 and placed
              and lrel <= DIST_LOSS_TOL and worst <= CKPT_PARAM_TOL)
        log(f"dist checkpoint {cfg.name} train float32: saved on {shape_a} "
            f"after 2 steps, restored on {shape_b} (restore(shardings=), "
            f"every leaf on its placements: {placed}), step 3 loss "
            f"{loss_b:.6f} vs uninterrupted {loss_a:.6f} (rel {lrel:.2e}, "
            f"tol {DIST_LOSS_TOL:g}); parameters worst {at} rel {worst:.3e} "
            f"(tol {CKPT_PARAM_TOL:g}); launches on rank 0 {launches}; "
            f"{1e3 * (time.monotonic() - t0):.0f} ms (host clock): {ok}")
        if not ok:
            failed.append("dist checkpoint")
    del params, state, dp
    free_cuda()
    return launches


def _dist_compression(rank: int, failed: list) -> dict:
    """compressed_psum over the 8 ranks: the reference test's input and
    bounds, and one olmoe layer's gradient size, timed."""
    mesh = make_host_mesh((DIST_RANKS,), ("data",))
    rng = np.random.default_rng(SEED + 21)
    x = torch.from_numpy(rng.standard_normal(4096).astype(np.float32)
                         * 0.01).to(DEV)
    got = compressed_psum(x, mesh, "data")
    exact = x * DIST_RANKS                # replicated input: psum = n x
    rel = float((got - exact).norm() / exact.norm())
    grads, residual = {"w": x}, {"w": torch.zeros_like(x)}
    errs = []
    for _ in range(4):
        mean, residual = compress_with_feedback(grads, residual, mesh, "data")
        errs.append(float((mean["w"] - x).abs().max()))
    layer = olmoe_1b_7b.CONFIG
    n = sum(t.numel() for t in tree_leaves(
        L.abstract(model_mod._layer_specs(layer, layer.groups[0].pattern[0]))))
    g = torch.Generator(device=DEV).manual_seed(SEED + 22)
    big = torch.randn(n, generator=g, device=DEV) * 0.01   # same everywhere
    torch.cuda.synchronize()
    dist.barrier()
    t0 = time.monotonic()
    got_big = compressed_psum(big, mesh, "data")
    torch.cuda.synchronize()
    ms = 1e3 * (time.monotonic() - t0)
    num = den = 0.0
    for a, b in zip(got_big.chunk(16), big.chunk(16)):   # exact = n x
        num += float((a - DIST_RANKS * b).square().sum())
        den += float((DIST_RANKS * b).square().sum())
    big_rel = math.sqrt(num / den)
    ok = rel < COMPRESS_TOL and errs[-1] < FEEDBACK_TOL and \
        big_rel < COMPRESS_TOL
    if rank == 0:
        log(
            f"dist compressed_psum (int8 ring, {DIST_RANKS} ranks): 4096 "
            f"values rel {rel:.4e} (tol {COMPRESS_TOL}); feedback max err "
            f"after 4 rounds {errs[-1]:.4e} (tol {FEEDBACK_TOL}; "
            f"{', '.join(f'{e:.2e}' for e in errs)}); one olmoe layer's "
            f"gradient size ({n} f32 values, the same on every rank) rel {big_rel:.4e} in {ms:.1f} ms "
            f"(host clock, 8 ranks on one card, its hops staged through "
            f"host memory over gloo: not a link's rate): {ok}")
    if not ok:
        failed.append(f"dist compression: {rel}, {errs}, {big_rel}")
    del big, got_big
    free_cuda()
    return {"compress_ms": ms, "n": n}


def _dist_pipeline(rank: int, failed: list) -> dict:
    """pipeline_forward: 4 stages x 2 replicas at d = 4096, 8 microbatches
    of 4, f32, against the sequential run on every rank."""
    d, n_stages, n_micro, mb = 4096, 4, 8, 4
    mesh = make_host_mesh((2, n_stages), ("replica", "stage"))
    rng = np.random.default_rng(SEED + 23)
    s = 1.0 / np.sqrt(d)
    p = {k: torch.from_numpy((rng.standard_normal((n_stages, d, d)) * s)
                             .astype(np.float32)).to(DEV)
         for k in ("w1", "w2")}
    x = torch.from_numpy(rng.standard_normal((n_micro, mb, d))
                         .astype(np.float32)).to(DEV)
    stage_fn, _ = make_mlp_stage(d)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    y = pipeline_forward(stage_fn, p, x, mesh=mesh)
    torch.cuda.synchronize()
    ms = 1e3 * (time.monotonic() - t0)
    want = x
    for st in range(n_stages):
        want = stage_fn({k: v[st] for k, v in p.items()}, want)
    err = float((y - want).abs().max())
    ok = err <= PIPE_ATOL
    if rank == 0:
        log(
            f"dist pipeline_forward: {n_stages} stages x 2 replicas, d={d}, "
            f"{n_micro} microbatches of {mb}, f32: max |err| vs sequential "
            f"{err:.3e} (atol {PIPE_ATOL:g}) in {ms:.1f} ms (host clock): "
            f"{ok}")
    if not ok:
        failed.append(f"dist pipeline: {err}")
    return {"pipeline_ms": ms}


#: the sharded loss's check: f32 logits (B, S) rows over gemma2's vocab,
#: on LOSS_MESH; value and gradient against the unsharded loss, relative
LOSS_SHAPE = (4, 128, 256000)
LOSS_MESH = (2, 4)
LOSS_TOL = 1e-5


def _dist_loss(rank: int, failed: list) -> dict:
    """``cross_entropy`` on logits laid out as the train step's (the batch
    over ``data``, the vocab over ``model``) against the unsharded loss on
    the same f32 logits (rank 0), value and gradient within LOSS_TOL, and
    the sharded call's collectives as ``roofline/op_stats.py`` counts
    them: rows of (B_local, S) f32, never the vocab-wide logits."""
    from repro_torch.roofline.op_stats import OpStats
    from repro_torch.train.train_step import cross_entropy
    B, S, V = LOSS_SHAPE
    g = torch.Generator(device=DEV).manual_seed(SEED)
    logits = 4.0 * torch.randn(B, S, V, generator=g, device=DEV)
    targets = torch.randint(0, V, (B, S), generator=g, device=DEV)
    mesh = make_host_mesh(LOSS_MESH, ("data", "model"))
    sh.set_mesh(mesh)
    try:
        dl = sh.distribute(logits, mesh, sh.spec_for(
            mesh, ("batch", None, "vocab"), tuple(logits.shape)))
        dl = dl.detach().requires_grad_(True)
        dt = sh.distribute(targets, mesh, sh.batch_spec(mesh))
        t0 = time.monotonic()
        with OpStats() as st:
            loss = cross_entropy(dl, dt)
            loss.backward()
        torch.cuda.synchronize()
        ms = 1e3 * (time.monotonic() - t0)
        got, grad = float(sh.full(loss.detach())), sh.full(dl.grad)
        placements = str(dl.grad.placements)
    finally:
        sh.set_mesh(None)
    out = {"collective_bytes": st.coll.wire_bytes,
           "payloads": sorted({str(t["shape"]) for t in
                               st.top_collectives()})}
    if rank == 0:
        lu = logits.clone().requires_grad_(True)
        want = cross_entropy(lu, targets)
        want.backward()
        e_loss = abs(got - float(want)) / abs(float(want))
        e_grad = _rel(grad, lu.grad)
        most = max(math.prod(t["shape"]) * 4 for t in st.top_collectives())
        ok = (e_loss <= LOSS_TOL and e_grad <= LOSS_TOL
              and most < B * S * 4 and math.isfinite(got))
        log(f"dist loss float32 {LOSS_MESH} logits {LOSS_SHAPE}: sharded "
            f"{got:.6f} vs unsharded {float(want):.6f} (rel {e_loss:.2e}), "
            f"gradient rel {e_grad:.2e} (tol {LOSS_TOL:g}), laid out "
            f"{placements}; collectives on rank 0 (OpStats) "
            f"{st.coll.wire_bytes:.0f} wire bytes, payloads {out['payloads']}"
            f" (the largest {most} bytes; the logits {B * S * V * 4}); "
            f"{ms:.0f} ms (host clock): {ok}")
        if not ok:
            failed.append("dist loss")
    del logits, dl, grad
    free_cuda()
    return out


#: the sharded step's memory count held to the card: starcoder2-7b cut
#: to 2 layers at full width, value_and_grad on LOSS_MESH, one sequence of
#: DIST_MEM_SEQ tokens a data rank
DIST_MEM_LAYERS, DIST_MEM_SEQ = 2, 1024
MEM_TOL = 0.15                   # relative, the allocator's peak vs the count


def _dist_memory(rank: int, failed: list) -> dict:
    """One rank of a sharded bf16 ``value_and_grad`` of starcoder2-7b cut
    to DIST_MEM_LAYERS layers (full width and vocab) on LOSS_MESH: the card
    allocator's peak over the call (``max_memory_allocated`` less what was
    allocated before it) against ``roofline/op_stats.py``'s live-bytes
    peak for the same call, within MEM_TOL.  FSDP gathers each weight over
    ``data`` and the embedding's gradient is reduce-scattered, so the
    outputs of collectives are part of what a rank holds at its peak.
    The reduce-scatters are staged through host memory here: run by gloo
    on the card's tensors, a call of gemma2-27b's cut read 2359298032
    bytes over the count, one reduce-scatter input's bytes (the
    2359296000-byte embedding gradient), a buffer of gloo's that NCCL's
    reduce-scatter does not allocate and the counter cannot see.  The
    last dist check: the staging stays for the rest of the rank."""
    from repro_torch.roofline.op_stats import OpStats
    collectives.stage_through_host(("reduce_scatter_tensor",))
    full = starcoder2_7b.CONFIG
    cfg = full.scaled(groups=(dataclasses.replace(
        full.groups[0], repeats=DIST_MEM_LAYERS),))
    mesh = make_host_mesh(LOSS_MESH, ("data", "model"))
    for r in range(DIST_RANKS):     # one rank's whole weights at a time
        if r == rank:
            params = init_params(cfg, torch.Generator(
                device=DEV).manual_seed(SEED), device=DEV)
            dp = sh.tree_distribute(mesh, params, params_logical_axes(cfg))
            del params
            free_cuda()
        dist.barrier()
    toks = torch.randint(0, cfg.vocab, (LOSS_MESH[0], DIST_MEM_SEQ),
                         generator=torch.Generator().manual_seed(SEED))
    sh.set_mesh(mesh)
    try:
        db = {k: sh.distribute(v.to(DEV), mesh, sh.batch_spec(mesh))
              for k, v in (("tokens", toks),
                           ("targets", torch.roll(toks, -1, 1)))}
        free_cuda()
        torch.cuda.synchronize()
        dist.barrier()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        t0 = time.monotonic()
        with OpStats() as st:
            (loss, _), grads = value_and_grad(dp, db, cfg)
        torch.cuda.synchronize()
        used = torch.cuda.max_memory_allocated() - before
        ms = 1e3 * (time.monotonic() - t0)
        loss = float(sh.full(loss))
    finally:
        sh.set_mesh(None)
    counted, coll = st.peak_bytes, st.peak_collective_bytes
    ratio = used / counted
    ok = abs(ratio - 1) <= MEM_TOL and math.isfinite(loss)
    if rank == 0:
        top = "; ".join(f"{t['source']} {t['pass']} {t['dtype']} "
                        f"{t['bytes'] / 2**30:.2f} GiB ({t['share']:.2f})"
                        for t in st.top_live(3))
        log(f"dist memory {cfg.name} {cfg.n_layers} layers value_and_grad "
            f"bf16 {LOSS_MESH} B={LOSS_MESH[0]} S={DIST_MEM_SEQ} "
            f"V={cfg.vocab}, rank 0: the card's allocator peak over the call {used} bytes "
            f"({used / 2**30:.2f} GiB) vs OpStats' count {counted} bytes "
            f"({counted / 2**30:.2f} GiB, of which outputs of collectives "
            f"{coll} bytes): ratio {ratio:.4f} (tol {MEM_TOL:g}); "
            f"collective wire bytes {st.coll.wire_bytes:.0f}; top_live "
            f"{top}; loss {loss:.4f}; {ms:.0f} ms (host clock, under the "
            f"counter): {ok}")
    if not ok:
        failed.append(f"dist memory: ratio {ratio:.4f}, loss {loss}")
    del grads
    free_cuda()
    prefill = _dist_memory_prefill(rank, failed, cfg, mesh, dp, db["tokens"])
    del dp, db
    free_cuda()
    return {"used": used, "counted": counted, "ratio": ratio,
            "collective": coll, "prefill": prefill}


def _lookup_lines() -> set:
    """The source lines of the embedding's lookup and of its gather, as
    ``OpStats`` names a source."""
    import inspect
    lines = set()
    for fn in (L.embed_lookup, sh._Gather, sh.gather_chunks):
        src, first = inspect.getsourcelines(fn)
        path = inspect.getsourcefile(fn).split("src/")[-1]
        lines.update(f"{path}:{n}" for n in range(first, first + len(src)))
    return lines


def _dist_memory_prefill(rank: int, failed: list, cfg, mesh, dp,
                         tokens) -> dict:
    """The same rank's sharded prefill of the same cut and batch, without
    a gradient (``make_prefill_step``: the last logits, and the cache laid
    out as decode reads it): the card allocator's peak over the call
    against ``OpStats``' count for it, within MEM_TOL, the logits finite.
    The embedding's lookup gathers the rank's vocab slice over ``data``
    and looks up its own batch's tokens there: what its lines hold at the
    count's peak, and the counted peak of the lookup alone (the
    allocator's within MEM_TOL of it), at most that slice (the vocab over
    ``model``), the rank's output rows and its tokens' indices, where it
    gathered the whole table before; its rows, summed over the ranks,
    bit-equal to ``F.embedding`` on the whole table."""
    from repro_torch.roofline.op_stats import OpStats
    lines = _lookup_lines()
    table = dp["embed"]
    vocab_ranks = LOSS_MESH[1]
    n_tok = tokens.to_local().numel()
    # the slice, the output rows, and the tokens' int64 indices (one into
    # each of the data ranks' embed chunks) and mask
    limit = (cfg.vocab // vocab_ranks + n_tok) * cfg.d_model \
        * table.element_size() + (8 * LOSS_MESH[0] + 1) * n_tok
    sh.set_mesh(mesh)
    try:
        free_cuda()
        torch.cuda.synchronize()
        dist.barrier()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        t0 = time.monotonic()
        with torch.no_grad(), OpStats() as st:
            logits, cache = make_prefill_step(cfg)(dp, tokens)
        torch.cuda.synchronize()
        used = torch.cuda.max_memory_allocated() - before
        ms = 1e3 * (time.monotonic() - t0)
        finite = bool(torch.isfinite(logits.to_local()).all())
        shape = tuple(logits.shape)
        del logits, cache
        free_cuda()
        torch.cuda.synchronize()
        dist.barrier()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        with torch.no_grad(), OpStats() as lk:
            rows = L.embed_lookup(table, tokens)
        torch.cuda.synchronize()
        lk_used = torch.cuda.max_memory_allocated() - before
        with torch.no_grad():
            got = sh.full(rows)
            whole = sh.full(table)
            want = F.embedding(sh.full(tokens).long(), whole)
        equal = bool(torch.equal(got, want))
        del rows, got, whole, want
    finally:
        sh.set_mesh(None)
    counted = st.peak_bytes
    ratio = used / counted
    held = sum(t["bytes"] for t in st.top_live() if t["source"] in lines)
    moved = max((math.prod(t["shape"]) * table.element_size()
                 for t in lk.top_collectives()), default=0)
    ok = (abs(ratio - 1) <= MEM_TOL and finite
          and shape == (LOSS_MESH[0], cfg.vocab)
          and held <= limit and lk.peak_bytes <= limit and moved <= limit
          and abs(lk_used / lk.peak_bytes - 1) <= MEM_TOL and equal)
    if rank == 0:
        top = "; ".join(f"{t['source']} {t['pass']} {t['dtype']} "
                        f"{t['bytes'] / 2**30:.2f} GiB ({t['share']:.2f})"
                        for t in st.top_live(3))
        log(f"dist memory {cfg.name} {cfg.n_layers} layers prefill (no "
            f"gradient) bf16 {LOSS_MESH} B={LOSS_MESH[0]} S={DIST_MEM_SEQ} "
            f"V={cfg.vocab}, rank 0: the card's allocator peak over the "
            f"call {used} bytes ({used / 2**30:.2f} GiB) vs OpStats' count "
            f"{counted} bytes (of which outputs of collectives "
            f"{st.peak_collective_bytes} bytes): ratio {ratio:.4f} (tol "
            f"{MEM_TOL:g}); top_live {top}; the lookup's lines at the peak "
            f"{held} bytes, the lookup alone: counted {lk.peak_bytes}, "
            f"allocator {lk_used}, its largest collective {moved} bytes "
            f"(limit: the rank's vocab slice, output rows and indices "
            f"{limit}; the "
            f"whole table {cfg.vocab * cfg.d_model * table.element_size()}"
            f"); its rows bit-equal to F.embedding on the whole table "
            f"{equal}; logits {shape} finite {finite}; {ms:.0f} ms (host "
            f"clock, under the counter): {ok}")
    if not ok:
        failed.append(f"dist memory prefill: ratio {ratio:.4f}, lookup "
                      f"{held} / {lk.peak_bytes} / {lk_used} / {moved} "
                      f"bytes (limit {limit}), equal {equal}, finite "
                      f"{finite}")
    return {"used": used, "counted": counted, "ratio": ratio,
            "lookup": lk.peak_bytes, "lookup_used": lk_used}


def _dist_rank(rank: int, world: int, init: str, out_dir: str) -> None:
    """One rank of the dist phase (a process of its own, all on cuda:0).
    Rank 0 prints the comparisons as they finish; every check runs, and a
    failed one raises at the end.  Writes the rank's results to
    ``out_dir/rank<r>.json``."""
    # 8 ranks share the card's 80 GB: segments that grow in place keep a
    # rank's cache from fragmenting (set before its first allocation)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    collectives.stage_through_host(GLOO_STAGED)
    collectives.init("gloo", rank, world, init)
    failed: list = []          # every check runs; a failure raises at the end
    res: dict = {}
    try:
        res["olmoe"] = _dist_olmoe(rank, failed)
        res["olmoe_decode"] = _dist_olmoe_decode(rank, failed)
        res["layouts"] = _dist_layouts(rank, failed)
        res["checkpoint"] = _dist_checkpoint(rank, failed, out_dir)
        res["cp"] = _dist_cp(rank, failed)
        res["compression"] = _dist_compression(rank, failed)
        res["pipeline"] = _dist_pipeline(rank, failed)
        res["loss"] = _dist_loss(rank, failed)
        res["memory"] = _dist_memory(rank, failed)
        res["staged"] = dict(collectives.staged)
        res["staged_bytes"] = dict(collectives.staged_bytes)
        Path(out_dir, f"rank{rank}.json").write_text(json.dumps(res))
        dist.barrier()
    finally:
        dist.destroy_process_group()
    if failed:
        raise AssertionError(f"rank {rank}: {failed}")


def _start_dryruns(out_dir: str):
    """The dry-run's cells, each ``python -m repro_torch.launch.dryrun`` in
    a process of its own (the ``fake`` group, meta tensors: the host's
    CPU, beside the ranks)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = []
    for arch, shape, multi in DRYRUN_CELLS:
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape, "--out", out_dir] + (
            ["--multi-pod"] if multi else [])
        procs.append((arch, shape, multi, subprocess.Popen(
            cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    return procs


def _finish_dryruns(procs, out_dir: str, deadline: float) -> None:
    for arch, shape, multi, p in procs:
        try:
            text, _ = p.communicate(timeout=max(1.0, deadline
                                                - time.monotonic()))
        except subprocess.TimeoutExpired:
            for *_, q in procs:
                q.kill()
                q.wait()
            raise
        said = [ln for ln in text.splitlines() if ln.startswith("[dryrun]")]
        name = f"{arch}_{shape}{'_mp' if multi else ''}.json"
        cell = json.loads(Path(out_dir, name).read_text())
        if (arch, shape, multi) not in REF_DRYRUN_FLOPS:
            # a skip in the reference's dry-run: a skip here too
            ok = p.returncode == 0 and any("SKIP" in ln for ln in said)
            log(f"dryrun {arch} x {shape}: {said[0] if said else text[-300:]}"
                f": {ok}")
        else:
            r = cell.get("roofline", {})
            flops = r.get("flops_per_device", 0)
            want = REF_DRYRUN_FLOPS[(arch, shape, multi)]
            coll = r.get("collective_bytes_per_device", 0)
            want_coll = REF_DRYRUN_COLLECTIVE[(arch, shape, multi)]
            ranks = "; ".join(f"rank {k} {v['flops']:.4e}" for k, v in
                              cell.get("ranks", {}).items())
            mem = cell.get("memory", {}).get("per_device_total_gib", 0)
            want_mem = REF_DRYRUN_MEMORY.get((arch, shape, multi))
            ok = (p.returncode == 0 and cell.get("status") == "ok"
                  and cell.get("n_devices") == (512 if multi else 256)
                  and abs(sum(t["share"] for t in cell["top_collectives"])
                          - 1) < 1e-9
                  and r.get("flops_per_device", 0) > 0 and r.get("bottleneck")
                  in ("compute", "memory", "collective")
                  and (shape != "long_500k"
                       or coll <= DRYRUN_LONG_LIMIT * want_coll)
                  and (want_mem is None or (
                      mem <= DRYRUN_PREFILL_LIMIT * want_mem
                      and flops <= DRYRUN_PREFILL_LIMIT * want
                      and coll <= DRYRUN_PREFILL_LIMIT * want_coll)))
            held = "" if want_mem is None else (
                f" (the reference's {want_mem} GiB: {mem / want_mem:.3f}x, "
                f"limit {DRYRUN_PREFILL_LIMIT:g}x for memory, FLOPs and "
                f"collectives); live at the peak: " + "; ".join(
                    f"{t['source']} {t['pass']} {t['dtype']} {t['bytes']} "
                    f"bytes ({t['share']:.2f})" for t in cell["top_live"][:3]))
            log(f"dryrun {arch} x {shape} ({'multi' if multi else 'single'}"
                f"-pod, {cell.get('n_devices')} devices): {said[0] if said else ''}"
                f"; per device {flops:.4e} FLOPs, the busiest of ({ranks}) "
                f"(the reference's dry-run {want:.4e}, a CPU count: "
                f"{flops / want:.3f}x), "
                f"{r.get('hbm_bytes_per_device', 0):.4e} bytes, collectives "
                f"{coll:.4e} bytes (the reference's {want_coll:.4e}: "
                f"{coll / want_coll:.3f}x) "
                f"{ {k: f'{v:.3e}' for k, v in r.get('collective_by_kind', {}).items()} }; "
                f"step >= {1e3 * r.get('step_time_lower_bound_s', 0):.3f} ms "
                f"({r.get('bottleneck')}; H100 data-sheet bounds, not "
                f"measured); memory {mem} GiB a device{held}: {ok}")
        if not ok:
            raise AssertionError(f"dryrun {arch} x {shape}: {text[-2000:]} "
                                 f"{cell.get('trace', '')}")


def phase_dist(card: str, dry=None) -> int:
    """The distribution slice on the card: 8 ranks (processes) on one
    H100 over gloo; the kernels were built by this process before.
    ``dry``: the dry-run cells' processes and their output directory, if
    started earlier (on the host's CPU, while the card trains, so they
    take no CPU from the ranks).  Returns the kernel launches of the
    ranks' main paths (the CP prefills and train step, the layouts' train
    steps and prefill), summed over the ranks."""
    t0 = time.monotonic()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dist_")
    dry, dry_dir = dry or (_start_dryruns(tmp), tmp)
    try:
        try:
            collectives.spawn_ranks(_dist_rank, DIST_RANKS, (tmp,),
                                    DIST_TIMEOUT_S, init_dir=tmp)
        except BaseException:
            for *_, p in dry:
                p.kill()
                p.wait()
            raise
        ranks = [json.loads(Path(tmp, f"rank{r}.json").read_text())
                 for r in range(DIST_RANKS)]
        steps = [ms for r in ranks for ms in r["olmoe"]["steps_ms"]]
        log(f"dist olmoe EP bf16 train steps (own capacity and aux): losses "
            f"{ranks[0]['olmoe']['losses']}; step {min(steps):.0f}-"
            f"{max(steps):.0f} ms over ranks and steps (8 ranks sharing one "
            f"card: not a multi-GPU step time); peak memory a rank "
            f"{min(r['olmoe']['peak_gib'] for r in ranks):.2f}-"
            f"{max(r['olmoe']['peak_gib'] for r in ranks):.2f} GiB; {card}")
        ratios = [r["memory"]["ratio"] for r in ranks]
        pre = [r["memory"]["prefill"] for r in ranks]
        log(f"dist memory prefill: the allocator's peak over OpStats' count "
            f"a rank {min(p['ratio'] for p in pre):.4f}-"
            f"{max(p['ratio'] for p in pre):.4f} (tol {MEM_TOL:g}), peaks "
            f"{min(p['used'] for p in pre)}-{max(p['used'] for p in pre)} "
            f"bytes; the lookup alone {min(p['lookup_used'] for p in pre)}-"
            f"{max(p['lookup_used'] for p in pre)} bytes on the allocator; "
            f"{card}")
        log(f"dist memory: the allocator's peak over OpStats' count a rank "
            f"{min(ratios):.4f}-{max(ratios):.4f} (tol {MEM_TOL:g}), peaks "
            f"{min(r['memory']['used'] for r in ranks) / 2**30:.2f}-"
            f"{max(r['memory']['used'] for r in ranks) / 2**30:.2f} GiB, "
            f"outputs of collectives in the count's peak "
            f"{min(r['memory']['collective'] for r in ranks) / 2**30:.2f}-"
            f"{max(r['memory']['collective'] for r in ranks) / 2**30:.2f} "
            f"GiB; {card}")
        flash = {k: [r["cp"]["flash"][k] for r in ranks]
                 for k in ("bfloat16", "float32", "train")}
        log(f"dist starcoder2 CP flash launches per rank: "
            + "; ".join(f"{k} {v} (sum {sum(v)})" for k, v in flash.items()))
        staged = {k: sum(r["staged"].get(k, 0) for r in ranks)
                  for k in GLOO_STAGED}
        staged_b = {k: sum(r["staged_bytes"].get(k, 0) for r in ranks)
                    for k in GLOO_STAGED}
        log(f"dist collectives staged through host memory (gloo has no CUDA "
            f"path for them here), calls over all ranks {staged}, bytes "
            f"{staged_b}; gloo ran every other collective on the card's "
            f"tensors itself")
        if any(n == 0 for n in flash["bfloat16"] + flash["train"]):
            raise AssertionError(f"dist: a CP rank launched no flash {flash}")
        layouts = {name: {k: [r["layouts"][name][k] for r in ranks]
                          for k in ("flash_attention", "linear_scan")}
                   for name in ranks[0]["layouts"]}
        log("dist layout launches per rank: " + "; ".join(
            f"{name} " + ", ".join(f"{k} {v}" for k, v in got.items()
                                   if any(v))
            for name, got in layouts.items()))
        launched = {k: sum(sum(got[k]) for got in layouts.values())
                    + sum(r["checkpoint"][k] for r in ranks)
                    for k in ("flash_attention", "linear_scan")}
        for name, want in (("llama-vision-smoke train (2, 4) B=4",
                            "flash_attention"),
                           ("zamba2-smoke train (2, 4) B=4", "linear_scan")):
            if any(n == 0 for n in layouts[name][want]):
                raise AssertionError(f"dist: a rank of {name} launched no "
                                     f"{want}: {layouts[name]}")
        _finish_dryruns(dry, dry_dir, time.monotonic() + DRYRUN_TIMEOUT_S)
        log(f"time: dist phase {time.monotonic() - t0:.1f} s")
        launched["flash_attention"] += sum(flash["bfloat16"]) + sum(
            flash["train"])
        return launched
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


#: the dry-run's memory count held to the card's allocator: gemma2-27b at
#: full width and vocab cut to one pattern repeat (a local and a global
#: layer), one bf16 train step, unsharded
MEM_BATCH, MEM_SEQ = 1, 4096
#: and a prefill of the same cut at a length whose norms run 4 row chunks
#: a call (``models/layers.py::NORM_CHUNK_ROWS``), its peak held to the
#: count within MEM_PREFILL_RATIO (the allocator rounds up, never down)
MEM_PREFILL_BATCH, MEM_PREFILL_SEQ = 1, 32768
MEM_PREFILL_RATIO = (1.0, 1.05)


def phase_dryrun_memory(card: str) -> int:
    """``roofline/op_stats.py``'s live-bytes peak on the ``meta`` device
    (what the dry-run's ``temp_bytes`` counts) against the card's
    allocator for the same call: ``max_memory_allocated()`` less the bytes
    allocated before it (parameters, moments, batch).  Three calls:
    ``value_and_grad`` alone, whose peak the model and the loss make (the
    f32 logits and their gradient, the kernels' VJPs); the train step,
    whose peak AdamW's f32 temporaries make; and the prefill step at
    MEM_PREFILL_SEQ tokens, without a gradient (rms_norm a row chunk at a
    time, the residual sums in place).  Then rms_norm at the prefill's
    size in chunks against one pass on the card.  Returns the flash
    launches."""
    from repro_torch.configs import gemma2_27b
    from repro_torch.configs.base import Group
    from repro_torch.models.model import abstract_params
    from repro_torch.roofline.op_stats import OpStats
    t0 = time.monotonic()
    full = gemma2_27b.CONFIG
    cfg = full.scaled(groups=(Group(1, full.groups[0].pattern),))
    toks = torch.randint(0, cfg.vocab, (MEM_BATCH, MEM_SEQ),
                         generator=torch.Generator().manual_seed(SEED))

    ptoks = torch.randint(0, cfg.vocab, (MEM_PREFILL_BATCH, MEM_PREFILL_SEQ),
                          generator=torch.Generator().manual_seed(SEED + 1))

    def batch(dev):
        t = toks.to(dev)
        return {"tokens": t, "targets": torch.roll(t, -1, 1),
                "prefill": ptoks.to(dev)}

    prefill = make_prefill_step(cfg)

    def prefill_call(p, o, b):
        with torch.no_grad():
            return prefill(p, b["prefill"])

    calls = {"value_and_grad": lambda p, o, b: value_and_grad(p, b, cfg),
             "train step": make_train_step(cfg), "prefill": prefill_call}
    params = abstract_params(cfg)
    opt = adamw_init(params)
    counts = {}
    mb = batch("meta")          # made before the count, as on the card
    for name, fn in calls.items():
        with OpStats() as st:
            fn(params, opt, mb)
        counts[name] = st
    del params, opt
    params = _model(cfg, f"cut: 1 of {full.groups[0].repeats} pattern "
                    f"repeats (a local and a global layer), full width and "
                    f"vocab; train B={MEM_BATCH} S={MEM_SEQ}")
    opt = adamw_init(params)
    b = batch(DEV)
    build.reset_launch_counts()
    bad = []
    for name, fn in calls.items():
        free_cuda()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        out = fn(params, opt, b)
        if name == "prefill":      # the last position's logits, finite
            loss = float(out[0].float().abs().amax())
        else:
            loss = float(out[0][0] if name == "value_and_grad"
                         else out[2]["loss"])
        torch.cuda.synchronize()
        used = torch.cuda.max_memory_allocated() - before
        if name == "train step":
            params, opt = out[0], out[1]
        del out
        st = counts[name]
        ratio = used / st.peak_bytes
        if name == "prefill":
            lo, hi = MEM_PREFILL_RATIO
            ok, tol = lo <= ratio <= hi, f"{lo:g}-{hi:g}x"
            B, S = MEM_PREFILL_BATCH, MEM_PREFILL_SEQ
        else:
            ok, tol = abs(ratio - 1) <= MEM_TOL, f"tol {MEM_TOL:g}"
            B, S = MEM_BATCH, MEM_SEQ
        ok = ok and math.isfinite(loss)
        top = "; ".join(f"{t['source']} {t['pass']} {t['dtype']} "
                        f"{t['bytes'] / 2**30:.2f} GiB ({t['share']:.2f})"
                        for t in st.top_live(3))
        log(f"dryrun memory {cfg.name} 2 layers {name} bf16 B={B} "
            f"S={S} V={cfg.vocab}: the card's allocator peak over the "
            f"call {used} bytes ({used / 2**30:.2f} GiB) vs OpStats' count "
            f"on meta {st.peak_bytes} bytes ({st.peak_bytes / 2**30:.2f} "
            f"GiB): ratio {ratio:.4f} ({tol}); top_live {top}; "
            f"{'max |logit|' if name == 'prefill' else 'loss'} {loss:.4f}; "
            f"{card}: {ok}")
        if not ok:
            bad.append(name)
    flash = build.launch_counts.get("flash_attention", 0)
    del params, opt, b
    free_cuda()
    norm_ok = _norm_chunks_on_card(cfg, card)
    log(f"dryrun memory: flash launches {flash}; "
        f"{time.monotonic() - t0:.1f} s")
    if not norm_ok:
        bad.append("rms_norm chunks")
    if bad or flash == 0:
        raise AssertionError(f"dryrun memory: the count and the card differ "
                             f"({bad}) or no flash launch ({flash})")
    return flash


def _norm_chunks_on_card(cfg, card: str) -> bool:
    """rms_norm without a gradient on the card in bf16 at the prefill
    call's size, in row chunks (``NORM_CHUNK_ROWS``) against one pass (the
    same function with the chunk above the row count): the largest
    difference, and whether the two are bit-equal (the card's reduction
    over a row may depend on how many rows a launch takes).  Fails beyond
    the bf16 tolerance of the port's tests (2e-2)."""
    g = torch.Generator(device=DEV).manual_seed(SEED)
    shape = (MEM_PREFILL_BATCH, MEM_PREFILL_SEQ, cfg.d_model)
    x = torch.randn(shape, generator=g, device=DEV).to(torch.bfloat16)
    s = (0.1 * torch.randn(cfg.d_model, generator=g, device=DEV)).to(
        torch.bfloat16)
    rows = x.numel() // cfg.d_model
    chunk = L.NORM_CHUNK_ROWS
    with torch.no_grad():
        chunked = L.rms_norm(x, s, cfg.norm_eps)
        try:
            L.NORM_CHUNK_ROWS = rows + 1
            one = L.rms_norm(x, s, cfg.norm_eps)
        finally:
            L.NORM_CHUNK_ROWS = chunk
    torch.cuda.synchronize()
    err = float((chunked.float() - one.float()).abs().max())
    equal = bool(torch.equal(chunked, one))
    ok = err <= 2e-2 and bool(torch.isfinite(chunked.float()).all())
    log(f"dryrun memory rms_norm bf16 {tuple(shape)}: {-(-rows // chunk)} "
        f"chunks of {chunk} rows vs one pass: max abs diff {err:.6g}, "
        f"bit-equal {equal}; {card}: {ok}")
    del x, chunked, one
    free_cuda()
    return ok


# ----------------------------------------------------------------------------


def _model(cfg, note: str):
    log(f"model: {cfg.name} layers={cfg.n_layers} d_model={cfg.d_model} "
        f"heads={cfg.n_heads}/{cfg.n_kv_heads} d_ff={cfg.d_ff} "
        f"vocab={cfg.vocab} dtype={cfg.dtype} ({note})")
    t0 = time.monotonic()
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    params = init_params(cfg, gen, device=DEV)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    log(f"weights: {n_params} random bf16 parameters in "
        f"{time.monotonic() - t0:.1f} s")
    return params


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--smr-run"]:
        return smr_run_main(sys.argv[2:])
    if sys.argv[1:2] == ["--structures"]:
        phase_structures()      # the process start_structures starts
        return 0
    if sys.argv[1:2] == ["--kernels"]:
        # the card, build and kernel phases alone, for iterating on a
        # kernel (prints no result)
        phase_card()
        phase_build()
        phase_kernels()
        return 0
    if sys.argv[1:2] == ["--dist"]:
        # the dist phase alone, for iterating on it (prints no result)
        card = phase_card()
        phase_build()
        launches = phase_dist(card)
        launches["flash_attention"] += phase_dryrun_memory(card)
        log(f"dist alone: launches {launches}; {card}")
        return 0
    if sys.argv[1:2] == ["--runtime"]:
        # the runtime runs alone (d, a-c, e, f, and g after a short tiny
        # trainer), for iterating on them (prints no result)
        card = phase_card()
        phase_build()
        cfg = starcoder2_7b.CONFIG
        params = _model(cfg, "no depth cut")
        launches = phase_stalled_reader(cfg, params, card)
        del params
        free_cuda()
        cut = cfg.scaled(groups=dense_stack(RUNTIME_LAYERS), dtype="float32")
        params = _model(cut, f"cut: {RUNTIME_LAYERS} of 32 layers")
        for name, n in phase_runtime(cut, params, card).items():
            launches[name] += n
        del params
        free_cuda()
        tmp = tempfile.mkdtemp(prefix="chip_smoke_runtime_")
        try:
            out = _train_tiny(card, tmp)
            for name, n in _runtime_system(card, out, f"{tmp}/tiny").items():
                launches[name] += n
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        log(f"runtime alone: launches {launches}; {card}")
        return 0
    t0 = time.monotonic()

    def done(phases: str) -> None:
        log(f"time: {phases} done at {time.monotonic() - t0:.1f} s")

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
    done("card, build, kernels, structures")

    cfg = starcoder2_7b.CONFIG
    params = _model(cfg, "no depth cut")
    launches = phase_serve(cfg, params, card)
    for name, n in phase_stalled_reader(cfg, params, card).items():
        launches[name] += n
    del params                 # the smr serve processes make their own
    free_cuda()
    done("serve, runtime d")
    cut = cfg.scaled(groups=dense_stack(RUNTIME_LAYERS), dtype="float32")
    params = _model(cut, f"cut: {RUNTIME_LAYERS} of 32 layers, full width; "
                    f"float32 compute: the runtime runs' token comparisons")
    for name, n in phase_runtime(cut, params, card).items():
        launches[name] += n
    del params
    free_cuda()
    done("runtime")
    phase_smr_serve()
    done("smr serve")
    params = _model(cfg, "no depth cut, the same seed")
    phase_fleet_replay(cfg, params, card)
    phase_profile(cfg, params)
    phase_slice(cfg, params)
    # the standalone scatter's path: the full-sequence prefill's write
    for name, n in phase_prefill_kv(cfg, params).items():
        launches[name] += n
    del params
    free_cuda()
    done("fleet replay, profile, slice, prefill_kv")

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
    done("dense (zamba2, rwkv6)")

    phase_olmoe(card)
    done("olmoe")
    # this slice's path runs flash at the MLA, encoder and cross attention
    # shapes: its line reads at MLA's, with the launches of the three
    # models' prefills
    flash_times = kres[("flash_attention", torch.bfloat16)][1]
    launches["flash_attention"] = phase_deepseek(card, flash_times)
    done("mla (deepseek)")
    launches["flash_attention"] += phase_cross(card, flash_times)
    done("cross (llama-vision, whisper)")
    dry_dir = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
    dry = _start_dryruns(dry_dir)          # host CPU, beside the train phase
    try:
        for name, n in phase_train(card).items():
            launches[name] += n
        done("train")
        # the dist phase's paths: the ranks' context-parallel flash
        # launches and the sharded layouts' flash and scan launches
        for name, n in phase_dist(card, (dry, dry_dir)).items():
            launches[name] += n
        launches["flash_attention"] += phase_dryrun_memory(card)
        done("dist, dryrun memory")
    except BaseException:
        for *_, p in dry:
            p.kill()
            p.wait()
        raise
    finally:
        shutil.rmtree(dry_dir, ignore_errors=True)

    kernels = []
    for name in REPLACES:
        err_f32, t_f32 = kres[(name, torch.float32)]
        err_bf16, t_bf16 = kres[(name, torch.bfloat16)]
        if name == "paged_attention":
            ms, plain, bound, by, _ = t_bf16["decode"]
            lib = None
        elif name == "paged_attention+write":
            ms, plain, bound, by = t_bf16["decode"][:4]
            lib = None
        elif name == "paged_scatter":
            ms, plain, bound, lib, _ = t_bf16
            by = "bytes"
        elif name == "flash_attention":
            ms, plain, bound, by, lib = t_bf16["deepseek MLA"]
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


if __name__ == "__main__":
    sys.exit(main())
