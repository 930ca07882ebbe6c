"""GPipe-style pipeline parallelism over point-to-point transfers (the
reference's ``parallel/pipeline.py``, ``shard_map`` + ``ppermute``).

The production grid uses DP x TP (x EP).  PP is provided for models
deeper than one device's memory: layers are stacked per stage, each stage
a rank of the mesh's ``stage`` axis, microbatches stream through the
stages with one activation hop per slot, and the schedule is the standard
(S + M - 1)-slot GPipe loop.  Ranks of the other mesh axes (replicas) run
pipelines of their own.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.models.layers import activation
from repro_torch.parallel.collectives import exchange


def _stage_slice(params, idx: int):
    if isinstance(params, dict):
        return {k: _stage_slice(v, idx) for k, v in params.items()}
    return params[idx]


def pipeline_forward(
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    stage_params: Any,           # leaves with leading [n_stages] dim
    x: torch.Tensor,             # (n_micro, micro_batch, ...)
    *,
    mesh,
    stage_axis: str = "stage",
) -> torch.Tensor:
    """Runs x through n_stages sequential stages, microbatch-pipelined.
    Every rank passes the same ``stage_params`` (all stages) and ``x`` (all
    microbatches); rank ``i`` of ``stage_axis`` runs stage ``i``.

    stage_fn(params_for_stage, micro) -> micro  (same shape)
    Returns the outputs in microbatch order, shape == x.shape, on every
    rank (broadcast from the last stage)."""
    group = mesh.get_group(stage_axis)
    n_stages = dist.get_world_size(group)
    n_micro = x.shape[0]
    assert n_micro % n_stages == 0, \
        "microbatches must divide stages for this schedule"
    idx = dist.get_rank(group)
    p = _stage_slice(stage_params, idx)
    last = n_stages - 1
    nxt = dist.get_global_rank(group, idx + 1) if idx < last else None
    prv = dist.get_global_rank(group, idx - 1) if idx > 0 else None
    buf = torch.zeros_like(x[0])
    outs = torch.zeros_like(x)
    for t in range(n_micro + n_stages - 1):
        # stage 0 injects microbatch t (if any)
        if idx == 0:
            cur = x[t] if t < n_micro else torch.zeros_like(x[0])
        else:
            cur = buf
        y = stage_fn(p, cur)                 # every stage works every slot
        out_i = t - last                     # the last stage emits
        if idx == last and 0 <= out_i < n_micro:
            outs[out_i] = y
        # shift activations down the pipe
        buf = exchange(y.contiguous(), nxt, torch.empty_like(y), prv, group)
    # only the last stage holds real outputs; broadcast them back
    dist.broadcast(outs, dist.get_global_rank(group, last), group=group)
    return outs


def make_mlp_stage(d: int):
    """Toy stage for tests/examples: y = gelu(x @ w1) @ w2, GELU's tanh
    form (``jax.nn.gelu``'s default)."""
    gelu = activation("gelu")

    def stage_fn(p, x):
        return gelu(x @ p["w1"]) @ p["w2"]

    def init(generator: torch.Generator, n_stages: int, device=None):
        s = 1.0 / np.sqrt(d)
        return {
            "w1": torch.randn((n_stages, d, d), generator=generator,
                              device=device) * s,
            "w2": torch.randn((n_stages, d, d), generator=generator,
                              device=device) * s,
        }

    return stage_fn, init
