"""Gradient compression for the data-parallel all-reduce: int8 ring
reduce-scatter + all-gather with per-chunk scales and error feedback
(the reference's ``parallel/compression.py``).

Wire bytes: 1 byte/element/hop instead of 4 (f32) or 2 (bf16) -- the
standard trick for links that cross the data-center network.  Error
feedback keeps the quantization bias out of the optimizer: the residual
of each step is added back before the next quantization (Karimireddy et
al. '19).

The ring is explicit point-to-point transfers over the mesh axis's
process group (an int8 payload and an f32 scale a hop, n-1 hops of
reduce-scatter, then n-1 of all-gather), so the int8 wire format is what
moves (``parallel/collectives.py``'s ``exchange``).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

from repro_torch.parallel.collectives import exchange


def _quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = x.abs().max() / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def _hop(q, scale, group, nxt, prv):
    """Pass (q, scale) one step round the ring: to ``nxt``, from ``prv``."""
    q_r = exchange(q, nxt, torch.empty_like(q), prv, group)
    s_r = exchange(scale.reshape(1), nxt, torch.empty(1, device=q.device),
                   prv, group)
    return q_r, s_r[0]


def ring_allreduce_int8(x: torch.Tensor, group) -> torch.Tensor:
    """Ring reduce-scatter + ring all-gather over ``group``, int8 wire.

    x: (n*chunk, ...) flat leading dim divisible by the group's size;
    f32.  Every rank of the group calls it."""
    n = dist.get_world_size(group)
    idx = dist.get_rank(group)
    nxt = dist.get_global_rank(group, (idx + 1) % n)
    prv = dist.get_global_rank(group, (idx - 1) % n)
    acc = x.reshape((n, -1) + tuple(x.shape[1:])).clone()   # (n, chunk, ...)

    # reduce-scatter: after n-1 hops, rank i owns the sum of chunk i+1
    for s in range(n - 1):
        q, scale = _quantize(acc[(idx - s) % n])
        q_r, s_r = _hop(q, scale, group, nxt, prv)
        acc[(idx - s - 1) % n] += _dequantize(q_r, s_r)
    own = (idx + 1) % n
    owned = acc[own]                                  # fully reduced chunk

    # all-gather: n-1 hops of the owned (quantized once) chunk; the
    # arrivals overwrite the partial sums no longer needed, in place
    q, sc = _quantize(owned)
    for s in range(n - 1):
        q, sc = _hop(q, sc, group, nxt, prv)
        acc[(idx - s) % n] = _dequantize(q, sc)      # whose chunk arrived
    return acc.reshape(x.shape)


def compressed_psum(x: torch.Tensor, mesh, axis: str = "data") -> torch.Tensor:
    """Compressed all-reduce (sum) of ``x`` over one mesh axis; every rank
    of the axis passes its own ``x`` and gets the sum, in f32."""
    group = mesh.get_group(axis)
    n = dist.get_world_size(group)
    flat = x.reshape(-1).float()
    pad = (-flat.shape[0]) % n
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    out = ring_allreduce_int8(flat, group)
    return out[: x.numel()].reshape(x.shape)


def compress_with_feedback(grads, residual, mesh, axis: str = "data"):
    """Error-feedback wrapper: g' = AR_int8(g + r) / n; r' = (g + r) - g'.

    ``grads`` and ``residual`` are trees (nested dicts) of the same
    structure; the residual is f32 and lives with the optimizer state, so
    quantization error does not accumulate across steps.  Returns
    ``(mean grads, new residual)``."""
    n = mesh.size(mesh.mesh_dim_names.index(axis))

    def one(g, r):
        gr = g.float() + r
        mean = compressed_psum(gr, mesh, axis) / n
        return mean.to(g.dtype), gr - mean   # local error kept for next step

    if isinstance(grads, dict):
        pairs = {k: compress_with_feedback(grads[k], residual[k], mesh, axis)
                 for k in sorted(grads)}
        return ({k: v[0] for k, v in pairs.items()},
                {k: v[1] for k, v in pairs.items()})
    return one(grads, residual)
