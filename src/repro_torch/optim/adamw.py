"""AdamW written out, as the reference's ``optim/adamw.py`` computes it:
f32 moments, global-norm clipping over every leaf in f32, bias correction
with ``b ** step`` in f32, decoupled weight decay on every leaf (norms
included), the new parameter computed in f32 and rounded to the leaf's
dtype.  ``torch.optim.AdamW`` differs (its decay is applied before the
moment step and its bias correction in double), so it is not used.

The update runs under ``torch.no_grad()`` and IN PLACE: each parameter
leaf and each moment is overwritten, where the reference returns new
arrays.  At deepseek-v3's width a second copy of the parameters and the
moments would not fit beside the first.  A caller that needs the
parameters as they were clones them first.

Leaves are visited in the reference's order (``jax.tree.leaves``: dict
keys sorted), so the f32 sum of the global norm runs in the same order.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Iterator, NamedTuple

import torch

from repro_torch.parallel.sharding import under_mesh


class AdamWState(NamedTuple):
    step: torch.Tensor          # int32 scalar, on the parameters' device
    m: Any                      # f32, the parameters' tree
    v: Any


def tree_leaves(tree) -> Iterator[torch.Tensor]:
    """The leaves of nested dicts, keys sorted (``jax.tree.leaves``)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k])
    else:
        yield tree


def tree_unflatten(template, leaves: Iterator):
    """``template``'s tree (nested dicts and :class:`AdamWState`s) with its
    leaves taken in turn from ``leaves``, in :func:`tree_leaves`' order."""
    if isinstance(template, dict):
        return {k: tree_unflatten(template[k], leaves)
                for k in sorted(template)}
    if isinstance(template, AdamWState):
        return AdamWState(*(tree_unflatten(getattr(template, f), leaves)
                            for f in template._fields))
    return next(leaves)


def tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def adamw_init(params) -> AdamWState:
    """Zero f32 moments laid out as the parameters (DTensor parameters
    give DTensor moments with the same placements)."""
    dev = next(tree_leaves(params)).device
    z = lambda p: torch.zeros_like(p, dtype=torch.float32)
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      m=tree_map(z, params), v=tree_map(z, params))


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


@torch.no_grad()
@under_mesh
def adamw_update(
    grads, state: AdamWState, params, *,
    lr: Callable[[torch.Tensor], torch.Tensor],
    b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
    weight_decay: float = 0.1, clip_norm: float = 1.0,
):
    """Returns ``(params, state, {"grad_norm", "lr"})``; ``params`` and the
    moments are the caller's tensors, updated in place."""
    step = state.step + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    lr_t = lr(step)
    s32 = step.float()
    c1 = 1 - torch.pow(b1, s32)
    c2 = 1 - torch.pow(b2, s32)

    def upd(g, m, v, p):
        g32 = g.float() * scale
        m.mul_(b1).add_((1 - b1) * g32)
        v.mul_(b2).add_((1 - b2) * g32 * g32)
        mhat = m / c1
        vhat = v / c2
        p32 = p.float()
        delta = mhat / (torch.sqrt(vhat) + eps) + weight_decay * p32
        p.copy_(p32 - lr_t * delta)

    for g, m, v, p in zip(tree_leaves(grads), tree_leaves(state.m),
                          tree_leaves(state.v), tree_leaves(params)):
        upd(g, m, v, p)
    return params, AdamWState(step=step, m=state.m, v=state.v), {
        "grad_norm": gnorm, "lr": lr_t}


def cosine_schedule(peak_lr: float = 3e-4, warmup: int = 200,
                    total: int = 10_000, floor: float = 0.1):
    """Linear warmup to ``peak_lr``, then cosine down to ``floor *
    peak_lr`` at ``total``; a function of the (int) step tensor, in f32."""
    def lr(step: torch.Tensor) -> torch.Tensor:
        s = step.float()
        warm = peak_lr * s / max(1, warmup)
        frac = torch.clamp((s - warmup) / max(1, total - warmup), 0.0, 1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5
                         * (1 + torch.cos(math.pi * frac)))
        return torch.where(s < warmup, warm, cos)
    return lr


def opt_state_axes(params_axes) -> AdamWState:
    """Optimizer-state logical axes mirror the parameter axes."""
    return AdamWState(step=(), m=params_axes, v=params_axes)


def abstract_opt_state(p_abs) -> AdamWState:
    """The optimizer state of a ``meta`` parameter tree, on ``meta``."""
    f32 = lambda p: torch.empty(p.shape, dtype=torch.float32, device="meta")
    return AdamWState(step=torch.empty((), dtype=torch.int32, device="meta"),
                      m=tree_map(f32, p_abs), v=tree_map(f32, p_abs))


__all__ = ["AdamWState", "abstract_opt_state", "adamw_init", "adamw_update", "cosine_schedule",
           "global_norm", "opt_state_axes", "tree_leaves", "tree_map",
           "tree_unflatten"]
