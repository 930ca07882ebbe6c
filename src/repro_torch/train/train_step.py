"""The loss, the train step and the prefill / serve step functions, over
:func:`~repro_torch.models.model.apply_model`, as the reference's
``train/train_step.py`` has them.

``loss_fn`` is the cross entropy, plus the MoE losses ``moe_aux`` and
``moe_z``, plus 0.3 times DeepSeek-V3's multi-token-prediction loss
(``_mtp_loss``) where the config has the head.  ``make_train_step``
differentiates it with autograd -- through the flash and scan kernels'
``autograd.Function``s on the card (``kernels/ops.py``) -- and applies the
reference's AdamW (``optim/adamw.py``) in place.  The same step runs
sharded when the parameters and moments are DTensors on the mesh set with
``parallel/sharding.set_mesh`` and the batch is laid out over the FSDP
axes: the gradients come back as DTensors, and AdamW updates each rank's
shards.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models.attention import apply_attn
from repro_torch.models.model import (_LOGITS, _STREAM, apply_model,
                                      cache_axes)
from repro_torch.parallel.sharding import (all_reduce, argmax_last,
                                          backward_under_mesh, constrain,
                                          is_dtensor, layout, local_map,
                                          replicated_like, shard_index,
                                          under_mesh, unshard)
from repro_torch.optim.adamw import (AdamWState, adamw_update,
                                     cosine_schedule, tree_leaves, tree_map,
                                     tree_unflatten)


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean CE over (B, S), in f32: logsumexp minus the target's logit.
    Under a mesh the reduction stays where the logits lie
    (:func:`_cross_entropy_sharded`)."""
    if is_dtensor(logits):
        return _cross_entropy_sharded(logits, targets)
    l32 = logits.float()
    lse = torch.logsumexp(l32, dim=-1)
    ll = l32.gather(-1, targets.long()[..., None])[..., 0]
    return (lse - ll).mean()


def _cross_entropy_sharded(logits, targets):
    """The reference's partitioned loss ("keep the reduction local + one
    psum, no gather of the full vocab"): the batch stays sharded over the
    FSDP axes and the vocab over ``model``; each rank takes its rows'
    local max and sum of exponentials and the target's logit where its
    vocab shard holds it, and one reduction of (B_local, S) f32 rows over
    ``model`` combines each.  Written on the local shards: left to
    DTensor's propagation, the logsumexp gathers the whole batch's f32
    logits onto every rank."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = logits.device_mesh
    lpl = layout(mesh, _LOGITS, logits)
    tpl = [Replicate() if isinstance(p, Shard) and p.dim == 2 else p
           for p in lpl]
    if not is_dtensor(targets):
        targets = replicated_like(targets.to(logits.device), logits)
    idx, vocab_groups = shard_index(mesh, lpl, 2)
    n_vocab = math.prod(mesh.size(m) for m, p in enumerate(lpl)
                        if isinstance(p, Shard) and p.dim == 2)
    lo = idx * -(-logits.shape[-1] // n_vocab)   # DTensor's chunks: ceil
    row_groups = [mesh.get_group(m) for m, p in enumerate(lpl)
                  if isinstance(p, Shard) and p.dim != 2]
    n_rows = logits.shape[0] * logits.shape[1]

    def local(lg, tg):
        return _VocabParallelCE.apply(lg, tg, lo, vocab_groups, row_groups,
                                      n_rows)

    return local_map(local, [Replicate()] * mesh.ndim, (lpl, tpl),
                     (lpl, tpl))(logits, targets)


class _VocabParallelCE(torch.autograd.Function):
    """The mean CE of one rank's logits shard ``(B_l, S, V_l)``, its vocab
    from ``lo``: the max, the sum of exponentials and the target's logit
    each reduced over ``vocab_groups`` as (B_l, S) rows, the rows' sum
    over ``row_groups`` (the axes that shard the batch) over ``n`` rows.
    The backward is local: softmax minus the one-hot, recomputed from the
    saved logits and logsumexp, no collective."""

    @staticmethod
    def forward(ctx, lg, tg, lo, vocab_groups, row_groups, n):
        l32 = lg.float()
        m = all_reduce(l32.amax(-1), "max", vocab_groups)
        sumexp = all_reduce((l32 - m[..., None]).exp_().sum(-1), "sum",
                            vocab_groups)
        lse = m + sumexp.log()
        t = tg.long() - lo
        mine = (t >= 0) & (t < lg.shape[-1])
        t = t.clamp(0, lg.shape[-1] - 1)
        ll = l32.gather(-1, t[..., None])[..., 0]
        ll = all_reduce(torch.where(mine, ll, 0.0), "sum", vocab_groups)
        total = all_reduce((lse - ll).sum().reshape(1), "sum", row_groups)
        ctx.save_for_backward(lg, lse, t, mine)
        ctx.n = n
        return total[0] / n

    @staticmethod
    def backward(ctx, g):
        lg, lse, t, mine = ctx.saved_tensors
        p = lg.to(torch.float32, copy=True).sub_(lse[..., None]).exp_()
        p.scatter_add_(-1, t[..., None], -mine[..., None].to(p.dtype))
        p.mul_(g / ctx.n)
        return p.to(lg.dtype), None, None, None, None, None


def _mtp_loss(params, cfg: ArchConfig, hidden, tokens, targets,
              impl: Optional[str] = None):
    """DeepSeek-V3 multi-token prediction: predict t+2 from a fused
    (hidden_t, embed(t+1)) stream through one extra dense block in train
    mode; CE over all but the last two positions."""
    mtp = unshard(params["mtp"])
    dt = L.torch_dtype(cfg.dtype)
    nxt = torch.roll(tokens, -1, dims=1)
    e = L.embed_lookup(params["embed"], nxt).to(dt)
    h = torch.cat([L.rms_norm(hidden, mtp["norm_h"], cfg.norm_eps),
                   L.rms_norm(e, mtp["norm_e"], cfg.norm_eps)],
                  dim=-1) @ mtp["proj"].to(dt)
    lp = mtp["layer"]
    hh = L.rms_norm(h, lp["norm1"], cfg.norm_eps)
    o, _ = apply_attn(lp["attn"], hh, cfg=cfg, kind="full", mode="train",
                      impl=impl)
    h = constrain(h + o, _STREAM)
    hh = L.rms_norm(h, lp["norm2"], cfg.norm_eps)
    h = constrain(h + L.mlp_apply(lp["mlp"], hh, cfg.act), _STREAM)
    return _mtp_head_loss(params, h, targets)


def _mtp_head_loss(params, h, targets):
    """The MTP head's logits, laid out as the main head's (the batch over
    the FSDP axes, the vocab over ``model``), and their CE against the
    targets two ahead."""
    head = params.get("lm_head")
    if head is None:
        head = params["embed"].T
    logits = constrain(L.linear(h, unshard(head)), _LOGITS)
    t2 = torch.roll(targets, -1, dims=1)
    return cross_entropy(logits[:, :-2], t2[:, :-2])


@under_mesh
def loss_fn(params, batch: Dict[str, torch.Tensor], cfg: ArchConfig,
            impl: Optional[str] = None):
    """``(loss, metrics)``: metrics ``ce``, ``moe_aux``, ``mtp`` (with the
    head) and ``loss``, as the reference's."""
    tokens = batch["tokens"]
    logits, _, aux = apply_model(params, tokens, cfg=cfg, mode="train",
                                 frontend=batch.get("frontend"), impl=impl)
    targets = batch["targets"].to(logits.device)
    loss = cross_entropy(logits, targets)
    metrics = {"ce": loss}
    loss = loss + aux["moe_aux"] + aux["moe_z"]
    metrics["moe_aux"] = aux["moe_aux"]
    if cfg.mtp:
        mtp = _mtp_loss(params, cfg, aux["mtp_hidden"],
                        tokens.to(logits.device), targets, impl=impl)
        loss = loss + 0.3 * mtp
        metrics["mtp"] = mtp
    metrics["loss"] = loss
    return loss, metrics


@under_mesh
def value_and_grad(params, batch, cfg: ArchConfig,
                   impl: Optional[str] = None):
    """``((loss, metrics), grads)``: ``jax.value_and_grad(loss_fn,
    has_aux=True)``.  The grads have the parameters' tree and dtypes;
    ``params`` are left as they are (their leaves need not require
    grad)."""
    leaves = with_grad(params)
    loss, metrics = loss_fn(leaves, batch, cfg, impl=impl)
    grads = grad_tree(backward_under_mesh(loss), leaves)
    metrics = {k: v.detach() for k, v in metrics.items()}
    return (loss.detach(), metrics), grads


def with_grad(params):
    """The parameters' leaves as new leaves that require grad, sharing
    their storage."""
    return tree_map(lambda p: p.detach().requires_grad_(True), params)


def grad_tree(loss: torch.Tensor, leaves):
    """The grads of ``loss`` against every leaf of ``leaves``, in its tree;
    zeros for a leaf the loss does not reach."""
    flat = list(tree_leaves(leaves))
    got = torch.autograd.grad(loss, flat, allow_unused=True)
    return tree_unflatten(leaves, iter([torch.zeros_like(p) if g is None
                                        else g for p, g in zip(flat, got)]))


def make_train_step(cfg: ArchConfig, lr=None, impl: Optional[str] = None,
                    **opt_kw):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``; metrics add ``grad_norm`` and ``lr``.  The parameters and
    the moments are updated in place (``optim/adamw.py``)."""
    lr = lr or cosine_schedule()

    def train_step(params, opt_state: AdamWState, batch):
        (_, metrics), grads = value_and_grad(params, batch, cfg, impl=impl)
        params, opt_state, opt_metrics = adamw_update(
            grads, opt_state, params, lr=lr, **opt_kw)
        metrics.update(opt_metrics)
        return params, opt_state, metrics

    return train_step


def make_prefill_step(cfg: ArchConfig, impl: Optional[str] = None):
    """``prefill_step(params, tokens, frontend=None) -> (last logits,
    cache)``.  Under a mesh both come out as the serve step reads them:
    the cache laid out by ``cache_axes``, the logits over ("batch",
    "vocab") -- the layout the reference's dry-run pins its prefill's
    outputs to -- so the redistribution is the step's own work, counted
    with it, and a cache handed to decode is never re-laid there."""

    def prefill_step(params, tokens, frontend=None):
        logits, cache, _ = apply_model(params, tokens, cfg=cfg,
                                       mode="prefill", frontend=frontend,
                                       impl=impl)
        return (constrain(logits[:, -1], ("batch", "vocab")),
                _laid_out(cache, cache_axes(cfg)))

    return prefill_step


def _laid_out(tree, axes):
    """Every DTensor leaf of ``tree`` redistributed to its logical axes
    (``axes``, a matching tree); other leaves as they are."""
    if isinstance(tree, dict):
        return {k: _laid_out(v, axes[k]) for k, v in tree.items()}
    return constrain(tree, axes)


def make_serve_step(cfg: ArchConfig, impl: Optional[str] = None):
    """One decode step: the new token against the KV cache, which is
    written in place."""

    def serve_step(params, cache, tokens):
        logits, cache, _ = apply_model(params, tokens, cfg=cfg, mode="decode",
                                       cache=cache, impl=impl)
        next_tok = argmax_last(logits[:, -1]).to(torch.int32)
        return next_tok, cache

    return serve_step
