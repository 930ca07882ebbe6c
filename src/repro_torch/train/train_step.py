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

from typing import Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models.attention import apply_attn
from repro_torch.models.model import apply_model, cache_axes
from repro_torch.parallel.sharding import (argmax_last, backward_under_mesh,
                                          constrain, is_dtensor, under_mesh,
                                          unshard, vocab_ids)
from repro_torch.optim.adamw import (AdamWState, adamw_update,
                                     cosine_schedule, tree_leaves, tree_map,
                                     tree_unflatten)


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean CE over (B, S), in f32: logsumexp minus the target's logit."""
    l32 = logits.float()
    lse = torch.logsumexp(l32, dim=-1)
    if is_dtensor(l32):
        # vocab may be model-sharded: a one-hot product keeps the reduction
        # local + one sum over the shards, as the reference's einsum does;
        # the vocab ids laid out as the logits' vocab dim, so each rank
        # compares its own shard only
        ids = vocab_ids(l32)
        ll = (l32 * (targets.long()[..., None] == ids)).sum(-1)
    else:
        ll = l32.gather(-1, targets.long()[..., None])[..., 0]
    return (lse - ll).mean()


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
    h = h + o
    hh = L.rms_norm(h, lp["norm2"], cfg.norm_eps)
    h = h + L.mlp_apply(lp["mlp"], hh, cfg.act)
    head = params.get("lm_head")
    if head is None:
        head = params["embed"].T
    logits = h @ unshard(head).to(dt)
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
