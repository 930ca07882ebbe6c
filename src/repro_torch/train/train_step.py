"""The cross-entropy loss and the prefill / serve step functions the
reference's dry-run lowers, over :func:`~repro_torch.models.model.
apply_model`.  ``loss_fn`` and ``make_train_step`` come with the training
slice of the port."""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.model import apply_model


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean CE over (B, S), in f32: logsumexp minus the target's logit."""
    l32 = logits.float()
    lse = torch.logsumexp(l32, dim=-1)
    ll = l32.gather(-1, targets.long()[..., None])[..., 0]
    return (lse - ll).mean()


def make_prefill_step(cfg: ArchConfig, impl: Optional[str] = None):
    def prefill_step(params, tokens):
        logits, cache, _ = apply_model(params, tokens, cfg=cfg,
                                       mode="prefill", impl=impl)
        return logits[:, -1], cache

    return prefill_step


def make_serve_step(cfg: ArchConfig, impl: Optional[str] = None):
    """One decode step: the new token against the KV cache, which is
    written in place."""

    def serve_step(params, cache, tokens):
        logits, cache, _ = apply_model(params, tokens, cfg=cfg, mode="decode",
                                       cache=cache, impl=impl)
        next_tok = logits[:, -1].argmax(dim=-1).to(torch.int32)
        return next_tok, cache

    return serve_step
