"""Parameter specs and initialisation for the paged-eligible model family.

The paged serving path (``serve/paged_model.py``) supports the GQA
transformer family: every layer ``mixer="attn"`` with ``attn_kind="full"``
and a dense MLP, with optional qk_norm, post_norms, softcaps, partial
rotary and tied embeddings.  :func:`check_paged_support` rejects anything
else up front.  The parameter tree keeps the reference package's key
layout (``embed``, ``final_norm``, ``lm_head``,
``groups/g{gi}/p{pi}/{norm1, attn/{wq,wk,wv,wo,q_scale,k_scale}, norm2,
mlp/..., post_norm*}``, stacked over repeats) so weights bridge 1:1.

MLA, sliding-window, SSM/RWKV mixers, MoE, cross-attention, weight-tied
shared attention and the dense forward (``apply_model``) are ported with
the dense path in a later slice.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from repro_torch.configs.base import ArchConfig, LayerSpec
from repro_torch.models import layers as L

Spec = L.Spec

__all__ = ["build_specs", "check_paged_support", "init_params"]


def check_paged_support(cfg: ArchConfig) -> None:
    """Raise ValueError unless every layer of ``cfg`` is paged-decodable."""
    problems: List[str] = []
    if cfg.encoder_groups:
        problems.append("encoder_groups (enc-dec)")
    if cfg.mtp:
        problems.append("mtp head")
    for gi, g in enumerate(cfg.groups):
        for pi, ls in enumerate(g.pattern):
            where = f"g{gi}/p{pi}"
            if ls.mixer != "attn":
                problems.append(f"{where}: mixer={ls.mixer}")
            elif ls.attn_kind != "full":
                problems.append(f"{where}: attn_kind={ls.attn_kind}")
            if ls.mlp != "dense":
                problems.append(f"{where}: mlp={ls.mlp}")
            if ls.shared_attn:
                problems.append(f"{where}: shared_attn")
            if not ls.causal:
                problems.append(f"{where}: non-causal")
    if problems:
        raise ValueError(
            "config not supported by the paged KV path (use kv_store="
            "'dense'): " + "; ".join(problems))


def _attn_specs(cfg: ArchConfig) -> Dict[str, Spec]:
    D, H, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    s = {
        "wq": Spec((D, H, hd), ("embed", "heads", "head_dim")),
        "wk": Spec((D, Hkv, hd), ("embed", "kv_heads", "head_dim")),
        "wv": Spec((D, Hkv, hd), ("embed", "kv_heads", "head_dim")),
        "wo": Spec((H, hd, D), ("heads", "head_dim", "embed")),
    }
    if cfg.qk_norm:
        s["q_scale"] = Spec((hd,), ("head_dim",), "zeros")
        s["k_scale"] = Spec((hd,), ("head_dim",), "zeros")
    return s


def _layer_specs(cfg: ArchConfig, spec: LayerSpec) -> Dict[str, Any]:
    D = cfg.d_model
    s: Dict[str, Any] = {
        "norm1": Spec((D,), ("embed",), "zeros"),
        "attn": _attn_specs(cfg),
        "norm2": Spec((D,), ("embed",), "zeros"),
        "mlp": L.mlp_specs(D, cfg.d_ff, cfg.act),
    }
    if cfg.post_norms:
        s["post_norm1"] = Spec((D,), ("embed",), "zeros")
        s["post_norm2"] = Spec((D,), ("embed",), "zeros")
    return s


def build_specs(cfg: ArchConfig) -> Dict[str, Any]:
    check_paged_support(cfg)
    D, V = cfg.d_model, cfg.vocab_padded
    specs: Dict[str, Any] = {
        "embed": Spec((V, D), ("vocab", "embed"), "normal", 1.0),
        "final_norm": Spec((D,), ("embed",), "zeros"),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = Spec((D, V), ("embed", "vocab"))
    specs["groups"] = {
        f"g{gi}": {f"p{pi}": L.stack_specs(_layer_specs(cfg, ls), g.repeats)
                   for pi, ls in enumerate(g.pattern)}
        for gi, g in enumerate(cfg.groups)}
    return specs


def init_params(cfg: ArchConfig, generator: Optional[torch.Generator] = None,
                device=None) -> Dict[str, Any]:
    """Random weights from ``generator`` on ``device`` (``cuda`` unless
    given).  Leaves take their Spec dtype (bf16) whatever ``cfg.dtype`` is,
    as in the reference; the forward casts them to the compute dtype.  A
    different generator than the reference's ``jax.random`` key: tests that
    need the same weights in both packages bridge the reference's with
    ``bridge.params_from_jax``."""
    device = torch.device(device if device is not None else "cuda")
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    return L.materialize(build_specs(cfg), generator, device)
