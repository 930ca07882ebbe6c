"""Mixture-of-experts FFN, dense dispatch.

Routing: token-choice top-k with renormalized weights.  Dispatch uses the
capacity-bounded *per-expert top-C tokens* formulation of the reference's
``models/moe.py``: a gather into (E, C, d), per-expert batched products,
and a combine of each token's expert outputs.

Parity points with the reference:

* the router product is f32 (``x.float() @ router``, the router kept f32
  by its Spec dtype);
* both top-k selections break ties toward the lower index, as
  ``jax.lax.top_k`` does (a stable descending sort), so the kept (expert,
  token) pairs -- and which tokens an over-full expert drops -- are the
  reference's;
* the capacity is ``int(cf * T * top_k / E)`` floored at ``min(T, top_k)``
  and capped at T, the float expression in the reference's order (in
  decode T is the batch, so C = T and every expert runs on every token);
* non-silu activations are GELU's tanh form (``jax.nn.gelu``'s default).

The combine is the reference's scatter-add (``.at[ci].add`` in the
activation dtype) in a fixed order: each token gathers the outputs of the
slots that kept it and adds them in ascending expert order -- the order in
which the reference's flattened (E, C) updates reach the token -- so the
result is the same bits from run to run on the card, with no atomics.

The expert-parallel branch (``_moe_local``/``apply_moe_ep``, which runs only
under a device mesh) is not ported: it comes with the distribution slice.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models.layers import Spec, mlp_apply, mlp_specs

__all__ = ["apply_moe", "capacity", "moe_specs", "route"]


def moe_specs(cfg: ArchConfig) -> Dict[str, Spec]:
    m, D = cfg.moe, cfg.d_model
    s = {
        "router": Spec((D, m.n_experts), ("embed", "experts_router"), "normal",
                       1.0, "float32"),
        "wi_gate": Spec((m.n_experts, D, m.d_ff), ("experts", "embed", "mlp")),
        "wi_up": Spec((m.n_experts, D, m.d_ff), ("experts", "embed", "mlp")),
        "wo": Spec((m.n_experts, m.d_ff, D), ("experts", "mlp", "embed")),
    }
    if m.n_shared:
        s["shared"] = mlp_specs(D, m.d_ff * m.n_shared, cfg.act)
    return s


def capacity(cfg: ArchConfig, T: int) -> int:
    """Slots per expert for T tokens, floored at top_k so tiny decode
    batches never drop tokens."""
    m = cfg.moe
    C = int(m.capacity_factor * T * m.top_k / m.n_experts)
    return max(1, min(T, max(C, min(T, m.top_k))))


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` along the last axis: the k largest, equal values
    in ascending index order."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def route(p: Dict[str, torch.Tensor], xt: torch.Tensor, cfg: ArchConfig):
    """Router and capacity selection for tokens ``xt`` (T, D).  Returns
    ``(top_i, cw, ci, aux)``: each token's experts (T, k), and each
    expert's kept weights and token ids (E, C), zero weight on a slot no
    routed token filled."""
    m = cfg.moe
    T = xt.shape[0]
    logits = xt.float() @ p["router"].float()              # (T, E)
    gates = torch.softmax(logits, dim=-1)
    top_w, top_i = _top_k(gates, m.top_k)                  # (T, k)
    top_w = top_w / torch.clamp_min(top_w.sum(-1, keepdim=True), 1e-9)

    # (E, T) routing score matrix restricted to selected pairs
    sel = torch.nn.functional.one_hot(top_i, m.n_experts).float()  # (T,k,E)
    score_et = (sel * top_w[..., None]).sum(1).T           # (E, T)
    cw, ci = _top_k(score_et, capacity(cfg, T))            # (E, C)

    # aux losses (Switch-style load balance + router z-loss)
    density = sel.sum(1).mean(0)            # fraction routed per expert
    mean_gate = gates.mean(0)
    aux = {
        "moe_aux": m.aux_coef * m.n_experts * torch.sum(density * mean_gate),
        "moe_z": m.router_z_coef * torch.mean(
            torch.logsumexp(logits, dim=-1) ** 2),
    }
    return top_i, cw, ci, aux


def apply_moe(
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,                        # (B, S, D) normed
    *,
    cfg: ArchConfig,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    m = cfg.moe
    B, S, D = x.shape
    T = B * S
    xt = x.reshape(T, D)
    top_i, cw, ci, aux = route(p, xt, cfg)
    E, C = ci.shape

    xe = xt[ci.reshape(-1)].reshape(E, C, D)
    f = L.activation("silu" if cfg.act == "silu" else "gelu")
    w = {k: p[k].to(x.dtype) for k in ("wi_gate", "wi_up", "wo")}
    h = f(torch.bmm(xe, w["wi_gate"])) * torch.bmm(xe, w["wi_up"])
    ye = torch.bmm(h, w["wo"])                             # (E, C, D)
    ye = ye * cw.to(ye.dtype)[..., None]                   # 0 where untaken
    ye = ye.to(x.dtype).reshape(E * C, D)

    # combine: slot[e, t] is the row of ye that expert e kept token t in (-1
    # if none; untaken slots land in a spare column T, no host sync); a
    # token's experts in ascending order, their outputs added in turn
    col = torch.where(cw > 0.0, ci, T)
    rows = torch.arange(E * C, device=x.device).reshape(E, C)
    slot = torch.full((E, T + 1), -1, dtype=torch.long, device=x.device)
    slot = slot.scatter_(1, col, rows)[:, :T]
    experts = torch.sort(top_i, dim=-1).values              # (T, k)
    tok = torch.arange(T, device=x.device)
    out = torch.zeros((T, D), dtype=x.dtype, device=x.device)
    for j in range(m.top_k):
        sj = slot[experts[:, j], tok]                       # (T,)
        kept = (sj >= 0)[:, None]
        out = out + torch.where(kept, ye[sj.clamp_min(0)], 0)
    out = out.reshape(B, S, D)

    if m.n_shared:
        out = out + mlp_apply(p["shared"], x, cfg.act)
    return out, aux
