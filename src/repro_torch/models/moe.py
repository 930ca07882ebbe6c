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

Under a mesh whose ``model`` axis divides the experts and the sequence,
:func:`apply_moe_ep` runs expert parallelism, as the reference's
``shard_map`` branch does: each ``model`` rank routes its own sequence
slice (capacity over its local tokens), sends the capacity-selected
tokens to the experts' owners with one all-to-all over ``model``, runs its
E/tp local experts, and all-to-alls the outputs home; the aux losses are
averaged over every shard.  Under any other mesh (:func:`_moe_sharded`)
every rank routes the whole batch as the reference does, runs only its
own experts' slots on the expert weights where they lie, and one
all-reduce over ``model`` sums the ranks' outputs.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models.layers import Spec, mlp_apply, mlp_specs
from repro_torch.parallel import sharding as shlib

__all__ = ["apply_moe", "apply_moe_ep", "capacity", "moe_specs", "route"]


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
    return _routing(xt.float() @ p["router"].float(), cfg)  # (T, E) logits


def _routing(logits: torch.Tensor, cfg: ArchConfig):
    """:func:`route` from the router's logits (T, E)."""
    m = cfg.moe
    T = logits.shape[0]
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


def _expert_ffn(p, xe: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """The experts' gated FFN on their slots ``xe`` (E, C, D)."""
    f = L.activation("silu" if cfg.act == "silu" else "gelu")
    w = {k: p[k].to(xe.dtype) for k in ("wi_gate", "wi_up", "wo")}
    h = f(torch.bmm(xe, w["wi_gate"])) * torch.bmm(xe, w["wi_up"])
    return torch.bmm(h, w["wo"])                           # (E, C, D)


def _combine(ye: torch.Tensor, cw, ci, top_i, T: int, dtype,
             e0: int = 0) -> torch.Tensor:
    """Each token's expert outputs (rows of ``ye`` (E, C, D), weighted by
    ``cw``), added in ascending expert order: the reference's scatter-add
    in a fixed order.  Returns (T, D) in ``dtype``.  With ``e0``, ``ye``,
    ``cw`` and ``ci`` hold experts ``e0 .. e0 + E - 1`` of ``top_i``'s
    ids, and only their outputs are added (one rank's share of a sum over
    ranks)."""
    E, C = ci.shape
    D = ye.shape[-1]
    ye = ye * cw.to(ye.dtype)[..., None]                   # 0 where untaken
    ye = ye.to(dtype).reshape(E * C, D)
    dev = ye.device
    # slot[e, t] is the row of ye that expert e kept token t in (-1 if
    # none; untaken slots land in a spare column T, no host sync); a
    # token's experts in ascending order, their outputs added in turn
    col = torch.where(cw > 0.0, ci, T)
    rows = torch.arange(E * C, device=dev).reshape(E, C)
    slot = torch.full((E, T + 1), -1, dtype=torch.long, device=dev)
    slot = slot.scatter_(1, col, rows)[:, :T]
    experts = torch.sort(top_i, dim=-1).values              # (T, k)
    tok = torch.arange(T, device=dev)
    out = torch.zeros((T, D), dtype=dtype, device=dev)
    for j in range(top_i.shape[1]):
        e = experts[:, j] - e0                              # (T,)
        here = (e >= 0) & (e < E)
        sj = torch.where(here, slot[e.clamp(0, E - 1), tok], -1)
        kept = (sj >= 0)[:, None]
        out = out + torch.where(kept, ye[sj.clamp_min(0)], 0)
    return out


def _moe_dense(p, x: torch.Tensor, cfg: ArchConfig):
    """Dense dispatch on one device's tokens."""
    m = cfg.moe
    B, S, D = x.shape
    T = B * S
    xt = x.reshape(T, D)
    top_i, cw, ci, aux = route(p, xt, cfg)
    E, C = ci.shape
    xe = xt[ci.reshape(-1)].reshape(E, C, D)
    ye = _expert_ffn(p, xe, cfg)
    out = _combine(ye, cw, ci, top_i, T, x.dtype).reshape(B, S, D)
    if m.n_shared:
        out = out + mlp_apply(p["shared"], x, cfg.act)
    return out, aux


class _AllToAll(torch.autograd.Function):
    """``jax.lax.all_to_all(x, split_axis, concat_axis, tiled=True)`` over
    a process group: x cut into n pieces along ``split``, piece j to rank
    j, the pieces received concatenated along ``concat`` in rank order.
    Its gradient is the exchange back."""

    @staticmethod
    def forward(ctx, x, split, concat, group):
        ctx.args = (split, concat, group)
        return _all_to_all(x, split, concat, group)

    @staticmethod
    def backward(ctx, g):
        split, concat, group = ctx.args
        return _all_to_all(g.contiguous(), concat, split, group), None, \
            None, None


def _all_to_all(x, split: int, concat: int, group) -> torch.Tensor:
    """The pieces stacked on a new leading dim for the exchange and the
    received ones laid along ``concat``, as ``torch.stack`` of the chunks
    and ``torch.cat`` would, by views where the dim is the leading one (no
    copy of the tokens there)."""
    import torch.distributed._functional_collectives as funcol
    n = group.size()
    send = x.unflatten(split, (n, -1)).movedim(split, 0).contiguous()
    got = funcol.all_to_all_single(send, None, None, group)
    del send
    got = funcol.wait_tensor(got)
    return got.movedim(0, concat).flatten(concat, concat + 1)


class _Mean(torch.autograd.Function):
    """The mean of a scalar over a process group (``jax.lax.pmean``); its
    gradient is the replicated upstream gradient over the group's size."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed._functional_collectives as funcol
        ctx.n = group.size()
        return funcol.wait_tensor(funcol.all_reduce(x, "avg", group))

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


class _Psum(torch.autograd.Function):
    """The sum over process groups of each rank's partial sum
    (``jax.lax.psum``).  What follows it splits its work over the same
    ranks, so its gradient comes back as partial sums too, and is summed
    the same way."""

    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return shlib.all_reduce(x, "sum", groups)

    @staticmethod
    def backward(ctx, g):
        return shlib.all_reduce(g.contiguous(), "sum", ctx.groups), None


def apply_moe_ep(p, x, *, cfg: ArchConfig, mesh):
    """Explicit expert parallelism (the reference's ``shard_map`` branch):
    each ``model`` rank routes a sequence slice of its local batch,
    exchanges the capacity-selected tokens with an all-to-all over
    ``model``, runs its local experts, and all-to-alls the outputs home --
    no full-activation all-reduce."""
    m = cfg.moe
    D = x.shape[-1]
    fsdp = shlib.fsdp_axes(mesh)
    bspec = fsdp[0] if len(fsdp) == 1 else (fsdp or None)
    xpl = list(shlib.placements(mesh, (bspec, "model")))
    rep = list(shlib.placements(mesh, ()))
    epl = list(shlib.placements(mesh, ("model",)))
    model_group = mesh.get_group("model")
    groups = [mesh.get_group(a) for a in ("model",) + fsdp]
    shared = p.get("shared")
    names = sorted(shared) if shared else []

    def block(xb, router, wig, wiu, wo, *sh):
        Bl, Sl, _ = xb.shape
        T = Bl * Sl
        xt = xb.reshape(T, D)
        top_i, cw, ci, aux = route({"router": router}, xt, cfg)
        E, C = ci.shape
        xe = xt[ci.reshape(-1)].reshape(E, C, D)
        # dispatch: (E, C, D) -> (E/tp, C*tp, D) rows of local experts;
        # each stage's input dropped once the next is made
        xr = _AllToAll.apply(xe, 0, 1, model_group)
        del xe
        yr = _expert_ffn({"wi_gate": wig, "wi_up": wiu, "wo": wo}, xr, cfg)
        del xr
        # combine: route outputs back to the token-owner shard
        ye = _AllToAll.apply(yr, 1, 0, model_group)        # (E, C, D)
        del yr
        out = _combine(ye, cw, ci, top_i, T, xb.dtype).reshape(Bl, Sl, D)
        if m.n_shared:
            out = out + mlp_apply(dict(zip(names, sh)), xb, cfg.act)
        # average aux over all shards so the loss is mesh-independent
        for g in groups:
            aux = {k: _Mean.apply(v, g) for k, v in aux.items()}
        return out, aux["moe_aux"], aux["moe_z"]

    ins = (xpl, rep, epl, epl, epl) + (rep,) * len(names)
    # weights meet each shard's own tokens: their grads sum over the shards
    grads = (xpl,) + tuple(shlib.partial_over(p, xpl) for p in ins[1:])
    out, a, z = shlib.local_map(block, (xpl, rep, rep), ins, grads)(
        x, p["router"].float(), p["wi_gate"], p["wi_up"], p["wo"],
        *(shared[k] for k in names))
    # the sequence whole again over model (the residual stream's layout)
    out = shlib.constrain(out, ("batch", None, None))
    return out, {"moe_aux": a, "moe_z": z}


def apply_moe(
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,                        # (B, S, D) normed
    *,
    cfg: ArchConfig,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    m = cfg.moe
    S = x.shape[1]
    mesh = shlib.get_mesh()
    if mesh is None or not shlib.is_dtensor(x):
        return _moe_dense(p, x, cfg)
    if ("model" in shlib.axis_names(mesh)
            and m.n_experts % shlib.axis_size(mesh, "model") == 0
            and S % shlib.axis_size(mesh, "model") == 0):
        return apply_moe_ep(p, x, cfg=cfg, mesh=mesh)
    return _moe_sharded(p, x, cfg=cfg, mesh=mesh)


def _moe_sharded(p, x, *, cfg: ArchConfig, mesh):
    """Dense dispatch under a mesh that does not take expert parallelism
    (decode: S = 1 does not divide ``model``), with the reference's
    routing over the whole batch -- its top-k, its capacity over T, its
    kept pairs -- and the expert weights where they lie (experts over
    ``model``, the embed dim over the FSDP axes): each rank runs only its
    own experts' slots, sums their gate and up products over the embed
    shards (an all-reduce of (E/tp, C, F) over the FSDP axes), takes its
    embed slice of the down product, and adds its experts' outputs per
    token in ascending expert order into a (T, D) partial sum that one
    all-reduce over ``model`` completes: the reference's "local
    scatter-add per expert shard, ONE psum of (T, D)"."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    m = cfg.moe
    B, S, D = x.shape
    T = B * S
    rep = list(shlib.placements(mesh, ()))
    xr = x.redistribute(mesh, rep)           # the batch the reference routes
    # the router's product split by batch rows over ``model``, its logits
    # gathered: every rank then routes the whole batch
    tp = (shlib.axis_size(mesh, "model") if "model" in shlib.axis_names(mesh)
          else 1)
    rows = list(shlib.placements(mesh, ("model",) if B % tp == 0 else ()))
    logits = shlib.local_map(
        lambda xs, r: xs.reshape(-1, D).float() @ r.float(), rows,
        (rows, rep), (rows, shlib.partial_over(rep, rows)))(xr, p["router"])

    def routing(lg):
        top_i, cw, ci, aux = _routing(lg, cfg)
        return top_i, cw, ci, aux["moe_aux"], aux["moe_z"]

    top_i, cw, ci, a, z = shlib.local_map(routing, (rep,) * 5, (rep,))(
        logits.redistribute(mesh, rep))

    wig, wiu, wo = p["wi_gate"], p["wi_up"], p["wo"]
    wpl, opl = list(wig.placements), list(wo.placements)
    e_idx, _ = shlib.shard_index(mesh, wpl, 0)
    d_idx, d_groups = shlib.shard_index(mesh, wpl, 1)
    f = L.activation("silu" if cfg.act == "silu" else "gelu")

    def experts(xs, cws, cis, tops, wg, wu, wd):
        El, Dl = wg.shape[0], wg.shape[1]
        e0, d0 = e_idx * El, d_idx * Dl
        ci_l, cw_l = cis[e0:e0 + El], cws[e0:e0 + El]
        xe = xs.reshape(T, D)[ci_l.reshape(-1)].reshape(El, -1, D)
        xe = xe[..., d0:d0 + Dl]
        g = torch.bmm(xe, wg.to(xe.dtype))
        u = torch.bmm(xe, wu.to(xe.dtype))
        if d_groups:
            g, u = _Psum.apply(g, d_groups), _Psum.apply(u, d_groups)
        ye = torch.bmm(f(g) * u, wd.to(xe.dtype))         # (El, C, D slice)
        out = _combine(ye, cw_l, ci_l, tops, T, xs.dtype, e0)
        return out.reshape(B, S, -1)

    # out: a partial sum over the ranks that split the experts, the embed
    # slice of the ranks that split it
    out_pl = [Partial() if isinstance(q, Shard) and q.dim == 0 else
              Shard(2) if isinstance(q, Shard) else Replicate() for q in wpl]
    split = [Partial() if isinstance(q, Shard) else Replicate() for q in wpl]
    ins = (rep, rep, rep, rep, wpl, wpl, opl)
    grads = (split, split, rep, rep, wpl, wpl, opl)
    out = shlib.local_map(experts, out_pl, ins, grads)(
        xr, cw, ci, top_i, wig, wiu, wo)
    out = shlib.constrain(out, ("batch", None, None))
    if m.n_shared:
        out = out + mlp_apply(p["shared"], x, cfg.act)
    return out, {"moe_aux": a, "moe_z": z}
