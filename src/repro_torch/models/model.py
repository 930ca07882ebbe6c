"""Model assembly: embeddings -> layer groups -> norm -> logits.

The reference's one forward, :func:`apply_model`, for every architecture
of the registry: GQA attention (full and sliding window), MLA with its
absorbed decode, cross attention over a frontend's tokens, Mamba2,
RWKV-6, zamba2's weight-tied shared attention block, the dense MLP and
the MoE FFN (dense dispatch, ``models/moe.py``).  Enc-dec configs
(whisper) run their encoder groups on the frontend's embeddings in
train/prefill; a VLM (llama-3.2-vision) attends to the frontend's tokens
as they are.  DeepSeek-V3's multi-token-prediction head has its
parameters here (``mtp``), and train mode hands its input out as
``aux["mtp_hidden"]``; its loss is ``train/train_step.py``'s.

Modes:
  train:   full-seq forward, differentiable (the kernels through their
           ``autograd.Function``s, ``kernels/ops.py``), each pattern
           repeat under ``cfg.remat`` (:func:`_remat`); returns (logits,
           None, aux)
           (aux: the MoE losses ``moe_aux``/``moe_z`` summed in f32 over
           every MoE layer, zeros without one; every mode returns them)
  prefill: full-seq forward, returns (last-position logits, cache)
  decode:  one token per sequence against the cache, returns (logits, cache)
           (never runs the encoder: cross layers read the K/V cached at
           prefill, zeros in a cache no prefill wrote)

The layer groups run as a Python loop over the pattern repeats (the
reference's ``scan``/``fori_loop``), weights stacked on a leading
"layers" axis.  Decode writes each layer's new token and states INTO the
stacked cache tensors at the layer index -- in place, where the reference
returns new arrays -- so a caller that needs the cache as it was must
clone it first.

The parameter tree keeps the reference's key layout (``embed``,
``final_norm``, ``lm_head``, ``groups/g{gi}/p{pi}/...`` stacked over
repeats, ``shared_attn/{norm, attn}``, ``encoder/{groups, final_norm,
pos_embed}``, ``mtp/{norm_h, norm_e, proj, layer}``) so weights bridge
1:1.  :func:`check_paged_support` says which configs the paged serving
path (``serve/paged_model.py``) takes.

Under a mesh (``parallel/sharding.py``: DTensor parameters laid out by
:func:`params_logical_axes`) each repeat gathers its weights over the FSDP
axes at use (``unshard``; under remat again in the backward) but for the
MoE's experts and, in decode, every matrix, which its products use where
it lies (:func:`_at_use`); the residual stream and the logits are pinned
to their layouts where the reference constrains them, their gradients
too, and the kernels run on each rank's local shards
(``models/attention.py``, ``models/ssm.py``, ``models/moe.py``).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig, LayerSpec
from repro_torch.models import layers as L
from repro_torch.models.attention import apply_attn, attn_specs
from repro_torch.models.moe import apply_moe, moe_specs
from repro_torch.models.ssm import (_st_write, apply_mamba2, apply_rwkv6,
                                    mamba2_dims, mamba2_specs, rwkv6_dims,
                                    rwkv6_specs)
from repro_torch.parallel.sharding import (add_in_place, constrain,
                                          is_dtensor, under_mesh, unshard)

Spec = L.Spec

__all__ = ["abstract_params", "apply_model", "build_specs", "cache_axes",
           "cache_shapes", "check_paged_support", "encode", "init_cache",
           "init_params", "params_logical_axes"]


def check_paged_support(cfg: ArchConfig) -> None:
    """Raise ValueError unless every layer of ``cfg`` is paged-decodable:
    ``mixer="attn"`` with ``attn_kind="full"``, causal, and a dense MLP."""
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


# ============================================================================
# parameter specs
# ============================================================================


def _layer_specs(cfg: ArchConfig, spec: LayerSpec) -> Dict[str, Any]:
    D = cfg.d_model
    s: Dict[str, Any] = {}
    if spec.mixer == "attn":
        s["norm1"] = Spec((D,), ("embed",), "zeros")
        s["attn"] = attn_specs(cfg, spec.attn_kind)
        if cfg.post_norms:
            s["post_norm1"] = Spec((D,), ("embed",), "zeros")
    elif spec.mixer == "mamba2":
        s["norm1"] = Spec((D,), ("embed",), "zeros")
        s["mamba"] = mamba2_specs(cfg)
    elif spec.mixer == "rwkv6":
        s["norm1"] = Spec((D,), ("embed",), "zeros")
        s["norm_cm"] = Spec((D,), ("embed",), "zeros")
        s["rwkv"] = rwkv6_specs(cfg)
    if spec.mlp == "dense":
        s["norm2"] = Spec((D,), ("embed",), "zeros")
        s["mlp"] = L.mlp_specs(D, cfg.d_ff, cfg.act)
        if cfg.post_norms:
            s["post_norm2"] = Spec((D,), ("embed",), "zeros")
    elif spec.mlp == "moe":
        s["norm2"] = Spec((D,), ("embed",), "zeros")
        s["moe"] = moe_specs(cfg)
    return s


def _groups_specs(cfg: ArchConfig, groups) -> Dict[str, Any]:
    return {f"g{gi}": {f"p{pi}": L.stack_specs(_layer_specs(cfg, ls),
                                               g.repeats)
                       for pi, ls in enumerate(g.pattern)}
            for gi, g in enumerate(groups)}


def build_specs(cfg: ArchConfig) -> Dict[str, Any]:
    D, V = cfg.d_model, cfg.vocab_padded
    specs: Dict[str, Any] = {
        "embed": Spec((V, D), ("vocab", "embed"), "normal", 1.0),
        "final_norm": Spec((D,), ("embed",), "zeros"),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = Spec((D, V), ("embed", "vocab"))
    specs["groups"] = _groups_specs(cfg, cfg.groups)
    if any(ls.shared_attn for g in cfg.groups for ls in g.pattern):
        specs["shared_attn"] = {
            "norm": Spec((D,), ("embed",), "zeros"),
            "attn": attn_specs(cfg, "full"),
        }
    if cfg.encoder_groups:
        specs["encoder"] = {
            "groups": _groups_specs(cfg, cfg.encoder_groups),
            "final_norm": Spec((D,), ("embed",), "zeros"),
            "pos_embed": Spec((cfg.n_frontend_tokens, D), ("seq", "embed"),
                              "normal", 1.0)}
    if cfg.mtp:
        specs["mtp"] = {
            "norm_h": Spec((D,), ("embed",), "zeros"),
            "norm_e": Spec((D,), ("embed",), "zeros"),
            "proj": Spec((2 * D, D), ("embed2", "embed")),
            "layer": _layer_specs(cfg, LayerSpec(mixer="attn",
                                                 attn_kind="full",
                                                 mlp="dense")),
        }
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


def abstract_params(cfg: ArchConfig):
    """The parameter tree as ``meta`` tensors (no allocation)."""
    return L.abstract(build_specs(cfg))


def params_logical_axes(cfg: ArchConfig):
    """The parameter tree's logical axes (``parallel/sharding.py``)."""
    return L.axes_tree(build_specs(cfg))


# ============================================================================
# caches
# ============================================================================


def _layer_cache_spec(cfg: ArchConfig, spec: LayerSpec, batch: int,
                      seq: int) -> Dict[str, Tuple[int, ...]]:
    Hkv, hd = cfg.n_kv_heads, cfg.head_dim_
    out: Dict[str, Tuple[int, ...]] = {}
    if spec.mixer == "attn":
        if spec.attn_kind == "mla":
            out["ckv"] = (batch, seq, cfg.mla.kv_lora_rank)
            out["k_rope"] = (batch, seq, cfg.mla.qk_rope_head_dim)
        else:
            # cross: the K/V of the frontend's T tokens, not of the sequence
            t = cfg.n_frontend_tokens if spec.attn_kind == "cross" else seq
            out["k"] = (batch, t, Hkv, hd)
            out["v"] = (batch, t, Hkv, hd)
    elif spec.mixer == "mamba2":
        d_inner, nh, ds, dc = mamba2_dims(cfg)
        out["conv"] = (batch, dc - 1, d_inner + 2 * ds)
        out["ssm"] = (batch, nh, ds, cfg.ssm.head_dim)
    elif spec.mixer == "rwkv6":
        H, hd6 = rwkv6_dims(cfg)
        out["state"] = (batch, H, hd6, hd6)
        out["tm_shift"] = (batch, cfg.d_model)
        out["cm_shift"] = (batch, cfg.d_model)
    if spec.shared_attn:
        out["shared_k"] = (batch, seq, Hkv, hd)
        out["shared_v"] = (batch, seq, Hkv, hd)
    return out


# each cache leaf's logical axes (``parallel/sharding.py``), per layer
_CACHE_AXES = {
    "ckv": ("batch", "kv_seq", None), "k_rope": ("batch", "kv_seq", None),
    "k": ("batch", "kv_seq", "kv_heads", None),
    "v": ("batch", "kv_seq", "kv_heads", None),
    "conv": ("batch", None, "mlp_state"), "ssm": ("batch", "heads", None, None),
    "state": ("batch", "heads", None, None), "tm_shift": ("batch", None),
    "cm_shift": ("batch", None),
    "shared_k": ("batch", "kv_seq", "kv_heads", None),
    "shared_v": ("batch", "kv_seq", "kv_heads", None),
}
# cross attention caches the frontend's T tokens: no kv_seq axis
_CROSS_AXES = ("batch", None, "kv_heads", None)


def cache_axes(cfg: ArchConfig):
    """The logical axes of :func:`cache_shapes`' tree (the reference's
    second return value of its ``cache_shapes``), stacked over each
    group's repeats."""
    groups: Dict[str, Any] = {}
    for gi, g in enumerate(cfg.groups):
        pat = {}
        for pi, ls in enumerate(g.pattern):
            names = _layer_cache_spec(cfg, ls, 1, 1)
            cross = ls.mixer == "attn" and ls.attn_kind == "cross"
            if names:
                pat[f"p{pi}"] = {
                    n: ("layers",) + (_CROSS_AXES if cross and n in ("k", "v")
                                      else _CACHE_AXES[n]) for n in names}
        groups[f"g{gi}"] = pat
    return {"pos": ("batch",), "groups": groups}


def cache_shapes(cfg: ArchConfig, batch: int, seq: int, dtype="bfloat16"):
    """``{"pos": ((batch,), int32), "groups": {g: {p: {name: (shape,
    dtype)}}}}`` for the decode cache, stacked over each group's repeats.
    State arrays are f32 (ssm/rwkv states); K/V, conv and shifts are
    ``dtype``."""
    dt = L.torch_dtype(dtype)
    groups: Dict[str, Any] = {}
    for gi, g in enumerate(cfg.groups):
        pat = {}
        for pi, ls in enumerate(g.pattern):
            lc = {name: ((g.repeats,) + shape,
                         torch.float32 if name in ("ssm", "state") else dt)
                  for name, shape in _layer_cache_spec(cfg, ls, batch,
                                                       seq).items()}
            if lc:
                pat[f"p{pi}"] = lc
        groups[f"g{gi}"] = pat
    return {"pos": ((batch,), torch.int32), "groups": groups}


def init_cache(cfg: ArchConfig, batch: int, seq: int, dtype="bfloat16",
               device=None):
    """A zero decode cache on ``device`` (``cuda`` unless given)."""
    device = torch.device(device if device is not None else "cuda")

    def zeros(t):
        if isinstance(t, dict):
            return {k: zeros(v) for k, v in t.items()}
        return torch.zeros(t[0], dtype=t[1], device=device)

    return zeros(cache_shapes(cfg, batch, seq, dtype))


# ============================================================================
# forward
# ============================================================================


def _zero_aux(device) -> Dict[str, torch.Tensor]:
    return {"moe_aux": torch.zeros((), device=device),
            "moe_z": torch.zeros((), device=device)}


def _save_unbatched_dots(ctx, op, *args, **kwargs):
    """``remat="dots"``: save the outputs of un-batched matrix products,
    recompute everything else (``checkpoint_dots_with_no_batch_dims``)."""
    from torch.utils.checkpoint import CheckpointPolicy
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(cfg: ArchConfig, fn):
    """``fn`` under ``cfg.remat``: ``"none"`` as it is; ``"full"`` saves
    only its inputs and recomputes the rest in the backward; ``"dots"``
    saves the un-batched matrix products' outputs too."""
    if cfg.remat == "none":
        return fn
    if cfg.remat not in ("dots", "full"):
        raise ValueError(f"remat must be none, dots or full, got "
                         f"{cfg.remat!r}")
    from torch.utils.checkpoint import (checkpoint,
                                        create_selective_checkpoint_contexts)
    kw = {}
    if cfg.remat == "dots":
        kw["context_fn"] = lambda: create_selective_checkpoint_contexts(
            _save_unbatched_dots)

    def wrapped(*args):
        if not torch.is_grad_enabled():     # nothing is saved to recompute
            return fn(*args)
        return checkpoint(fn, *args, use_reentrant=False, **kw)

    return wrapped


def unstack(gp) -> List[Any]:
    """Each repeat's weights as views into stacked (group) params, cut by
    one ``unbind`` per leaf (in train mode, one gradient buffer per leaf
    in the backward)."""
    if not isinstance(gp, dict):
        return list(gp.unbind(0))
    per = {k: unstack(v) for k, v in gp.items()}
    return [dict(zip(per, rep)) for rep in zip(*per.values())]


_STREAM = ("batch", None, None)    # the residual stream's logical layout
_LOGITS = ("batch", None, "vocab")  # the logits' logical layout


def _residual(x, o):
    """``x + o``, and under a mesh the sum pinned to the residual stream's
    layout (batch over the FSDP axes, whole over ``model``), its gradient
    too: a sublayer's row-parallel output is summed over ``model`` here,
    once, so the next sublayer's products run column-parallel on each
    rank's own weights (left alone, the sharding propagation defers the sum
    and gathers whole weights instead, redoing each product on every
    ``model`` rank).  Where no gradient is taken the sum is written into
    x's buffer, ``o`` all-reduced in place first (``add_in_place``): a
    forward holds the stream once, as the reference's program updates it,
    whatever references to it the callers still keep."""
    if not (torch.is_grad_enabled() and (x.requires_grad or o.requires_grad)):
        s = add_in_place(constrain(x, _STREAM), o)
        if s is not None:
            return s
    return constrain(x + o, _STREAM)


def _post_norm(o, scale, cfg):
    """A post-norm of a sublayer's output; under a mesh the output is
    pinned to the stream's layout first, so the norm (not linear in it)
    meets a sum, not a ``Partial`` one, in both passes.  It feeds the
    whole stream, so its scale is gathered (decode leaves it where it
    lies: :func:`_at_use`)."""
    return L.rms_norm(constrain(o, _STREAM), unshard(scale), cfg.norm_eps)


_EXPERTS = ("wi_gate", "wi_up", "wo")    # a "moe" block's expert weights


def _at_use(tree, mode: str, key: str = ""):
    """One repeat's weights as its products use them: FSDP's gather at use
    (``unshard``), except where a product uses a weight where it lies --
    the MoE's experts (``models/moe.py`` lays them out itself) and, in
    decode, every weight: a matrix's product moves the token, not the
    weight (``layers.linear``), and a vector (a pre-norm's scale, RWKV-6's
    ``mu``) meets the token on the rank's slice of the embed dim, the
    slice that product takes, or is gathered by its use where it meets
    the whole row or rows sharded over its axis (``sharding.along_last``,
    ``layers.rms_norm``, :func:`_post_norm`)."""
    if isinstance(tree, dict):
        return {k: (v if key == "moe" and k in _EXPERTS
                    else _at_use(v, mode, k)) for k, v in tree.items()}
    if mode == "decode":
        return tree
    return unshard(tree)


def _apply_layer(lp, spec: LayerSpec, x, aux, *, cfg, mode, lcache, pos,
                 kv_source, shared_params, layer_idx=None, impl=None):
    """One pattern-position layer.  Returns (x, new_lcache, aux), the MoE
    losses added to ``aux``.  A sublayer's normed input goes straight into
    it and its output is dropped after the residual sum: no name here
    keeps either past its use (without a gradient nothing else does)."""
    new_cache: Dict[str, Any] = {}

    if spec.mixer == "attn":
        o, c = apply_attn(lp["attn"], L.rms_norm(x, lp["norm1"], cfg.norm_eps),
                          cfg=cfg, kind=spec.attn_kind,
                          mode=mode, cache=lcache if lcache else None,
                          pos=pos, kv_source=kv_source, causal=spec.causal,
                          layer_idx=layer_idx, impl=impl)
        if cfg.post_norms:
            o = _post_norm(o, lp["post_norm1"], cfg)
        x = _residual(x, o)
        del o
        if c:
            new_cache.update(c)
    elif spec.mixer == "mamba2":
        o, c = apply_mamba2(lp["mamba"],
                            L.rms_norm(x, lp["norm1"], cfg.norm_eps),
                            cfg=cfg, mode=mode,
                            cache=lcache if lcache else None,
                            layer_idx=layer_idx, impl=impl)
        x = _residual(x, o)
        del o
        if c:
            new_cache.update(c)
    elif spec.mixer == "rwkv6":
        h = L.rms_norm(x, lp["norm1"], cfg.norm_eps)
        tm_out, cm_fn, c = apply_rwkv6(lp["rwkv"], h, cfg=cfg, mode=mode,
                                       cache=lcache if lcache else None,
                                       layer_idx=layer_idx, impl=impl)
        x = _residual(x, tm_out)
        hc = L.rms_norm(x, lp["norm_cm"], cfg.norm_eps)
        cm_out, cm_shift = cm_fn(hc)
        x = _residual(x, cm_out)
        if c is not None:
            new_cache.update(c)
            if mode == "decode":
                new_cache["cm_shift"] = _st_write(lcache["cm_shift"],
                                                  layer_idx, cm_shift)
            else:
                new_cache["cm_shift"] = cm_shift

    if spec.shared_attn:
        scache = None
        if lcache and "shared_k" in lcache:
            scache = {"k": lcache["shared_k"], "v": lcache["shared_v"]}
        o, c = apply_attn(shared_params["attn"],
                          L.rms_norm(x, shared_params["norm"], cfg.norm_eps),
                          cfg=cfg, kind="full",
                          mode=mode, cache=scache, pos=pos,
                          layer_idx=layer_idx, impl=impl)
        x = _residual(x, o)
        del o
        if c:
            new_cache["shared_k"] = c["k"]
            new_cache["shared_v"] = c["v"]

    if spec.mlp == "dense":
        o = L.mlp_apply(lp["mlp"], L.rms_norm(x, lp["norm2"], cfg.norm_eps),
                        cfg.act)
        if cfg.post_norms:
            o = _post_norm(o, lp["post_norm2"], cfg)
        x = _residual(x, o)
    elif spec.mlp == "moe":
        o, a = apply_moe(lp["moe"], L.rms_norm(x, lp["norm2"], cfg.norm_eps),
                         cfg=cfg)
        aux = {k: aux[k] + a[k] for k in aux}
        x = _residual(x, o)

    return x, new_cache, aux


def _run_groups(groups_params, groups_def, x, *, cfg, mode, cache, pos,
                kv_source, shared_params, impl=None):
    aux = _zero_aux(x.device)
    new_cache: Dict[str, Any] = {}
    for gi, g in enumerate(groups_def):
        gc = cache["groups"][f"g{gi}"] if cache is not None else None
        n_rep = g.repeats
        # prefill writes each repeat's cache, laid out as decode reads it,
        # into the group's stacked cache as the layer produces it: (local
        # buffer, a layer's tensor)
        produced: Dict[str, Dict[str, tuple]] = {}
        axes = cache_axes(cfg)["groups"][f"g{gi}"] if mode == "prefill" \
            else None

        # g, gc and produced bound now: under remat the backward's
        # recompute calls this after the loop has moved on
        def repeat(x, aux, lp, rep, g=g, gc=gc, produced=produced,
                   axes=axes):
            x = constrain(x, _STREAM)
            lp, shared = _at_use(lp, mode), _at_use(shared_params, mode)
            for pi, ls in enumerate(g.pattern):
                key = f"p{pi}"
                # decode writes the STACKED cache at [layer, ...] in place
                decode = mode == "decode"
                x, nc, aux = _apply_layer(
                    lp[key], ls, x, aux, cfg=cfg, mode=mode,
                    lcache=gc.get(key) if decode else None, pos=pos,
                    kv_source=kv_source, shared_params=shared,
                    layer_idx=rep if decode else None, impl=impl)
                if mode == "prefill" and nc:
                    per = produced.setdefault(key, {})
                    for name, t in nc.items():
                        t = constrain(t, axes[key][name][1:])
                        buf, _ = per.get(name, (None, None))
                        per[name] = (_write_layer(buf, t, rep, n_rep), t)
            return x, aux

        # train: each repeat one call under cfg.remat, its weight slices
        # passed in as inputs (the shared block and kv_source are read from
        # the closure)
        body = _remat(cfg, repeat) if mode == "train" else repeat
        for rep, lp in enumerate(unstack(groups_params[f"g{gi}"])):
            x, aux = body(x, aux, lp, rep)
        if mode == "decode":
            new_cache[f"g{gi}"] = gc
        elif mode == "prefill":
            new_cache[f"g{gi}"] = {
                key: {name: _stacked(buf, t) for name, (buf, t) in per.items()}
                for key, per in produced.items()}
    return x, new_cache, aux


def _write_layer(buf, t, rep: int, n: int):
    """Layer ``rep`` of ``n``'s cache leaf ``t`` (a rank's local shard of
    a DTensor) written into ``buf``, its stacked ``(n, ...)`` buffer,
    allocated at the first layer: the cache is held once, as the
    reference's scan carries it, not as ``n`` layers' tensors and their
    stacked copy at once."""
    local = t.to_local() if is_dtensor(t) else t
    if buf is None:
        buf = local.new_empty((n,) + tuple(local.shape))
    buf[rep].copy_(local)
    return buf


def _stacked(buf, like):
    """The stacked buffer as the tensor ``torch.stack`` of the layers
    would give: a DTensor laid out as a layer's tensor ``like``, its
    layer dim whole."""
    if not is_dtensor(like):
        return buf
    from torch.distributed.tensor import DTensor, Shard
    shape = torch.Size((buf.shape[0],) + tuple(like.shape))
    pl = [Shard(p.dim + 1) if isinstance(p, Shard) else p
          for p in like.placements]
    stride = tuple(math.prod(shape[d + 1:]) for d in range(len(shape)))
    return DTensor.from_local(buf, like.device_mesh, pl, run_check=False,
                              shape=shape, stride=stride)


def encode(params: Dict[str, Any], frontend: torch.Tensor, *,
           cfg: ArchConfig, impl: Optional[str] = None) -> torch.Tensor:
    """Enc-dec (whisper): the encoder groups in train mode over the stub
    frontend embeddings (B, n_frontend_tokens, D) plus ``pos_embed``, then
    ``encoder/final_norm``: the cross layers' ``kv_source``."""
    dt = L.torch_dtype(cfg.dtype)
    enc = params["encoder"]
    pe = unshard(enc["pos_embed"])
    h = frontend.to(pe.device, dt) + pe[None].to(dt)
    h, _, _ = _run_groups(enc["groups"], cfg.encoder_groups, h, cfg=cfg,
                          mode="train", cache=None, pos=None, kv_source=None,
                          shared_params=None, impl=impl)
    return L.rms_norm(h, unshard(enc["final_norm"]), cfg.norm_eps)


@under_mesh
def apply_model(
    params: Dict[str, Any],
    tokens: torch.Tensor,                   # (B, S) integer
    *,
    cfg: ArchConfig,
    mode: str = "train",
    cache: Optional[Dict[str, Any]] = None,
    frontend: Optional[torch.Tensor] = None,   # (B, T, D) stub embeddings
    impl: Optional[str] = None,
) -> Tuple[torch.Tensor, Optional[Dict[str, Any]], Dict[str, torch.Tensor]]:
    """``frontend``: the frontend's token embeddings for train/prefill (the
    encoder's input for enc-dec, the cross layers' keys as they are for a
    VLM); decode ignores it.  ``impl`` picks the kernels' implementation
    (``kernels/ops.py``): the CUDA kernels for CUDA tensors and the plain
    versions on the CPU unless given."""
    dt = L.torch_dtype(cfg.dtype)
    dev = params["embed"].device
    tokens = tokens.to(dev)
    x = L.embed_lookup(params["embed"], tokens,
                       stationary=mode == "decode").to(dt)
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=dt)
    x = constrain(x, _STREAM)

    pos = cache["pos"] if (cache is not None and mode == "decode") else None

    kv_source = None
    if cfg.encoder_groups and mode != "decode":
        kv_source = encode(params, frontend, cfg=cfg, impl=impl)
    elif frontend is not None and mode != "decode":
        kv_source = frontend.to(dev, dt)     # vlm: pre-projected image tokens

    x, new_cache, aux = _run_groups(params["groups"], cfg.groups, x, cfg=cfg,
                               mode=mode, cache=cache if mode == "decode"
                               else None, pos=pos, kv_source=kv_source,
                               shared_params=params.get("shared_attn"),
                               impl=impl)

    x = L.rms_norm(x, _at_use(params["final_norm"], mode), cfg.norm_eps)
    if cfg.mtp and mode == "train":
        aux["mtp_hidden"] = x     # the MTP head's input, for the loss
    if mode == "prefill":
        # only the last position's logits are needed: slice BEFORE the head
        # product, so no (B, S, V) tensor materialises
        x = x[:, -1:]
    head = params.get("lm_head")
    if head is None:
        head = params["embed"].T
    logits = L.linear(x, head if mode == "decode" else unshard(head))
    logits = L.softcap(logits, cfg.logit_softcap)
    if cfg.vocab_padded != cfg.vocab:
        pad = torch.arange(cfg.vocab_padded, device=dev) >= cfg.vocab
        logits = logits.masked_fill(pad, -1e30)
    logits = constrain(logits, _LOGITS)

    out_cache = None
    if mode == "decode":
        out_cache = {"pos": cache["pos"] + 1, "groups": new_cache}
    elif mode == "prefill":
        B, S = tokens.shape
        out_cache = {"pos": torch.full((B,), S, dtype=torch.int32,
                                       device=dev),
                     "groups": new_cache}
    return logits, out_cache, aux
