"""Model assembly: embeddings -> layer groups -> norm -> logits.

The reference's one forward, :func:`apply_model`, for the architectures
whose layers this package has: GQA attention (full and sliding window),
Mamba2, RWKV-6, zamba2's weight-tied shared attention block, and the
dense MLP.  MoE, MLA, cross attention, the encoder and the MTP head come
with their own slices of the port and raise :class:`NotImplementedError`
naming them.

Modes:
  train:   full-seq forward (a forward only here); returns (logits, None, aux)
  prefill: full-seq forward, returns (last-position logits, cache)
  decode:  one token per sequence against the cache, returns (logits, cache)

The layer groups run as a Python loop over the pattern repeats (the
reference's ``scan``/``fori_loop``), weights stacked on a leading
"layers" axis.  Decode writes each layer's new token and states INTO the
stacked cache tensors at the layer index -- in place, where the reference
returns new arrays -- so a caller that needs the cache as it was must
clone it first.

The parameter tree keeps the reference's key layout (``embed``,
``final_norm``, ``lm_head``, ``groups/g{gi}/p{pi}/...`` stacked over
repeats, ``shared_attn/{norm, attn}``) so weights bridge 1:1.
:func:`check_paged_support` says which configs the paged serving path
(``serve/paged_model.py``) takes.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig, LayerSpec
from repro_torch.models import layers as L
from repro_torch.models.attention import _CROSS, _MLA, apply_attn, attn_specs
from repro_torch.models.ssm import (_st_write, apply_mamba2, apply_rwkv6,
                                    mamba2_dims, mamba2_specs, rwkv6_dims,
                                    rwkv6_specs)

Spec = L.Spec

__all__ = ["apply_model", "build_specs", "cache_shapes", "check_paged_support",
           "init_cache", "init_params"]

_MOE = ("MoE layers (models/moe.py) are not ported yet: they come with the "
        "MoE slice of the port")
_ENCODER = ("encoder groups (enc-dec, whisper) are not ported yet: they come "
            "with the cross-attention/encoder slice of the port")
_MTP = ("the multi-token-prediction head is not ported yet: it comes with the "
        "training slice of the port")


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
        if spec.attn_kind == "cross":
            raise NotImplementedError(_CROSS)
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
        raise NotImplementedError(_MOE)
    return s


def build_specs(cfg: ArchConfig) -> Dict[str, Any]:
    if cfg.encoder_groups:
        raise NotImplementedError(_ENCODER)
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
    if cfg.mtp:
        raise NotImplementedError(_MTP)
    if any(ls.shared_attn for g in cfg.groups for ls in g.pattern):
        specs["shared_attn"] = {
            "norm": Spec((D,), ("embed",), "zeros"),
            "attn": attn_specs(cfg, "full"),
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


# ============================================================================
# caches
# ============================================================================


def _layer_cache_spec(cfg: ArchConfig, spec: LayerSpec, batch: int,
                      seq: int) -> Dict[str, Tuple[int, ...]]:
    Hkv, hd = cfg.n_kv_heads, cfg.head_dim_
    out: Dict[str, Tuple[int, ...]] = {}
    if spec.mixer == "attn":
        if spec.attn_kind in ("mla", "cross"):
            raise NotImplementedError(_MLA if spec.attn_kind == "mla"
                                      else _CROSS)
        out["k"] = (batch, seq, Hkv, hd)
        out["v"] = (batch, seq, Hkv, hd)
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


def layer_params(gp, rep: int):
    """One repeat's weights: views into stacked (group) params."""
    if isinstance(gp, dict):
        return {k: layer_params(v, rep) for k, v in gp.items()}
    return gp[rep]


def _apply_layer(lp, spec: LayerSpec, x, *, cfg, mode, lcache, pos,
                 shared_params, layer_idx=None, impl=None):
    """One pattern-position layer.  Returns (x, new_lcache)."""
    new_cache: Dict[str, Any] = {}

    if spec.mixer == "attn":
        h = L.rms_norm(x, lp["norm1"], cfg.norm_eps)
        o, c = apply_attn(lp["attn"], h, cfg=cfg, kind=spec.attn_kind,
                          mode=mode, cache=lcache if lcache else None,
                          pos=pos, causal=spec.causal, layer_idx=layer_idx,
                          impl=impl)
        if cfg.post_norms:
            o = L.rms_norm(o, lp["post_norm1"], cfg.norm_eps)
        x = x + o
        if c:
            new_cache.update(c)
    elif spec.mixer == "mamba2":
        h = L.rms_norm(x, lp["norm1"], cfg.norm_eps)
        o, c = apply_mamba2(lp["mamba"], h, cfg=cfg, mode=mode,
                            cache=lcache if lcache else None,
                            layer_idx=layer_idx, impl=impl)
        x = x + o
        if c:
            new_cache.update(c)
    elif spec.mixer == "rwkv6":
        h = L.rms_norm(x, lp["norm1"], cfg.norm_eps)
        tm_out, cm_fn, c = apply_rwkv6(lp["rwkv"], h, cfg=cfg, mode=mode,
                                       cache=lcache if lcache else None,
                                       layer_idx=layer_idx, impl=impl)
        x = x + tm_out
        hc = L.rms_norm(x, lp["norm_cm"], cfg.norm_eps)
        cm_out, cm_shift = cm_fn(hc)
        x = x + cm_out
        if c is not None:
            new_cache.update(c)
            if mode == "decode":
                new_cache["cm_shift"] = _st_write(lcache["cm_shift"],
                                                  layer_idx, cm_shift)
            else:
                new_cache["cm_shift"] = cm_shift

    if spec.shared_attn:
        h = L.rms_norm(x, shared_params["norm"], cfg.norm_eps)
        scache = None
        if lcache and "shared_k" in lcache:
            scache = {"k": lcache["shared_k"], "v": lcache["shared_v"]}
        o, c = apply_attn(shared_params["attn"], h, cfg=cfg, kind="full",
                          mode=mode, cache=scache, pos=pos,
                          layer_idx=layer_idx, impl=impl)
        x = x + o
        if c:
            new_cache["shared_k"] = c["k"]
            new_cache["shared_v"] = c["v"]

    if spec.mlp == "dense":
        h = L.rms_norm(x, lp["norm2"], cfg.norm_eps)
        o = L.mlp_apply(lp["mlp"], h, cfg.act)
        if cfg.post_norms:
            o = L.rms_norm(o, lp["post_norm2"], cfg.norm_eps)
        x = x + o
    elif spec.mlp == "moe":
        raise NotImplementedError(_MOE)

    return x, new_cache


def _run_groups(groups_params, groups_def, x, *, cfg, mode, cache, pos,
                shared_params, impl=None):
    new_cache: Dict[str, Any] = {}
    for gi, g in enumerate(groups_def):
        gp = groups_params[f"g{gi}"]
        gc = cache["groups"][f"g{gi}"] if cache is not None else None
        # prefill collects each repeat's cache and stacks it at the end
        produced: Dict[str, Dict[str, list]] = {}
        for rep in range(g.repeats):
            lp = layer_params(gp, rep)
            for pi, ls in enumerate(g.pattern):
                key = f"p{pi}"
                if mode == "decode":
                    # the STACKED cache is written at [layer, ...] in place
                    x, _ = _apply_layer(
                        lp[key], ls, x, cfg=cfg, mode=mode, lcache=gc.get(key),
                        pos=pos, shared_params=shared_params, layer_idx=rep,
                        impl=impl)
                    continue
                x, nc = _apply_layer(
                    lp[key], ls, x, cfg=cfg, mode=mode, lcache=None, pos=pos,
                    shared_params=shared_params, impl=impl)
                if mode == "prefill" and nc:
                    per = produced.setdefault(key, {})
                    for name, t in nc.items():
                        per.setdefault(name, []).append(t)
        if mode == "decode":
            new_cache[f"g{gi}"] = gc
        elif mode == "prefill":
            new_cache[f"g{gi}"] = {
                key: {name: torch.stack(ts) for name, ts in per.items()}
                for key, per in produced.items()}
    return x, new_cache


def apply_model(
    params: Dict[str, Any],
    tokens: torch.Tensor,                   # (B, S) integer
    *,
    cfg: ArchConfig,
    mode: str = "train",
    cache: Optional[Dict[str, Any]] = None,
    impl: Optional[str] = None,
) -> Tuple[torch.Tensor, Optional[Dict[str, Any]], Dict[str, torch.Tensor]]:
    """``impl`` picks the kernels' implementation (``kernels/ops.py``): the
    CUDA kernels for CUDA tensors and the plain versions on the CPU unless
    given."""
    if cfg.encoder_groups:
        raise NotImplementedError(_ENCODER)
    dt = L.torch_dtype(cfg.dtype)
    dev = params["embed"].device
    tokens = tokens.to(dev)
    x = params["embed"][tokens.long()].to(dt)
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=dt)

    pos = cache["pos"] if (cache is not None and mode == "decode") else None
    x, new_cache = _run_groups(params["groups"], cfg.groups, x, cfg=cfg,
                               mode=mode, cache=cache if mode == "decode"
                               else None, pos=pos,
                               shared_params=params.get("shared_attn"),
                               impl=impl)

    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    if mode == "prefill":
        # only the last position's logits are needed: slice BEFORE the head
        # product, so no (B, S, V) tensor materialises
        x = x[:, -1:]
    head = params.get("lm_head")
    if head is None:
        head = params["embed"].T
    logits = x @ head.to(dt)
    logits = L.softcap(logits, cfg.logit_softcap)
    if cfg.vocab_padded != cfg.vocab:
        pad = torch.arange(cfg.vocab_padded, device=dev) >= cfg.vocab
        logits = logits.masked_fill(pad, -1e30)

    out_cache = None
    if mode == "decode":
        out_cache = {"pos": cache["pos"] + 1, "groups": new_cache}
    elif mode == "prefill":
        B, S = tokens.shape
        out_cache = {"pos": torch.full((B,), S, dtype=torch.int32,
                                       device=dev),
                     "groups": new_cache}
    return logits, out_cache, _zero_aux(dev)
