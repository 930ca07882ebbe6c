"""Attention variants: GQA (full / sliding-window), MLA (DeepSeek-V3
compressed-latent attention, with the absorbed decode path), and cross
attention (VLM image tokens / enc-dec).

``apply_attn`` handles three modes:
  train/prefill: full-sequence attention through the flash kernel
                 (``kernels/flash_attention.py``; its plain version on the
                 CPU): causal self attention, MLA's explicit form at
                 D = nope + rope over Dv = v_head_dim, and cross attention
                 (bidirectional, Sq != Sk) over ``kv_source``
  decode:        one query token against a KV cache written at ``pos``;
                 MLA scores the compressed cache directly, cross attention
                 reads the K/V its prefill cached and writes nothing

Cache layouts (all batch-major, stacked over layer repeats by the caller):
  full/local: {"k": (B,S,Hkv,D), "v": (B,S,Hkv,Dv)}
  mla:        {"ckv": (B,S,r_kv), "k_rope": (B,S,rope_dim)}   (compressed)
  cross:      {"k": (B,T,Hkv,D), "v": (B,T,Hkv,Dv)}           (precomputed)

Decode writes the new token INTO the stacked cache tensors, in place; the
reference returns new arrays instead.  (The reference's context-parallel
branch of ``_flash`` comes with the sharding slice.)
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.layers import Spec, apply_rope, rms_norm

def _flash(q, k, v, *, causal, window, softcap_v, scale, impl=None):
    """Full-sequence attention on one device.  (The reference's
    context-parallel branch for head counts that do not divide the model
    axis comes with the sharding slice.)"""
    return kops.flash_attention(q.contiguous(), k.contiguous(),
                                v.contiguous(), causal=causal, window=window,
                                softcap=softcap_v, scale=scale, impl=impl)


def _cache_read(arr, idx):
    """Layer ``idx`` of a stacked cache leaf (None = unstacked): a view."""
    return arr if idx is None else arr[idx]


def _cache_write_token(arr, idx, pos, val):
    """Write one decoded token into a (stacked) KV cache leaf IN PLACE at
    ``pos[0]`` for every row: the dense decode assumes aligned positions,
    as the reference's uniform-position update does (ragged positions are
    the paged path's job).  The position stays on the device: no host
    sync per layer.  Returns ``arr``."""
    dst = arr if idx is None else arr[idx]
    dst.index_copy_(1, pos[:1].long(), val.to(arr.dtype)[:, None])
    return arr


# ----------------------------------------------------------------------------
# specs
# ----------------------------------------------------------------------------


def attn_specs(cfg: ArchConfig, kind: str) -> Dict[str, Spec]:
    D, H, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    if kind == "mla":
        m = cfg.mla
        qk_dim = m.qk_nope_head_dim + m.qk_rope_head_dim
        return {
            "wq_a": Spec((D, m.q_lora_rank), ("embed", "q_lora")),
            "q_norm": Spec((m.q_lora_rank,), ("q_lora",), "zeros"),
            "wq_b": Spec((m.q_lora_rank, H, qk_dim),
                         ("q_lora", "heads", "head_dim")),
            "wkv_a": Spec((D, m.kv_lora_rank + m.qk_rope_head_dim),
                          ("embed", "kv_lora")),
            "kv_norm": Spec((m.kv_lora_rank,), ("kv_lora",), "zeros"),
            "wk_b": Spec((m.kv_lora_rank, H, m.qk_nope_head_dim),
                         ("kv_lora", "heads", "head_dim")),
            "wv_b": Spec((m.kv_lora_rank, H, m.v_head_dim),
                         ("kv_lora", "heads", "head_dim")),
            "wo": Spec((H, m.v_head_dim, D), ("heads", "head_dim", "embed")),
        }
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


# ----------------------------------------------------------------------------
# apply
# ----------------------------------------------------------------------------


def _attn_scale(cfg: ArchConfig, qk_dim: int) -> float:
    if cfg.attn_scale:
        return 1.0 / math.sqrt(cfg.attn_scale)
    return 1.0 / math.sqrt(qk_dim)


def apply_attn(
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,                       # (B, S, D) normed input
    *,
    cfg: ArchConfig,
    kind: str,                             # full | local | mla | cross
    mode: str,                             # train | prefill | decode
    cache: Optional[Dict[str, torch.Tensor]] = None,
    pos: Optional[torch.Tensor] = None,    # (B,) decode positions
    kv_source: Optional[torch.Tensor] = None,  # (B, T, D): cross train/prefill
    causal: bool = True,
    layer_idx=None,                # decode: index into the STACKED cache
    impl: Optional[str] = None,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    if kind == "mla":
        return _apply_mla(p, x, cfg=cfg, mode=mode, cache=cache, pos=pos,
                          layer_idx=layer_idx, impl=impl)
    B, S, D = x.shape
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    window = cfg.window if kind == "local" else 0
    scale = _attn_scale(cfg, hd)
    dt = x.dtype

    # plain products on views of the (D, heads, hd) weights, cast to the
    # compute dtype as jnp's type promotion does
    q = (x @ p["wq"].to(dt).flatten(1)).view(B, S, H, hd)
    if kind == "cross":
        if mode == "decode":
            # K/V were projected (and k normed) at prefill: norm q only
            k = _cache_read(cache["k"], layer_idx)
            v = _cache_read(cache["v"], layer_idx)
            if cfg.qk_norm:
                q = rms_norm(q, p["q_scale"], cfg.norm_eps)
            kv_len = torch.full((B,), k.shape[1], dtype=torch.int32,
                                device=x.device)
            out = kops.decode_attention(q, k, v, kv_len,
                                        softcap=cfg.attn_softcap, scale=scale)
            new_cache = cache
        else:
            T = kv_source.shape[1]
            k = (kv_source @ p["wk"].to(dt).flatten(1)).view(B, T, Hkv, hd)
            v = (kv_source @ p["wv"].to(dt).flatten(1)).view(B, T, Hkv, hd)
            if cfg.qk_norm:
                q = rms_norm(q, p["q_scale"], cfg.norm_eps)
                k = rms_norm(k, p["k_scale"], cfg.norm_eps)
            out = _flash(q, k, v, causal=False, window=0,
                         softcap_v=cfg.attn_softcap, scale=scale, impl=impl)
            new_cache = {"k": k, "v": v} if mode == "prefill" else None
        o = out.reshape(B, S, H * hd) @ p["wo"].to(dt).flatten(0, 1)
        return o, new_cache

    k = (x @ p["wk"].to(dt).flatten(1)).view(B, S, Hkv, hd)
    v = (x @ p["wv"].to(dt).flatten(1)).view(B, S, Hkv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_scale"], cfg.norm_eps)
        k = rms_norm(k, p["k_scale"], cfg.norm_eps)

    if mode == "decode":
        positions = pos[:, None]                       # (B,1)
        q = apply_rope(q, positions, cfg.rope_theta, cfg.rope_pct)
        k = apply_rope(k, positions, cfg.rope_theta, cfg.rope_pct)
        k_full = _cache_write_token(cache["k"], layer_idx, pos, k[:, 0])
        v_full = _cache_write_token(cache["v"], layer_idx, pos, v[:, 0])
        out = kops.decode_attention(
            q, _cache_read(k_full, layer_idx), _cache_read(v_full, layer_idx),
            pos + 1, window=window, softcap=cfg.attn_softcap, scale=scale)
        new_cache = {"k": k_full, "v": v_full}
    else:
        positions = torch.arange(S, device=x.device)[None]
        q = apply_rope(q, positions, cfg.rope_theta, cfg.rope_pct)
        k = apply_rope(k, positions, cfg.rope_theta, cfg.rope_pct)
        out = _flash(q, k, v, causal=causal, window=window,
                     softcap_v=cfg.attn_softcap, scale=scale, impl=impl)
        new_cache = {"k": k, "v": v} if mode == "prefill" else None
    o = out.reshape(B, S, H * hd) @ p["wo"].to(dt).flatten(0, 1)
    return o, new_cache


def _apply_mla(p, x, *, cfg, mode, cache, pos, layer_idx=None, impl=None):
    """DeepSeek-V3 multi-head latent attention.

    train/prefill: the explicit (decompressed) form through the flash
    kernel, K = [k_nope, the one shared k_rope head broadcast over H after
    its rotation] at D = nope + rope, V at v_head_dim.  decode: the
    ABSORBED form -- queries projected into the latent space score the
    compressed cache directly, in the reference's order of products (three
    separate contractions, f32 only inside the softmax).  The scale is
    1/sqrt(nope + rope), never ``cfg.attn_scale``; RoPE rotates the whole
    rope part (no ``rope_pct``)."""
    B, S, D = x.shape
    m, H = cfg.mla, cfg.n_heads
    nope, rope_d, vd = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim
    r = m.kv_lora_rank
    scale = 1.0 / math.sqrt(nope + rope_d)
    dt = x.dtype
    w = {k: v.to(dt) for k, v in p.items()
         if k in ("wq_a", "wq_b", "wkv_a", "wk_b", "wv_b", "wo")}

    ql = rms_norm(x @ w["wq_a"], p["q_norm"], cfg.norm_eps)
    q = (ql @ w["wq_b"].flatten(1)).view(B, S, H, nope + rope_d)
    q_nope, q_rope = q[..., :nope], q[..., nope:]

    kv_a = x @ w["wkv_a"]                              # (B,S,r_kv+rope)
    ckv = rms_norm(kv_a[..., :r], p["kv_norm"], cfg.norm_eps)
    k_rope = kv_a[..., r:]                             # (B,S,rope) shared head

    if mode == "decode":
        positions = pos[:, None]
        q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
        k_rope = apply_rope(k_rope[:, :, None], positions,
                            cfg.rope_theta)[:, :, 0]
        ckv_full = _cache_write_token(cache["ckv"], layer_idx, pos, ckv[:, 0])
        krope_full = _cache_write_token(cache["k_rope"], layer_idx, pos,
                                        k_rope[:, 0])
        ckv_c = _cache_read(ckv_full, layer_idx).to(dt)
        krope_c = _cache_read(krope_full, layer_idx).to(dt)
        # absorbed: q_lat = q_nope wk_b^T scores the compressed cache
        q_lat = torch.einsum("bshe,rhe->bshr", q_nope, w["wk_b"])  # (B,1,H,r)
        s = (torch.einsum("bshr,btr->bhst", q_lat, ckv_c) +
             torch.einsum("bshe,bte->bhst", q_rope, krope_c)) * scale
        t_idx = torch.arange(ckv_c.shape[1], device=x.device)[None]
        mask = t_idx <= pos[:, None].to(x.device)
        s = s.masked_fill(~mask[:, None, None], -1e30)
        pr = torch.softmax(s.float(), dim=-1).to(dt)
        ctx = torch.einsum("bhst,btr->bshr", pr, ckv_c)          # (B,1,H,r)
        out = torch.einsum("bshr,rhe->bshe", ctx, w["wv_b"])     # (B,1,H,vd)
        o = out.reshape(B, S, H * vd) @ w["wo"].flatten(0, 1)
        return o, {"ckv": ckv_full, "k_rope": krope_full}

    positions = torch.arange(S, device=x.device)[None]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    k_rope = apply_rope(k_rope[:, :, None], positions, cfg.rope_theta)[:, :, 0]
    k_nope = (ckv @ w["wk_b"].flatten(1)).view(B, S, H, nope)
    v = (ckv @ w["wv_b"].flatten(1)).view(B, S, H, vd)
    k = torch.cat([k_nope, k_rope[:, :, None].expand(B, S, H, rope_d)], -1)
    qf = torch.cat([q_nope, q_rope], dim=-1)
    out = _flash(qf, k, v, causal=True, window=0, softcap_v=0.0, scale=scale,
                 impl=impl)
    o = out.reshape(B, S, H * vd) @ w["wo"].flatten(0, 1)
    new_cache = {"ckv": ckv, "k_rope": k_rope} if mode == "prefill" else None
    return o, new_cache
