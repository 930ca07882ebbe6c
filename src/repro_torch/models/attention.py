"""Attention: GQA with full or sliding-window (``local``) masks.

``apply_attn`` handles three modes:
  train/prefill: full-sequence attention through the flash kernel
                 (``kernels/flash_attention.py``; its plain version on the
                 CPU)
  decode:        one query token against a KV cache written at ``pos``

Cache layout (batch-major, stacked over layer repeats by the caller):
  full/local: {"k": (B,S,Hkv,D), "v": (B,S,Hkv,Dv)}

Decode writes the new token INTO the stacked cache tensors, in place; the
reference returns new arrays instead.  MLA and cross attention come with
their own slices of the port and raise here.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.layers import Spec, apply_rope, rms_norm

_MLA = ("MLA attention (DeepSeek-V3) is not ported yet: it comes with the "
        "MLA slice of the port")
_CROSS = ("cross attention (VLM image tokens, enc-dec) is not ported yet: it "
          "comes with the cross-attention/encoder slice of the port")


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
    if kind == "mla":
        raise NotImplementedError(_MLA)
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
    kind: str,                             # full | local
    mode: str,                             # train | prefill | decode
    cache: Optional[Dict[str, torch.Tensor]] = None,
    pos: Optional[torch.Tensor] = None,    # (B,) decode positions
    causal: bool = True,
    layer_idx=None,                # decode: index into the STACKED cache
    impl: Optional[str] = None,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    if kind == "mla":
        raise NotImplementedError(_MLA)
    if kind == "cross":
        raise NotImplementedError(_CROSS)
    B, S, D = x.shape
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    window = cfg.window if kind == "local" else 0
    scale = _attn_scale(cfg, hd)
    dt = x.dtype

    # plain products on views of the (D, heads, hd) weights, cast to the
    # compute dtype as jnp's type promotion does
    q = (x @ p["wq"].to(dt).flatten(1)).view(B, S, H, hd)
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
