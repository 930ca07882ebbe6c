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
reference returns new arrays instead.  Under a mesh (``parallel/
sharding.py``) the flash kernel runs per rank on local shards, heads over
``model`` or, where the heads do not divide it, the query sequence
(context parallelism): :func:`_flash`.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.layers import Spec, apply_rope, rms_norm
from repro_torch.parallel import sharding as shlib

def _tp_size(mesh) -> int:
    return (shlib.axis_size(mesh, "model")
            if mesh is not None and "model" in shlib.axis_names(mesh) else 1)


def _flash(q, k, v, *, causal, window, softcap_v, scale, impl=None):
    """Full-sequence attention through the flash kernel.

    Under a mesh (DTensor q, k, v) every rank runs the kernel on its local
    shards, through ``local_map``: a kernel never sees a DTensor.  Batch
    goes over the FSDP axes and heads over ``model`` when the head counts
    divide it.  When they do not (starcoder2: 36H, whisper: 12H) the heads
    stay replicated, and each ``model`` rank takes a slice of the QUERY
    sequence instead (context parallelism, the reference's ``shard_map``
    branch): q padded to a multiple of tp, K and V replicated over
    ``model`` (no extra communication), the causal mask offset by the
    shard's position (the kernel's ``q_offset``), the pad cut after."""
    mesh = shlib.get_mesh()
    kw = dict(causal=causal, window=window, softcap=softcap_v, scale=scale,
              impl=impl)
    if mesh is None or not shlib.is_dtensor(q):
        return kops.flash_attention(q.contiguous(), k.contiguous(),
                                    v.contiguous(), **kw)
    tp = _tp_size(mesh)
    H, Hkv = q.shape[2], k.shape[2]

    pl = lambda dims, t: shlib.layout(mesh, dims, t)

    def kernel(qs, ks, vs, q_offset=0):
        return kops.flash_attention(qs.contiguous(), ks.contiguous(),
                                    vs.contiguous(), q_offset=q_offset, **kw)

    if tp == 1 or (H % tp == 0 and Hkv % tp == 0):
        qpl = pl(("batch", None, "heads", None), q)
        return shlib.local_map(kernel, qpl, (qpl, pl(("batch", None, "kv_heads",
                                                 None), k),
                                        pl(("batch", None, "kv_heads", None),
                                           v)))(q, k, v)

    B, S = q.shape[0], q.shape[1]
    pad = (-S) % tp
    Sp = S + pad
    s_local = Sp // tp
    bspec = shlib.spec_for(mesh, ("batch",), (B,))
    b = bspec[0] if bspec else None
    rep = list(shlib.placements(mesh, (b,)))
    cp = list(shlib.placements(mesh, (b, "model")))
    if pad:
        q = shlib.local_map(lambda qs: F.pad(qs, (0, 0, 0, 0, 0, pad)), rep,
                       (rep,))(q)

    def body(qs, ks, vs):
        return kernel(qs, ks, vs,
                      q_offset=mesh.get_local_rank("model") * s_local)

    kv_grad = shlib.partial_over(rep, cp)     # each shard's own queries
    out = shlib.local_map(body, cp, (cp, rep, rep),
                          (cp, kv_grad, kv_grad))(q, k, v)
    # the sequence whole again for the output projection (heads are not
    # sharded here): one all-gather over model
    out = out.redistribute(mesh, rep)
    return out[:, :S] if pad else out


def _decode(q, k, v, kv_len, **kw):
    """Decode attention of one query token over a KV cache.  Under a mesh
    whose ``model`` axis divides the heads but not the kv heads, the
    cache's ``kv_seq`` holds ``model`` and the query's heads cannot be
    grouped over the kv heads shard by shard: the query (one token) is
    read whole over ``model``, as it is where the heads do not divide, and
    the cache stays sharded over its sequence."""
    tp = _tp_size(shlib.get_mesh())
    if tp > 1 and shlib.is_dtensor(q) and k.shape[2] % tp:
        q = shlib.constrain(q, ("batch", None, None, None))
    return kops.decode_attention(q, k, v, kv_len, **kw)


def _cache_read(arr, idx):
    """Layer ``idx`` of a stacked cache leaf (None = unstacked): a view."""
    return arr if idx is None else arr[idx]


def _cache_write_token(arr, idx, pos, val):
    """Write one decoded token into a (stacked) KV cache leaf IN PLACE at
    ``pos[0]`` for every row: the dense decode assumes aligned positions,
    as the reference's uniform-position update does (ragged positions are
    the paged path's job).  The position stays on the device: no host
    sync per layer.  Returns ``arr``."""
    if shlib.is_dtensor(arr):
        return _cache_write_local(arr, idx, pos, val)
    dst = arr if idx is None else arr[idx]
    dst.index_copy_(1, pos[:1].long(), val.to(arr.dtype)[:, None])
    return arr


def _cache_write_local(arr, idx, pos, val):
    """:func:`_cache_write_token` into a DTensor cache, shard by shard.
    DTensor's own ``index_copy_`` into a shard of the sequence (the cache
    when the kv heads do not divide ``model``) writes a copy and drops
    it.  Here ``val`` is laid out as a cache row (the sequence dim left
    out) and each rank writes into its own shard; of the shards of the
    sequence only the one holding ``pos`` takes the token (a select on
    the device, no host sync)."""
    from torch.distributed.tensor import Replicate, Shard
    mesh, sd = arr.device_mesh, 1 if idx is None else 2
    vpl, chunk = [], 0
    for m, p in enumerate(arr.placements):
        if isinstance(p, Shard) and p.dim == sd:
            chunk = chunk * mesh.size(m) + mesh.get_local_rank(m)
            vpl.append(Replicate())
        elif isinstance(p, Shard):
            if p.dim < sd - 1:
                raise ValueError(f"cache sharded over its layers: {p}")
            vpl.append(Shard(p.dim - (sd - 1) - (p.dim > sd)))
        else:
            vpl.append(p)
    a = arr.to_local()
    dst = a if idx is None else a[idx]
    v = val.redistribute(mesh, vpl).to_local().to(a.dtype)[:, None]
    at = pos.to_local()[:1].long() - chunk * dst.shape[1]
    here = (at >= 0) & (at < dst.shape[1])
    at = at.clamp(0, dst.shape[1] - 1)
    dst.index_copy_(1, at, torch.where(here, v, dst.index_select(1, at)))
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
            out = _decode(q, k, v, kv_len, softcap=cfg.attn_softcap,
                          scale=scale)
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
        out = _decode(
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
