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
``model`` (:func:`_flash`) or, where the heads do not divide it, the
sequence, the projections around the kernel included (context
parallelism: :func:`_attn_seq`); decode attends on each rank's shard of
the cache (:func:`_decode`, :func:`_latent_attend`).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.layers import Spec, apply_rope, linear, rms_norm
from repro_torch.parallel import sharding as shlib

def _tp_size(mesh) -> int:
    return (shlib.axis_size(mesh, "model")
            if mesh is not None and "model" in shlib.axis_names(mesh) else 1)


def head_layout(mesh, H: int, Hkv: int) -> str:
    """How a mesh's ``model`` axis splits attention in train and prefill:
    ``"heads"`` when it divides the heads and the kv heads; ``"groups"``
    when it divides the heads and each rank's heads share one kv head
    (stablelm's 32 / 8, llama-vision's 64 / 8 over 16): the queries split
    by head, each rank projecting its one kv head (:func:`_flash_groups`);
    else ``"seq"`` (starcoder2's 36 heads, whisper's 12): each rank takes a
    slice of the sequence."""
    tp = _tp_size(mesh)
    if tp == 1 or (H % tp == 0 and Hkv % tp == 0):
        return "heads"
    if H % tp == 0 and (H // Hkv) % (H // tp) == 0:
        return "groups"
    return "seq"


def _flash(q, k, v, *, causal, window, softcap_v, scale, impl=None):
    """Full-sequence attention through the flash kernel.

    Under a mesh (DTensor q, k, v) every rank runs the kernel on its local
    shards, through ``local_map``: a kernel never sees a DTensor.  Batch
    goes over the FSDP axes and heads over ``model`` when the head counts
    divide it.  Where the heads do not divide it, each rank takes a slice
    of the query sequence (:func:`_flash_seq`; :func:`_attn_seq` slices
    the products around it too).  Where the heads divide it but the kv
    heads do not, :func:`_flash_groups` runs instead."""
    mesh = shlib.get_mesh()
    kw = dict(causal=causal, window=window, softcap=softcap_v, scale=scale,
              impl=impl)
    if mesh is None or not shlib.is_dtensor(q):
        return kops.flash_attention(q.contiguous(), k.contiguous(),
                                    v.contiguous(), **kw)
    H, Hkv = q.shape[2], k.shape[2]
    layout = head_layout(mesh, H, Hkv)
    if layout == "seq":
        S = q.shape[1]
        rep, seq = _seq_layouts(mesh, q.shape[0])
        q = _pad_seq(q, _tp_size(mesh), rep)
        out = _flash_seq(q, k, v, s_local=q.shape[1] // _tp_size(mesh),
                         rep=rep, seq=seq, **kw).redistribute(mesh, rep)
        return out[:, :S] if out.shape[1] != S else out
    if layout == "groups":
        raise ValueError("the groups layout's flash is _flash_groups")
    qpl = shlib.layout(mesh, ("batch", None, "heads", None), q)
    kvpl = shlib.layout(mesh, ("batch", None, "kv_heads", None), k)
    return shlib.local_map(
        lambda qs, ks, vs: kops.flash_attention(
            qs.contiguous(), ks.contiguous(), vs.contiguous(), **kw),
        qpl, (qpl, kvpl, kvpl))(q, k, v)


def _flash_groups(q, src, p, *, cfg, rope: bool, causal, window, scale,
                  impl=None):
    """The flash kernel in the ``"groups"`` layout (:func:`head_layout`):
    each ``model`` rank's query heads (``q``, heads over ``model``) share
    one kv head, so each rank projects that head's K and V itself from
    ``src`` (B, T, D), which is whole over ``model`` (k normed and, with
    ``rope``, rotated at positions 0..T-1), and runs the kernel on its own
    heads: no collective, and 1/Hkv of the K/V products a rank.  The K/V
    weights are whole over ``model`` (their kv heads do not divide it)."""
    from torch.distributed.tensor import Partial
    mesh = shlib.get_mesh()
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    g0 = mesh.get_local_rank("model") * (H // _tp_size(mesh)) // (H // Hkv)
    qpl = shlib.layout(mesh, ("batch", None, "heads", None), q)
    spl = shlib.layout(mesh, ("batch", None, None), src)
    wrep = list(shlib.placements(mesh, ()))
    names = ["wk", "wv"] + (["k_scale"] if cfg.qk_norm else [])

    def body(qs, xs, wk, wv, k_scale=None):
        Bl, T, _ = xs.shape
        k = linear(xs, wk[:, g0]).view(Bl, T, 1, hd)
        v = linear(xs, wv[:, g0]).view(Bl, T, 1, hd)
        if k_scale is not None:
            k = rms_norm(k, k_scale, cfg.norm_eps)
        if rope:
            k = apply_rope(k, torch.arange(T, device=xs.device)[None],
                           cfg.rope_theta, cfg.rope_pct)
        return kops.flash_attention(
            qs.contiguous(), k.contiguous(), v.contiguous(), causal=causal,
            window=window, softcap=cfg.attn_softcap, scale=scale, impl=impl)

    # each rank's kv head: a share of src's and the weights' grads
    model = [n == "model" for n in shlib.axis_names(mesh)]
    sgrad = [Partial() if m else pl for m, pl in zip(model, spl)]
    wgrad = [Partial() if m else pl for m, pl in
             zip(model, shlib.partial_over(wrep, spl))]
    ins = (qpl, spl) + (wrep,) * len(names)
    grads = (qpl, sgrad) + (wgrad,) * len(names)
    return shlib.local_map(body, qpl, ins, grads)(
        q, src, *(p[n] for n in names))


def _seq_layouts(mesh, B: int):
    """The stream's layout (batch over the FSDP axes, whole over
    ``model``) and the same with the sequence over ``model``."""
    bspec = shlib.spec_for(mesh, ("batch",), (B,))
    b = bspec[0] if bspec else None
    return (list(shlib.placements(mesh, (b,))),
            list(shlib.placements(mesh, (b, "model"))))


def _pad_seq(x, tp: int, rep):
    """``x`` (B, S, ...) padded at the end of its sequence to a multiple of
    ``tp`` (a no-op when it is one)."""
    pad = (-x.shape[1]) % tp
    if not pad:
        return x
    widths = (0, 0) * (x.dim() - 2) + (0, pad)
    return shlib.local_map(lambda t: F.pad(t, widths), rep, (rep,))(x)


def _kv_on_slices(src, p, *, cfg, rope: bool, gather: bool = True):
    """K and V of ``src`` (B, T, D), projected by each ``model`` rank on its
    slice of the T positions (k normed and rotated there, at the slice's
    own positions): (B, T, Hkv, hd) each, with ``gather`` gathered whole
    over ``model`` (laid out as the stream is), else left on the slices
    (T over ``model``: a prefill's self-attention cache where the kv
    heads do not divide it).  The kv weights are whole over ``model``
    here, so every rank would otherwise project all of T."""
    mesh = shlib.get_mesh()
    tp = _tp_size(mesh)
    B, T, _ = src.shape
    Hkv, hd = cfg.n_kv_heads, cfg.head_dim_
    rep, seq = _seq_layouts(mesh, B)
    srcp = _pad_seq(src, tp, rep)
    t_local = srcp.shape[1] // tp
    off = mesh.get_local_rank("model") * t_local
    wrep = list(shlib.placements(mesh, ()))
    names = ["wk", "wv"] + (["k_scale"] if cfg.qk_norm else [])

    def proj(xs, wk, wv, k_scale=None):
        Bl, Tl, _ = xs.shape
        k = linear(xs, wk.flatten(1)).view(Bl, Tl, Hkv, hd)
        v = linear(xs, wv.flatten(1)).view(Bl, Tl, Hkv, hd)
        if k_scale is not None:
            k = rms_norm(k, k_scale, cfg.norm_eps)
        if rope:
            positions = torch.arange(Tl, device=xs.device)[None] + off
            k = apply_rope(k, positions, cfg.rope_theta, cfg.rope_pct)
        return k, v

    ins = (seq,) + (wrep,) * len(names)
    grads = (seq,) + tuple(shlib.partial_over(w, seq) for w in ins[1:])
    k, v = shlib.local_map(proj, (seq, seq), ins, grads)(
        srcp, *(p[n] for n in names))
    if gather:
        k, v = k.redistribute(mesh, rep), v.redistribute(mesh, rep)
    if srcp.shape[1] != T:
        k, v = k[:, :T], v[:, :T]
    return k, v


def _flash_seq(q, k, v, *, s_local, rep, seq, **kw):
    """The flash kernel on each ``model`` rank's slice of the query
    sequence (``q`` laid out as ``seq``, K and V whole over ``model``):
    the causal mask offset by the slice's position (the kernel's
    ``q_offset``)."""
    mesh = shlib.get_mesh()

    def body(qs, ks, vs):
        return kops.flash_attention(
            qs.contiguous(), ks.contiguous(), vs.contiguous(),
            q_offset=mesh.get_local_rank("model") * s_local, **kw)

    kv_grad = shlib.partial_over(rep, seq)     # each slice's own queries
    return shlib.local_map(body, seq, (seq, rep, rep),
                           (seq, kv_grad, kv_grad))(q, k, v)


def _attn_seq(p, x, kv_source, *, cfg, kind, mode, causal, window, scale,
              impl):
    """Train / prefill attention where ``model`` does not divide the heads
    (context parallelism, the reference's ``shard_map`` branch and the
    sequence sharding GSPMD carries into the products around it): each
    ``model`` rank projects its slice of the sequence to q (normed and
    rotated at the slice's positions), runs the flash kernel on it against
    K and V projected on slices and gathered (:func:`_kv_on_slices`), and
    projects its slice of the output; the slices are gathered once, after
    the output projection, and the pad cut.  Returns (o, new_cache)."""
    mesh = shlib.get_mesh()
    tp = _tp_size(mesh)
    B, S, _ = x.shape
    H, hd = cfg.n_heads, cfg.head_dim_
    rep, seq = _seq_layouts(mesh, B)
    xp = _pad_seq(x, tp, rep)
    s_local = xp.shape[1] // tp
    off = mesh.get_local_rank("model") * s_local
    wrep = list(shlib.placements(mesh, ()))
    cross = kind == "cross"
    qn = ["wq"] + (["q_scale"] if cfg.qk_norm else [])

    def proj_q(xs, wq, q_scale=None):
        Bl, Sl, _ = xs.shape
        q = linear(xs, wq.flatten(1)).view(Bl, Sl, H, hd)
        if q_scale is not None:
            q = rms_norm(q, q_scale, cfg.norm_eps)
        if not cross:
            positions = torch.arange(Sl, device=xs.device)[None] + off
            q = apply_rope(q, positions, cfg.rope_theta, cfg.rope_pct)
        return q

    ins = (seq,) + (wrep,) * len(qn)
    q = shlib.local_map(proj_q, seq, ins, (seq,) + tuple(
        shlib.partial_over(w, seq) for w in ins[1:]))(xp, *(p[n] for n in qn))
    k, v = _kv_on_slices(kv_source if cross else x, p, cfg=cfg,
                         rope=not cross)
    out = _flash_seq(q, k, v, s_local=s_local, rep=rep, seq=seq,
                     causal=False if cross else causal,
                     window=0 if cross else window,
                     softcap=cfg.attn_softcap, scale=scale, impl=impl)

    def proj_o(os_, wo):
        Bl, Sl = os_.shape[:2]
        return linear(os_.reshape(Bl, Sl, H * hd), wo.flatten(0, 1))

    o = shlib.local_map(proj_o, seq, (seq, wrep),
                        (seq, shlib.partial_over(wrep, seq)))(out, p["wo"])
    o = o.redistribute(mesh, rep)
    if o.shape[1] != S:
        o = o[:, :S]
    return o, ({"k": k, "v": v} if mode == "prefill" else None)


def _softmax_over(s, groups):
    """``softmax(s, -1)`` in f32 where the last dim is split over the ranks
    of ``groups`` (each rank holds its slice): the max and the sum taken
    over the slices, one all-reduce each of a tensor without that dim;
    plain ``torch.softmax`` with no groups."""
    if not groups:
        return torch.softmax(s, dim=-1)
    m = shlib.all_reduce(s.amax(-1, keepdim=True), "max", groups)
    e = torch.exp(s - m)
    return e / shlib.all_reduce(e.sum(-1, keepdim=True), "sum", groups)


def _decode_layout(cache, heads: bool):
    """The layouts of a decode attention's local_map over a DTensor cache
    (B, S, ...): the cache's own; the query's (batch as the cache's, and
    with ``heads`` its heads split where the cache splits its kv heads,
    dim 2) and per-row tensors'; the chunk index and groups of the cache's
    sequence slices."""
    from torch.distributed.tensor import Replicate, Shard
    cpl = list(cache.placements)
    keep = {0, 2} if heads else {0}
    qpl = [p if isinstance(p, Shard) and p.dim in keep else Replicate()
           for p in cpl]
    rows = [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
            for p in cpl]
    t_idx, groups = shlib.shard_index(cache.device_mesh, cpl, 1)
    return cpl, qpl, rows, t_idx, groups


def _decode(q, k, v, kv_len, *, window=0, softcap=0.0, scale=None):
    """Decode attention of one query token over a KV cache.  Under a mesh
    (a DTensor cache) each rank attends on its local shards through
    ``local_map``: the batch as the cache's, the query's heads split where
    the cache splits its kv heads (whole where it does not).  Where the
    cache's sequence holds a mesh axis (the kv heads do not divide
    ``model``), each rank scores its slice of the cache and the softmax
    and the output are combined over the slices (:func:`_softmax_over`,
    then one all-reduce of the (B, H, Dv) partial output) instead of the
    cache being gathered."""
    kw = dict(window=window, softcap=softcap, scale=scale)
    if not shlib.is_dtensor(k):
        return kops.decode_attention(q, k, v, kv_len, **kw)
    cpl, qpl, rows, t_idx, groups = _decode_layout(k, heads=True)
    if not shlib.is_dtensor(kv_len):
        kv_len = shlib.replicated_like(kv_len, k)

    def body(ql, kl, vl, nl):
        if not groups:
            return kops.decode_attention(ql, kl, vl, nl, **kw)
        B, _, H, D = ql.shape
        Sl, Hkv = kl.shape[1], kl.shape[2]
        qr = ql.reshape(B, Hkv, H // Hkv, D).float()
        sc = (torch.einsum("bhgd,bshd->bhgs", qr, kl.float())
              * (scale if scale is not None else 1.0 / math.sqrt(D)))
        if softcap:
            sc = softcap * torch.tanh(sc / softcap)
        at = torch.arange(Sl, device=ql.device)[None] + t_idx * Sl
        mask = at < nl[:, None]
        if window:
            mask = mask & (at > nl[:, None] - 1 - window)
        sc = sc.masked_fill(~mask[:, None, None], -1e30)
        pr = _softmax_over(sc, groups).to(vl.dtype).float()
        out = shlib.all_reduce(
            torch.einsum("bhgs,bshd->bhgd", pr, vl.float()), "sum", groups)
        return out.reshape(B, 1, H, vl.shape[3]).to(ql.dtype)

    return shlib.local_map(body, qpl, (qpl, cpl, cpl, rows))(q, k, v, kv_len)


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
    mesh = shlib.get_mesh()
    layout = ("heads" if mode == "decode" or mesh is None
              or not shlib.is_dtensor(x) else head_layout(mesh, H, Hkv))
    if layout == "seq":
        return _attn_seq(p, x, kv_source, cfg=cfg, kind=kind, mode=mode,
                         causal=causal, window=window, scale=scale, impl=impl)

    # plain products on views of the (D, heads, hd) weights, cast to the
    # compute dtype as jnp's type promotion does
    q = linear(x, p["wq"].flatten(1)).view(B, S, H, hd)
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
        elif layout == "groups":
            if cfg.qk_norm:
                q = rms_norm(q, p["q_scale"], cfg.norm_eps)
            out = _flash_groups(q, kv_source, p, cfg=cfg, rope=False,
                                causal=False, window=0, scale=scale,
                                impl=impl)
            new_cache = None
            if mode == "prefill":      # the cross cache: whole over model
                k, v = _kv_on_slices(kv_source, p, cfg=cfg, rope=False)
                new_cache = {"k": k, "v": v}
        else:
            T = kv_source.shape[1]
            k = linear(kv_source, p["wk"].flatten(1)).view(B, T, Hkv, hd)
            v = linear(kv_source, p["wv"].flatten(1)).view(B, T, Hkv, hd)
            if cfg.qk_norm:
                k = rms_norm(k, p["k_scale"], cfg.norm_eps)
                q = rms_norm(q, p["q_scale"], cfg.norm_eps)
            out = _flash(q, k, v, causal=False, window=0,
                         softcap_v=cfg.attn_softcap, scale=scale, impl=impl)
            new_cache = {"k": k, "v": v} if mode == "prefill" else None
        o = linear(out.reshape(B, S, H * hd), p["wo"].flatten(0, 1))
        return o, new_cache

    if layout == "groups":
        if cfg.qk_norm:
            q = rms_norm(q, p["q_scale"], cfg.norm_eps)
        q = apply_rope(q, torch.arange(S, device=x.device)[None],
                       cfg.rope_theta, cfg.rope_pct)
        out = _flash_groups(q, x, p, cfg=cfg, rope=True, causal=causal,
                            window=window, scale=scale, impl=impl)
        o = linear(out.reshape(B, S, H * hd), p["wo"].flatten(0, 1))
        if mode != "prefill":
            return o, None
        # the cache as decode reads it: its sequence over ``model``
        k, v = _kv_on_slices(x, p, cfg=cfg, rope=True, gather=False)
        return o, {"k": k, "v": v}

    k = linear(x, p["wk"].flatten(1)).view(B, S, Hkv, hd)
    v = linear(x, p["wv"].flatten(1)).view(B, S, Hkv, hd)
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
    o = linear(out.reshape(B, S, H * hd), p["wo"].flatten(0, 1))
    return o, new_cache


def _latent_scores(q_lat, q_rope, ckv, krope, pos, scale, t0=0):
    """MLA's absorbed scores of the latent queries over the compressed
    cache (positions ``t0 ..`` of it), the positions past ``pos`` masked."""
    s = (torch.einsum("bshr,btr->bhst", q_lat, ckv) +
         torch.einsum("bshe,bte->bhst", q_rope, krope)) * scale
    t_idx = torch.arange(ckv.shape[1], device=q_lat.device)[None] + t0
    mask = t_idx <= pos[:, None].to(q_lat.device)
    return s.masked_fill(~mask[:, None, None], -1e30)


def _latent_attend(q_lat, q_rope, ckv, krope, pos, scale):
    """MLA's absorbed decode attention: (B, 1, H, r) context vectors in
    the latent space, f32 only inside the softmax (the reference's order
    of products).  Under a mesh (a DTensor cache) each rank attends on its
    local shards through ``local_map``; where the cache's sequence holds a
    mesh axis (``kv_seq`` over ``model``), each rank scores its slice and
    the softmax and the context are combined over the slices, in f32
    (:func:`_softmax_over`, then one all-reduce of the (B, H, r) partial
    context), instead of the cache being gathered -- the reference's
    GSPMD keeps the cache where it lies too."""
    dt = q_lat.dtype
    if not shlib.is_dtensor(ckv):
        pr = torch.softmax(_latent_scores(q_lat, q_rope, ckv, krope, pos,
                                          scale).float(), dim=-1).to(dt)
        return torch.einsum("bhst,btr->bshr", pr, ckv)
    cpl, qpl, rows, t_idx, groups = _decode_layout(ckv, heads=False)
    if not shlib.is_dtensor(pos):
        pos = shlib.replicated_like(pos, ckv)

    def body(ql, qr, c, kr, ps):
        s = _latent_scores(ql, qr, c, kr, ps, scale, t0=t_idx * c.shape[1])
        pr = _softmax_over(s.float(), groups).to(dt)
        if not groups:
            return torch.einsum("bhst,btr->bshr", pr, c)
        ctx = torch.einsum("bhst,btr->bshr", pr.float(), c.float())
        return shlib.all_reduce(ctx, "sum", groups).to(dt)

    return shlib.local_map(body, qpl, (qpl, qpl, cpl, cpl, rows))(
        q_lat, q_rope, ckv, krope, pos)


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

    ql = rms_norm(linear(x, w["wq_a"]), p["q_norm"], cfg.norm_eps)
    q = (ql @ w["wq_b"].flatten(1)).view(B, S, H, nope + rope_d)
    q_nope, q_rope = q[..., :nope], q[..., nope:]

    kv_a = linear(x, w["wkv_a"])                       # (B,S,r_kv+rope)
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
        ctx = _latent_attend(q_lat, q_rope, ckv_c, krope_c, pos, scale)
        out = torch.einsum("bshr,rhe->bshe", ctx, w["wv_b"])     # (B,1,H,vd)
        o = linear(out.reshape(B, S, H * vd), w["wo"].flatten(0, 1))
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
    o = linear(out.reshape(B, S, H * vd), w["wo"].flatten(0, 1))
    new_cache = {"ckv": ckv, "k_rope": k_rope} if mode == "prefill" else None
    return o, new_cache
