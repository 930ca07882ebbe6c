"""Attention-free mixers: Mamba2 (SSD, scalar per-head decay) and RWKV-6
(Finch: token shift + data-dependent vector decay + bonus).

Decode caches:
  mamba2: {"conv": (B, d_conv-1, d_inner+2*d_state), "ssm": (B, nh, ds, hd)}
  rwkv6:  {"state": (B, H, dk, dv), "tm_shift": (B, D), "cm_shift": (B, D)}

Prefill and train run the chunked scan (``kernels/linear_scan.py``; its
plain version on the CPU); decode runs one recurrent step in plain
PyTorch, as the reference does.  Decode writes its new states INTO the
stacked cache tensors, in place; the reference returns new arrays.  Under
a mesh, Mamba2 runs each ``model`` rank on its own heads: train and
prefill with the weights re-laid (:func:`_mamba2_sharded`), decode with
the weights and caches where they lie and the token's projections
realigned (:func:`_mamba2_decode_sharded`).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.layers import Spec, linear, rms_norm
from repro_torch.parallel import sharding as shlib


def _st_read(arr, idx):
    return arr if idx is None else arr[idx]


def _st_write(arr, idx, val):
    """Store ``val`` as layer ``idx`` of a stacked state leaf, in place
    (None = unstacked: ``val`` in the leaf's dtype)."""
    val = val.to(arr.dtype)
    if idx is None:
        return val
    arr[idx] = val
    return arr


def _scan(q, k, v, log_decay, *, bonus=None, chunk=128, impl=None):
    """``kops.linear_scan`` (zero initial state).  Under a mesh (DTensor
    inputs) each rank runs the kernel on its local shards through
    ``local_map``: batch over the FSDP axes, heads over ``model`` where
    they divide it; the kernel never sees a DTensor."""
    if not shlib.is_dtensor(q):
        return kops.linear_scan(q, k, v, log_decay, bonus=bonus, chunk=chunk,
                                impl=impl)
    mesh = q.device_mesh
    bh = shlib.layout(mesh, ("batch", None, "heads", None), q)
    ld = bh[:] if log_decay.dim() == 4 else shlib.layout(
        mesh, ("batch", None, "heads"), log_decay)
    st = shlib.layout(mesh, ("batch", "heads", None, None),
                      torch.empty(q.shape[0], q.shape[2], 1, 1,
                                  device="meta"))
    ins = (bh, bh, bh, ld)
    args = (q, k, v, log_decay)
    if bonus is not None:
        up = shlib.layout(mesh, ("heads", None), bonus)
        ins += (up,)
        args += (bonus,)
    grads = ins[:4] + tuple(shlib.partial_over(p, bh) for p in ins[4:])

    def local(q, k, v, ld, u=None):
        return kops.linear_scan(q, k, v, ld, bonus=u, chunk=chunk, impl=impl)
    return shlib.local_map(local, (bh, st), ins, grads)(*args)


def _scan_step(q, k, v, log_decay, state, bonus=None):
    """``kops.linear_scan_step`` (decode).  Under a mesh each rank steps
    its own batch rows and heads (``local_map``), as the scan does."""
    if not shlib.is_dtensor(q):
        return kops.linear_scan_step(q, k, v, log_decay, state, bonus)
    mesh = q.device_mesh
    bh = shlib.layout(mesh, ("batch", "heads", None), q)
    ld = shlib.layout(mesh, ("batch", "heads") + (None,) * (
        log_decay.dim() - 2), log_decay)
    st = shlib.layout(mesh, ("batch", "heads", None, None), state)
    ins, args = (bh, bh, bh, ld, st), (q, k, v, log_decay, state)
    if bonus is not None:
        ins += (shlib.layout(mesh, ("heads", None), bonus),)
        args += (bonus,)
    grads = ins[:5] + tuple(shlib.partial_over(p, bh) for p in ins[5:])
    return shlib.local_map(kops.linear_scan_step, (bh, st), ins,
                           grads)(*args)


def _softplus(x):
    """``jax.nn.softplus``: log(1 + e^x) as logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


# ============================================================================
# Mamba2
# ============================================================================


def mamba2_dims(cfg: ArchConfig):
    ssm = cfg.ssm
    d_inner = ssm.expand * cfg.d_model
    nh = d_inner // ssm.head_dim
    return d_inner, nh, ssm.d_state, ssm.d_conv


def mamba2_specs(cfg: ArchConfig) -> Dict[str, Spec]:
    D = cfg.d_model
    d_inner, nh, ds, dc = mamba2_dims(cfg)
    conv_ch = d_inner + 2 * ds
    return {
        "in_proj": Spec((D, 2 * d_inner + 2 * ds + nh), ("embed", "mlp")),
        "conv_w": Spec((dc, conv_ch), ("conv", "mlp"), "normal", 0.5),
        "conv_b": Spec((conv_ch,), ("mlp",), "zeros"),
        "A_log": Spec((nh,), ("heads",), "zeros"),
        "D_skip": Spec((nh,), ("heads",), "ones"),
        "dt_bias": Spec((nh,), ("heads",), "zeros"),
        "gate_norm": Spec((d_inner,), ("mlp",), "zeros"),
        "out_proj": Spec((d_inner, D), ("mlp", "embed")),
    }


def _mamba2_split(cfg, zxbcdt):
    d_inner, nh, ds, _ = mamba2_dims(cfg)
    z = zxbcdt[..., :d_inner]
    xbc = zxbcdt[..., d_inner: 2 * d_inner + 2 * ds]
    dt = zxbcdt[..., 2 * d_inner + 2 * ds:]
    return z, xbc, dt


def apply_mamba2(
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,                         # (B,S,D) normed
    *,
    cfg: ArchConfig,
    mode: str,
    cache: Optional[Dict[str, torch.Tensor]] = None,
    layer_idx=None,
    impl: Optional[str] = None,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    if mode == "decode" and _heads_split(x, cfg):
        g, new_cache = _mamba2_decode_sharded(p, x, cfg=cfg, cache=cache,
                                              layer_idx=layer_idx)
    elif mode != "decode" and _heads_split(x, cfg):
        g, new_cache = _mamba2_sharded(p, x, cfg=cfg, mode=mode, impl=impl)
    else:
        xt = x.dtype
        zxbcdt = shlib.whole_last_dim(linear(x, p["in_proj"]))
        z, xbc, dt = _mamba2_split(cfg, zxbcdt)
        g, new_cache = _mamba2_mix(
            z, xbc, dt, p["conv_w"].to(xt), p["conv_b"].to(xt), p["A_log"],
            p["D_skip"], p["dt_bias"], cfg=cfg, mode=mode, cache=cache,
            layer_idx=layer_idx, impl=impl)
    y = rms_norm(g, p["gate_norm"], cfg.norm_eps)
    return linear(y, p["out_proj"]), new_cache


def _conv_step(conv_state, xbc, conv_w, conv_b):
    """One decode token through the causal conv: (its activated output
    (B,1,ch), the new raw window tail (B,dc-1,ch))."""
    win = torch.cat([conv_state, xbc], dim=1)            # (B, dc, ch)
    xbc_conv = torch.einsum("btc,tc->bc", win, conv_w) + conv_b
    return F.silu(xbc_conv)[:, None], win[:, 1:]


def _mamba2_mix(z, xbc, dt, conv_w, conv_b, A_log, D_skip, dt_bias, *, cfg,
                mode, cache=None, layer_idx=None, impl=None):
    """The mixer between the projections: the causal conv over the x, B
    and C channels ``xbc``, then :func:`_mamba2_heads`: (y * silu(z), new
    cache).  The heads (and the x channels) may be one rank's share; B and
    C are whole."""
    _, _, ds, dc = mamba2_dims(cfg)
    S = xbc.shape[1]
    if mode == "decode":
        xbc_conv, new_conv = _conv_step(_st_read(cache["conv"], layer_idx),
                                        xbc, conv_w, conv_b)
    else:
        xbc_pad = F.pad(xbc, (0, 0, dc - 1, 0))
        # causal depthwise conv, width dc
        xbc_conv = sum(xbc_pad[:, i: i + S] * conv_w[i][None, None]
                       for i in range(dc)) + conv_b
        xbc_conv = F.silu(xbc_conv)
        # prefill carries the last dc-1 raw (pre-activation) inputs (a
        # copy: a view would keep the whole projection alive in the cache)
        new_conv = (xbc[:, S - (dc - 1):].clone() if mode == "prefill"
                    else None)
    g, state = _mamba2_heads(
        z, xbc_conv, dt, A_log, D_skip, dt_bias, cfg=cfg, mode=mode,
        state=_st_read(cache["ssm"], layer_idx) if mode == "decode" else None,
        impl=impl)
    if mode == "decode":
        return g, {"conv": _st_write(cache["conv"], layer_idx, new_conv),
                   "ssm": _st_write(cache["ssm"], layer_idx, state)}
    return g, ({"conv": new_conv, "ssm": state} if mode == "prefill"
               else None)


def _mamba2_heads(z, xbc_conv, dt, A_log, D_skip, dt_bias, *, cfg, mode,
                  state=None, impl=None):
    """The scan (decode: one step from ``state``) over the heads of ``dt``
    on the conv's output ``xbc_conv`` (x | B | C), the skip and the gate:
    (y * silu(z), the new or final ssm state)."""
    ds = cfg.ssm.d_state
    hd = cfg.ssm.head_dim
    B = xbc_conv.shape[0]
    d_inner = xbc_conv.shape[-1] - 2 * ds
    nh = dt.shape[-1]

    xs = xbc_conv[..., :d_inner].reshape(B, -1, nh, hd)
    Bmat = xbc_conv[..., d_inner: d_inner + ds]          # (B,T,ds) single group
    Cmat = xbc_conv[..., d_inner + ds:]                  # (B,T,ds)
    dt = _softplus(dt.float() + dt_bias.float())
    log_decay = -torch.exp(A_log.float())[None, None] * dt  # (B,T,nh) f32

    # B and C shared by every head: stride-0 views, never copied per head
    T = Bmat.shape[1]
    qk_B = Bmat[:, :, None].expand(B, T, nh, ds)
    qk_C = Cmat[:, :, None].expand(B, T, nh, ds)
    vv = xs * dt[..., None].to(xs.dtype)

    if mode == "decode":
        out, state = _scan_step(qk_C[:, 0], qk_B[:, 0], vv[:, 0],
                                log_decay[:, 0], state)
        y = out[:, None]                                 # (B,1,nh,hd)
    else:
        y, state = _scan(qk_C, qk_B, vv, log_decay, impl=impl)

    y = y + D_skip.to(y.dtype)[None, None, :, None] * xs
    y = y.reshape(B, -1, d_inner)
    return y * F.silu(z), state


def _heads_split(x, cfg) -> bool:
    """Whether ``x`` is a DTensor on a mesh whose ``model`` axis (if any)
    divides Mamba2's heads: :func:`_mamba2_sharded`'s layout."""
    if not shlib.is_dtensor(x):
        return False
    mesh = x.device_mesh
    tp = (shlib.axis_size(mesh, "model")
          if "model" in shlib.axis_names(mesh) else 1)
    return mamba2_dims(cfg)[1] % tp == 0


def _mamba2_sharded(p, x, *, cfg, mode, impl=None):
    """:func:`_mamba2_mix` under a mesh, train and prefill, each ``model``
    rank on its own heads (``local_map``): the weight moves, not the
    activation.  in_proj's columns z | x | B | C | dt, and the conv's
    channels x | B | C, are cut at boundaries their ``model`` shards do
    not follow, so each rank takes the weights whole over ``model`` (one
    gather a layer) and projects its heads' z, x and dt columns --
    the heads ``out_proj``'s rows, the gate norm and the per-head vectors
    already follow -- and B and C, which every head shares, whole.  The
    gate (y * silu(z)) comes out with its channels over ``model``: the
    gated norm sums squares over them (a per-token all-reduce) and
    ``out_proj`` is row-parallel.  A prefill's ssm state comes out over
    ``model`` by heads, its conv tail whole over ``model``."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = x.device_mesh
    names = shlib.axis_names(mesh)
    tp = shlib.axis_size(mesh, "model") if "model" in names else 1
    r = mesh.get_local_rank("model") if "model" in names else 0
    d_inner, nh, ds, _ = mamba2_dims(cfg)
    di, nl = d_inner // tp, nh // tp
    xt = x.dtype

    xpl = shlib.layout(mesh, ("batch", None, None), x)

    def over_model(dim):
        return [Shard(dim) if n == "model" else q for n, q in zip(names, xpl)]

    rep = [Replicate()] * mesh.ndim
    # a weight whole on every rank meets other tokens over the FSDP axes
    # and is used on other columns over ``model``: its grad sums over both,
    # reduce-scattered back to its ``model`` shard at the gather and left
    # ``Partial`` over the FSDP axes for FSDP's reduce-scatter
    wgrad = [Partial() if n == "model" or isinstance(q, Shard) else q
             for n, q in zip(names, xpl)]

    def whole(w):
        back = [q if n == "model" else g
                for n, q, g in zip(names, w.placements, wgrad)]
        return shlib.relayout(w, rep, back)

    hpl = shlib.layout(mesh, ("heads",), p["A_log"])
    hgrad = shlib.partial_over(hpl, xpl)
    xgrad = [Partial() if n == "model" else q for n, q in zip(names, xpl)]

    def body(xl, w, cw, cb, a_log, d_skip, dt_bias):
        own = slice(r * di, (r + 1) * di)
        cols = torch.cat([w[:, own], w[:, d_inner:][:, own],
                          w[:, 2 * d_inner: 2 * d_inner + 2 * ds],
                          w[:, 2 * (d_inner + ds) + r * nl:][:, :nl]], dim=1)
        z, xbc, dt = torch.split(linear(xl, cols), (di, di + 2 * ds, nl),
                                 dim=-1)
        chans = lambda c: torch.cat([c[..., own], c[..., d_inner:]], -1)
        g, c = _mamba2_mix(z, xbc, dt, chans(cw).to(xt), chans(cb).to(xt),
                           a_log, d_skip, dt_bias, cfg=cfg, mode=mode,
                           impl=impl)
        if c is None:
            return g
        return g, c["conv"][..., :di], c["conv"][..., di:], c["ssm"]

    outs = (over_model(2),) + ((over_model(2), xpl, over_model(1))
                               if mode == "prefill" else ())
    got = shlib.local_map(
        body, outs if mode == "prefill" else outs[0],
        (xpl, rep, rep, rep, hpl, hpl, hpl),
        (xgrad, wgrad, wgrad, wgrad, hgrad, hgrad, hgrad))(
        x, whole(p["in_proj"]), whole(p["conv_w"]), whole(p["conv_b"]),
        p["A_log"], p["D_skip"], p["dt_bias"])
    if mode != "prefill":
        return got, None
    g, conv_x, conv_bc, state = got
    return g, {"conv": torch.cat([conv_x, conv_bc], dim=-1), "ssm": state}


def _mamba2_decode_sharded(p, x, *, cfg, cache, layer_idx):
    """A decode step of Mamba2 under a mesh, each ``model`` rank on its
    own heads, every weight and cache leaf where it lies: the token moves,
    not the weights.  in_proj's product comes out as its column shards
    (z | x | B | C | dt, cut where the heads do not follow), and the conv's
    weights and tail lie as channel shards of x | B | C (the cache's
    ``mlp_state`` layout, the reference's).  So one all-to-all over
    ``model`` (:func:`sharding.realign`) hands each rank its heads' z and
    dt columns and the raw channels of its conv shard; the conv steps
    there, its new tail written where the cache holds it; a second
    all-to-all hands each rank its heads' x channels, and B and C, which
    every head shares, are broadcast whole from the rank whose conv shard
    holds them (:func:`sharding.shared_range`).  The scan steps the
    rank's heads of the ssm state.  The gate comes out with its channels
    over ``model``: the gated norm sums squares over them (a per-token
    all-reduce) and ``out_proj`` is row-parallel."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = x.device_mesh
    names = shlib.axis_names(mesh)
    tp = shlib.axis_size(mesh, "model") if "model" in names else 1
    r = mesh.get_local_rank("model") if "model" in names else 0
    group = mesh.get_group("model") if tp > 1 else None
    d_inner, nh, ds, _ = mamba2_dims(cfg)
    di, nl = d_inner // tp, nh // tp
    xt = x.dtype
    zx = linear(x, p["in_proj"])
    conv = _st_read(cache["conv"], layer_idx)
    state = _st_read(cache["ssm"], layer_idx)
    m = names.index("model") if tp > 1 else None

    def cut(t, dim):
        """Each rank's ``[lo, hi)`` of ``t``'s dim over ``model``."""
        if m is None or not isinstance(t.placements[m], Shard):
            return ((0, t.shape[dim]),) * tp
        return shlib.chunks(t.shape[dim], tp)

    cols, chans = cut(zx, 2), cut(conv, 2)
    dt0 = 2 * (d_inner + ds)
    into_conv = shlib.exchange_plan(
        tuple((c,) for c in cols),
        tuple(((j * di, (j + 1) * di), (d_inner + lo, d_inner + hi),
               (dt0 + j * nl, dt0 + (j + 1) * nl))
              for j, (lo, hi) in enumerate(chans)), r)
    into_heads = shlib.exchange_plan(
        tuple((c,) for c in chans),
        tuple(((j * di, (j + 1) * di),) for j in range(tp)), r)
    ccl = chans[r][1] - chans[r][0]

    def body(zl, cs, st, cw, cb, a_log, d_skip, dt_bias):
        z, xbc, dt = torch.split(shlib.realign(zl, into_conv, group),
                                 (di, ccl, nl), dim=-1)
        xbc_conv, new_conv = _conv_step(cs, xbc, cw.to(xt), cb.to(xt))
        xbc_conv = torch.cat([
            shlib.realign(xbc_conv, into_heads, group),
            shlib.shared_range(xbc_conv, chans, d_inner, d_inner + 2 * ds,
                               r, group)], dim=-1)
        g, new_state = _mamba2_heads(z, xbc_conv, dt, a_log, d_skip,
                                     dt_bias, cfg=cfg, mode="decode",
                                     state=st)
        return g, new_conv, new_state

    rows = [q if n != "model" else Shard(2) if m is not None and isinstance(
        zx.placements[m], Shard) else Replicate()
        for n, q in zip(names, zx.placements)]
    out = [q if n != "model" else Shard(2) for n, q in zip(names, rows)]
    g, new_conv, new_state = shlib.local_map(
        body, (out, list(conv.placements), list(state.placements)),
        (rows, list(conv.placements), list(state.placements),
         list(p["conv_w"].placements), list(p["conv_b"].placements),
         list(p["A_log"].placements), list(p["D_skip"].placements),
         list(p["dt_bias"].placements)))(
        zx, conv, state, p["conv_w"], p["conv_b"], p["A_log"], p["D_skip"],
        p["dt_bias"])
    return g, {"conv": _st_write(cache["conv"], layer_idx, new_conv),
               "ssm": _st_write(cache["ssm"], layer_idx, new_state)}


# ============================================================================
# RWKV-6 (time mix + channel mix fused into one block)
# ============================================================================


def rwkv6_dims(cfg: ArchConfig):
    hd = cfg.ssm.head_dim if cfg.ssm else 64
    return cfg.d_model // hd, hd


def rwkv6_specs(cfg: ArchConfig) -> Dict[str, Spec]:
    D, dff = cfg.d_model, cfg.d_ff
    H, hd = rwkv6_dims(cfg)
    lora = 64
    return {
        # time mix
        "mu_r": Spec((D,), ("embed",), "zeros"),
        "mu_k": Spec((D,), ("embed",), "zeros"),
        "mu_v": Spec((D,), ("embed",), "zeros"),
        "mu_g": Spec((D,), ("embed",), "zeros"),
        "mu_w": Spec((D,), ("embed",), "zeros"),
        "wr": Spec((D, D), ("embed", "heads_embed")),
        "wk": Spec((D, D), ("embed", "heads_embed")),
        "wv": Spec((D, D), ("embed", "heads_embed")),
        "wg": Spec((D, D), ("embed", "heads_embed")),
        "w0": Spec((D,), ("heads_embed",), "zeros"),
        "wA": Spec((D, lora), ("embed", "lora")),
        "wB": Spec((lora, D), ("lora", "heads_embed")),
        "u": Spec((H, hd), ("heads", "head_dim")),
        "ln_x": Spec((D,), ("heads_embed",), "zeros"),
        "wo": Spec((D, D), ("heads_embed", "embed")),
        # channel mix
        "cm_mu_k": Spec((D,), ("embed",), "zeros"),
        "cm_mu_r": Spec((D,), ("embed",), "zeros"),
        "cm_norm": Spec((D,), ("embed",), "zeros"),
        "cm_wk": Spec((D, dff), ("embed", "mlp")),
        "cm_wv": Spec((dff, D), ("mlp", "embed")),
        "cm_wr": Spec((D, D), ("embed", "embed_out")),
    }


def _lerp(x, xs, mu):
    """``x + (xs - x) * mu``; under a mesh on the slice of the embed dim
    where ``mu`` lies (``sharding.along_last``: decode at batch 1), ``xs``
    laid out as ``x``."""
    x, mu = shlib.along_last(x, mu)
    if shlib.is_dtensor(xs) and xs.placements != x.placements:
        xs = xs.redistribute(x.device_mesh, x.placements)
    return x + (xs - x) * mu.to(x.dtype)


def _shift(x):
    """The previous token along S (zeros before the first)."""
    return F.pad(x, (0, 0, 1, 0))[:, : x.shape[1]]


def apply_rwkv6(
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,                        # (B,S,D) normed (time-mix input)
    *,
    cfg: ArchConfig,
    mode: str,
    cache: Optional[Dict[str, torch.Tensor]] = None,
    layer_idx=None,
    impl: Optional[str] = None,
):
    """Returns (tm_out, cm_fn, new_cache); cm_fn applies channel mix to its
    (re-normed) input so the block can put the residual in between."""
    B, S, D = x.shape
    H, hd = rwkv6_dims(cfg)

    if mode == "decode":
        xs = _st_read(cache["tm_shift"], layer_idx)[:, None]   # previous token
    else:
        xs = _shift(x)
    r = linear(_lerp(x, xs, p["mu_r"]), p["wr"])
    k = linear(_lerp(x, xs, p["mu_k"]), p["wk"])
    v = linear(_lerp(x, xs, p["mu_v"]), p["wv"])
    g = linear(_lerp(x, xs, p["mu_g"]), p["wg"])
    xw = _lerp(x, xs, p["mu_w"])
    w_exp = (p["w0"].float()[None, None]
             + linear(torch.tanh(linear(xw.float(), p["wA"])), p["wB"]))
    # clamp: decay below e^-12/step is numerically zero anyway, and bounded
    # log-decays keep the chunked (factored) scan well-conditioned
    w_log = -torch.exp(torch.clamp(w_exp, -8.0, 2.4849))   # (B,S,D), >= -12

    rh = r.reshape(B, S, H, hd)
    kh = k.reshape(B, S, H, hd)
    vh = v.reshape(B, S, H, hd)
    wh = w_log.reshape(B, S, H, hd)

    if mode == "decode":
        out, new_state = _scan_step(
            rh[:, 0], kh[:, 0], vh[:, 0], wh[:, 0],
            _st_read(cache["state"], layer_idx), p["u"])
        y = out[:, None]
        tm_shift = x[:, 0]
    else:
        y, new_state = _scan(rh, kh, vh, wh, bonus=p["u"], chunk=32,
                             impl=impl)
        tm_shift = x[:, -1].clone()
    # per-head group norm then gate
    y = y.reshape(B, -1, H, hd)
    y = rms_norm(y, torch.zeros((hd,), dtype=y.dtype, device=y.device),
                 cfg.norm_eps)
    y = y.reshape(B, -1, D) * (1.0 + p["ln_x"].to(y.dtype))[None, None]
    tm_out = linear(y * F.silu(g), p["wo"])

    def cm_fn(xc):
        if mode == "decode":
            xcs = _st_read(cache["cm_shift"], layer_idx)[:, None]
        else:
            xcs = _shift(xc)
        kk = F.relu(linear(_lerp(xc, xcs, p["cm_mu_k"]), p["cm_wk"])) ** 2
        rr = torch.sigmoid(linear(_lerp(xc, xcs, p["cm_mu_r"]), p["cm_wr"]))
        return rr * linear(kk, p["cm_wv"]), xc[:, -1].clone()

    new_cache = None
    if mode == "prefill":
        new_cache = {"state": new_state, "tm_shift": tm_shift}
    elif mode == "decode":
        new_cache = {"state": _st_write(cache["state"], layer_idx, new_state),
                     "tm_shift": _st_write(cache["tm_shift"], layer_idx,
                                           tm_shift)}
    return tm_out, cm_fn, new_cache
