"""Attention-free mixers: Mamba2 (SSD, scalar per-head decay) and RWKV-6
(Finch: token shift + data-dependent vector decay + bonus).

Decode caches:
  mamba2: {"conv": (B, d_conv-1, d_inner+2*d_state), "ssm": (B, nh, ds, hd)}
  rwkv6:  {"state": (B, H, dk, dv), "tm_shift": (B, D), "cm_shift": (B, D)}

Prefill and train run the chunked scan (``kernels/linear_scan.py``; its
plain version on the CPU); decode runs one recurrent step in plain
PyTorch, as the reference does.  Decode writes its new states INTO the
stacked cache tensors, in place; the reference returns new arrays.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.layers import Spec, rms_norm


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
    B, S, D = x.shape
    d_inner, nh, ds, dc = mamba2_dims(cfg)
    hd = cfg.ssm.head_dim
    xt = x.dtype
    conv_w = p["conv_w"].to(xt)
    conv_b = p["conv_b"].to(xt)

    zxbcdt = x @ p["in_proj"].to(xt)
    z, xbc, dt = _mamba2_split(cfg, zxbcdt)

    if mode == "decode":
        conv_state = _st_read(cache["conv"], layer_idx)  # (B, dc-1, ch)
        win = torch.cat([conv_state, xbc], dim=1)        # (B, dc, ch)
        xbc_conv = torch.einsum("btc,tc->bc", win, conv_w) + conv_b
        xbc_conv = F.silu(xbc_conv)[:, None]             # (B,1,ch)
        new_conv = win[:, 1:]
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

    xs = xbc_conv[..., :d_inner].reshape(B, -1, nh, hd)
    Bmat = xbc_conv[..., d_inner: d_inner + ds]          # (B,T,ds) single group
    Cmat = xbc_conv[..., d_inner + ds:]                  # (B,T,ds)
    dt = _softplus(dt.float() + p["dt_bias"].float())
    log_decay = -torch.exp(p["A_log"].float())[None, None] * dt  # (B,T,nh) f32

    # B and C shared by every head: stride-0 views, never copied per head
    T = Bmat.shape[1]
    qk_B = Bmat[:, :, None].expand(B, T, nh, ds)
    qk_C = Cmat[:, :, None].expand(B, T, nh, ds)
    vv = xs * dt[..., None].to(xs.dtype)

    if mode == "decode":
        out, new_state = kops.linear_scan_step(
            qk_C[:, 0], qk_B[:, 0], vv[:, 0], log_decay[:, 0],
            _st_read(cache["ssm"], layer_idx))
        y = out[:, None]                                 # (B,1,nh,hd)
        new_cache = {"conv": _st_write(cache["conv"], layer_idx, new_conv),
                     "ssm": _st_write(cache["ssm"], layer_idx, new_state)}
    else:
        y, final_state = kops.linear_scan(qk_C, qk_B, vv, log_decay,
                                          impl=impl)
        new_cache = ({"conv": new_conv, "ssm": final_state}
                     if mode == "prefill" else None)

    y = y + p["D_skip"].to(y.dtype)[None, None, :, None] * xs
    y = y.reshape(B, -1, d_inner)
    y = rms_norm(y * F.silu(z), p["gate_norm"], cfg.norm_eps)
    return y @ p["out_proj"].to(xt), new_cache


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
    xt = x.dtype

    if mode == "decode":
        xs = _st_read(cache["tm_shift"], layer_idx)[:, None]   # previous token
    else:
        xs = _shift(x)
    r = _lerp(x, xs, p["mu_r"]) @ p["wr"].to(xt)
    k = _lerp(x, xs, p["mu_k"]) @ p["wk"].to(xt)
    v = _lerp(x, xs, p["mu_v"]) @ p["wv"].to(xt)
    g = _lerp(x, xs, p["mu_g"]) @ p["wg"].to(xt)
    xw = _lerp(x, xs, p["mu_w"])
    w_exp = (p["w0"].float()[None, None]
             + torch.tanh(xw.float() @ p["wA"].float()) @ p["wB"].float())
    # clamp: decay below e^-12/step is numerically zero anyway, and bounded
    # log-decays keep the chunked (factored) scan well-conditioned
    w_log = -torch.exp(torch.clamp(w_exp, -8.0, 2.4849))   # (B,S,D), >= -12

    rh = r.reshape(B, S, H, hd)
    kh = k.reshape(B, S, H, hd)
    vh = v.reshape(B, S, H, hd)
    wh = w_log.reshape(B, S, H, hd)

    if mode == "decode":
        out, new_state = kops.linear_scan_step(
            rh[:, 0], kh[:, 0], vh[:, 0], wh[:, 0],
            _st_read(cache["state"], layer_idx), p["u"])
        y = out[:, None]
        tm_shift = x[:, 0]
    else:
        y, new_state = kops.linear_scan(rh, kh, vh, wh, bonus=p["u"],
                                        chunk=32, impl=impl)
        tm_shift = x[:, -1].clone()
    # per-head group norm then gate
    y = y.reshape(B, -1, H, hd)
    y = rms_norm(y, torch.zeros((hd,), dtype=y.dtype, device=y.device),
                 cfg.norm_eps)
    y = y.reshape(B, -1, D) * (1.0 + p["ln_x"].to(y.dtype))[None, None]
    tm_out = (y * F.silu(g)) @ p["wo"].to(xt)

    def cm_fn(xc):
        if mode == "decode":
            xcs = _st_read(cache["cm_shift"], layer_idx)[:, None]
        else:
            xcs = _shift(xc)
        kk = F.relu(_lerp(xc, xcs, p["cm_mu_k"]) @ p["cm_wk"].to(xt)) ** 2
        rr = torch.sigmoid(_lerp(xc, xcs, p["cm_mu_r"]) @ p["cm_wr"].to(xt))
        return rr * (kk @ p["cm_wv"].to(xt)), xc[:, -1].clone()

    new_cache = None
    if mode == "prefill":
        new_cache = {"state": new_state, "tm_shift": tm_shift}
    elif mode == "decode":
        new_cache = {"state": _st_write(cache["state"], layer_idx, new_state),
                     "tm_shift": _st_write(cache["tm_shift"], layer_idx,
                                           tm_shift)}
    return tm_out, cm_fn, new_cache
