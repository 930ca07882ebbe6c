"""Plain PyTorch versions of the paged-serving kernels.

They are the arithmetic the CUDA kernels in ``csrc/`` must reproduce: the
CPU path of :mod:`repro_torch.kernels.ops` runs them, the tests hold them
against the reference package's Pallas kernels, and ``chip_smoke.py``
holds each CUDA kernel against them on the card.

* :func:`decode_attention_ref` -- single-token attention against a
  (possibly partially filled) KV cache.
* :func:`paged_attention_ref` -- decode attention against a paged block
  pool, through a padded block table (dead entries ``-1``).
* :func:`paged_scatter_ref` -- the token scatter
  ``pages[layer, blk[t], slot[t]] = vals[t]`` into the K and V pools, in
  place, for one layer or all.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def _softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    return cap * torch.tanh(x / cap) if cap else x


def decode_attention_ref(
    q: torch.Tensor,             # (B, 1, H, D)
    k_cache: torch.Tensor,       # (B, S, Hkv, D)
    v_cache: torch.Tensor,       # (B, S, Hkv, Dv)
    kv_len: torch.Tensor,        # (B,) number of valid cache positions
    *,
    window: int = 0,
    softcap: float = 0.0,
    scale: Optional[float] = None,
) -> torch.Tensor:
    B, _, H, D = q.shape
    S, Hkv, Dv = k_cache.shape[1], k_cache.shape[2], v_cache.shape[3]
    G = H // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qr = q.reshape(B, Hkv, G, D).float()
    s = torch.einsum("bhgd,bshd->bhgs", qr, k_cache.float()) * scale
    s = _softcap(s, softcap)
    pos = torch.arange(S, device=q.device)[None]          # (1, S)
    kv_len = kv_len.to(q.device)
    mask = pos < kv_len[:, None]
    if window:
        mask = mask & (pos > kv_len[:, None] - 1 - window)
    s = torch.where(mask[:, None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(B, 1, H, Dv).to(q.dtype)


def paged_attention_ref(
    q: torch.Tensor,             # (B, H, D)
    k_pages: torch.Tensor,       # (P, page, Hkv, D)  -- the shared block pool
    v_pages: torch.Tensor,       # (P, page, Hkv, Dv)
    block_table: torch.Tensor,   # (B, max_pages) int32 page ids (-1 pad)
    lengths: torch.Tensor,       # (B,) valid tokens per sequence
    *,
    softcap: float = 0.0,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Gather every table entry's page and attend over the positions that
    are below ``lengths[b]`` AND in a live (``>= 0``) table entry -- what
    the CUDA kernel reads.  Masked positions get weight exactly 0, so a row
    with no live position comes back as exact zeros, as the kernels' do.
    f32 throughout; the result in ``q.dtype``.  (:func:`build_block_table`
    puts -1 only past a row's live pages; a -1 inside them, which the TPU
    kernel would read as page 0, is masked here.)"""
    B, H, D = q.shape
    P, page, Hkv, _ = k_pages.shape
    Dv = v_pages.shape[-1]
    G = H // Hkv
    max_pages = block_table.shape[1]
    S = max_pages * page
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    table = block_table.long().to(k_pages.device)
    safe = table.clamp(min=0)
    k = k_pages[safe].reshape(B, S, Hkv, D).float()
    v = v_pages[safe].reshape(B, S, Hkv, Dv).float()
    s = torch.einsum("bhgd,bshd->bhgs", q.reshape(B, Hkv, G, D).float(),
                     k) * scale
    s = _softcap(s, softcap)
    pos = torch.arange(S, device=k.device)[None]
    valid = ((pos < lengths.to(k.device).long()[:, None])
             & (table >= 0).repeat_interleave(page, dim=1))[:, None, None]
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhgs,bshd->bhgd", p, v) / l.clamp(min=1e-30)
    return out.reshape(B, H, Dv).to(q.dtype)


def paged_scatter_ref(
    k_pages: torch.Tensor,       # (L, P, page, Hkv, D), written in place
    v_pages: torch.Tensor,
    block_idx: torch.Tensor,     # (T,) destination page per token
    slot_idx: torch.Tensor,      # (T,) destination slot per token
    k_vals: torch.Tensor,        # (T, Hkv, D) with a layer, else (L, T, ...)
    v_vals: torch.Tensor,
    *,
    layer: Optional[int] = None,
) -> None:
    """``pages[layer, blk[t], slot[t]] = vals[t]`` for K and V, for one
    layer or (``layer=None``) every layer, values cast to the pages'
    dtype -- the scatter kernel's function, by ``index_put_``."""
    blk = block_idx.long().to(k_pages.device)
    slot = slot_idx.long().to(k_pages.device)
    for pages, vals in ((k_pages, k_vals), (v_pages, v_vals)):
        vals = vals.to(device=pages.device, dtype=pages.dtype)
        if layer is None:
            pages[:, blk, slot] = vals
        else:
            pages[layer, blk, slot] = vals
