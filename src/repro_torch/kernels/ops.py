"""Kernel dispatchers.

Every op takes ``impl``:

  * ``"torch"`` -- the plain PyTorch version (``kernels/ref.py``), on any
    device.  The CPU path, and the yardstick the kernels are held to.
  * ``"cuda"``  -- the wrapper of the hand-written CUDA kernel
    (``kernels/paged_attention.py``, ``flash_attention.py``,
    ``linear_scan.py``): the kernel for CUDA tensors (it raises if the
    launch fails, never falls back), the plain version for CPU tensors.
  * ``None``    -- ``"cuda"`` for CUDA tensors, ``"torch"`` otherwise.

``decode_attention`` and ``linear_scan_step`` are plain PyTorch under
every ``impl``: the reference has no Pallas kernel for them either.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import linear_scan as _ls
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import ref as _ref

IMPLS = ("torch", "cuda")


def resolve_impl(impl: Optional[str], device) -> str:
    if impl is None:
        return "cuda" if torch.device(device).type == "cuda" else "torch"
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    return impl


def paged_attention(q, k_pages, v_pages, block_table, lengths, *,
                    softcap=0.0, scale=None, impl: Optional[str] = None):
    if resolve_impl(impl, q.device) == "cuda":
        return _pa.paged_attention(q, k_pages, v_pages, block_table, lengths,
                                   softcap=softcap, scale=scale)
    return _ref.paged_attention_ref(q, k_pages, v_pages, block_table, lengths,
                                    softcap=softcap, scale=scale)


def paged_scatter(k_pages, v_pages, index, k_vals, v_vals, *,
                  layer: Optional[int] = None, impl: Optional[str] = None):
    """Write token K/V into the ``(L, P, page, Hkv, D)`` pools in place at
    a prepared :class:`~repro_torch.kernels.paged_attention.ScatterIndex`
    (see :func:`repro_torch.kernels.paged_attention.paged_scatter_indexed`)."""
    if resolve_impl(impl, k_pages.device) == "cuda":
        _pa.paged_scatter_indexed(k_pages, v_pages, index, k_vals, v_vals,
                                  layer=layer)
        return
    _ref.paged_scatter_ref(k_pages, v_pages, index.idx[0], index.idx[1],
                           k_vals, v_vals, layer=layer)


def flash_attention(q, k, v, *, causal=True, window=0, softcap=0.0,
                    scale=None, impl: Optional[str] = None):
    if resolve_impl(impl, q.device) == "cuda":
        return _fa.flash_attention(q, k, v, causal=causal, window=window,
                                   softcap=softcap, scale=scale)
    return _ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                    softcap=softcap, scale=scale)


def decode_attention(q, k_cache, v_cache, kv_len, *, window=0, softcap=0.0,
                     scale=None, impl: Optional[str] = None):
    return _ref.decode_attention_ref(q, k_cache, v_cache, kv_len,
                                     window=window, softcap=softcap,
                                     scale=scale)


def linear_scan(q, k, v, log_decay, *, state=None, bonus=None, chunk=128,
                impl: Optional[str] = None):
    if resolve_impl(impl, q.device) == "cuda":
        return _ls.linear_scan(q, k, v, log_decay, state=state, bonus=bonus,
                               chunk=chunk)
    return _ref.linear_scan_ref(q, k, v, log_decay, state=state, bonus=bonus,
                                chunk=chunk)


def linear_scan_step(q, k, v, log_decay, state, bonus=None):
    return _ref.linear_scan_step(q, k, v, log_decay, state, bonus)
