"""Kernel dispatchers.

Every op takes ``impl``:

  * ``"torch"`` -- the plain PyTorch version (``kernels/ref.py``), on any
    device.  The CPU path, and the yardstick the kernels are held to.
  * ``"cuda"``  -- the wrapper of the hand-written CUDA kernel
    (``kernels/paged_attention.py``): the kernel for CUDA tensors (it
    raises if the launch fails, never falls back), the plain version for
    CPU tensors.
  * ``None``    -- ``"cuda"`` for CUDA tensors, ``"torch"`` otherwise.
"""

from __future__ import annotations

from typing import Optional

import torch

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


def paged_scatter(k_pages, v_pages, blk, slot, k_vals, v_vals, *,
                  layer: Optional[int] = None, impl: Optional[str] = None):
    """Write token K/V into the ``(L, P, page, Hkv, D)`` pools in place (see
    :func:`repro_torch.kernels.paged_attention.paged_scatter`)."""
    if resolve_impl(impl, k_pages.device) == "cuda":
        _pa.paged_scatter(k_pages, v_pages, blk, slot, k_vals, v_vals,
                          layer=layer)
        return
    _ref.paged_scatter_ref(k_pages, v_pages, torch.as_tensor(blk),
                           torch.as_tensor(slot), k_vals, v_vals, layer=layer)
