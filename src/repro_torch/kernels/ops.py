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

``flash_attention`` and ``linear_scan`` under ``"cuda"`` go through their
kernels' ``torch.autograd.Function`` (``FlashAttention``, ``LinearScan``),
so train mode differentiates through the kernels: the forward is the
kernel, the backward the plain version's VJP, as the reference (which has
no backward kernel) differentiates its plain path.  The paged kernels
serve only and have no gradient.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import linear_scan as _ls
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.build import check

IMPLS = ("torch", "cuda")


def resolve_impl(impl: Optional[str], device) -> str:
    if impl is None:
        return "cuda" if torch.device(device).type == "cuda" else "torch"
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    return impl


def paged_attention(q, k_pages, v_pages, block_table, lengths, *,
                    softcap=0.0, scale=None, write=None,
                    impl: Optional[str] = None):
    """Paged attention; with ``write`` the layer's new K/V rows are
    written into ``k_pages``/``v_pages`` first, in the same launch under
    ``"cuda"`` (see
    :func:`repro_torch.kernels.paged_attention.paged_attention`)."""
    if resolve_impl(impl, q.device) == "cuda":
        return _pa.paged_attention(q, k_pages, v_pages, block_table, lengths,
                                   softcap=softcap, scale=scale, write=write)
    if write is not None:
        index, k_new, v_new, _, _ = write
        return _ref.paged_attention_write_ref(
            q, k_pages, v_pages, block_table, lengths, index.idx[0],
            index.idx[1], k_new, v_new, softcap=softcap, scale=scale)
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
                    scale=None, q_offset=0, impl: Optional[str] = None):
    if q.device.type == "meta":
        return _meta_flash(q, k, v, causal, window, softcap, scale,
                           q_offset)
    if resolve_impl(impl, q.device) == "cuda":
        return _fa.FlashAttention.apply(q, k, v, causal, window, softcap,
                                        scale, q_offset)
    return _ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                    softcap=softcap, scale=scale,
                                    q_offset=q_offset)


def flash_pairs(Sq: int, Sk: int, causal: bool, window: int,
                q_offset: int = 0) -> int:
    """The (query, key) pairs flash attention scores unmasked: each row
    s at position s + q_offset sees keys ``max(0, p - window + 1) ..
    min(p, Sk - 1)`` when causal, all Sk keys (or the window's) when not."""
    import numpy as np
    p = np.arange(Sq, dtype=np.int64) + q_offset
    hi = np.minimum(p, Sk - 1) if causal else np.full(Sq, Sk - 1)
    lo = np.maximum(p - window + 1, 0) if window else np.zeros(Sq, np.int64)
    return int(np.clip(hi - lo + 1, 0, None).sum())


def _meta_flash(q, k, v, causal, window, softcap, scale, q_offset):
    """Flash attention on the ``meta`` device (the dry-run): no values, the
    output's shape, and the kernel's own work recorded with the dry-run's
    counters: 2 (D + Dv) operations per unmasked (query, key, head), each
    input read and the output written once.  Under autograd the backward
    is recorded as the plain VJP's products, 2.5x the forward's, and holds
    the plain VJP's temporaries, as the card's backward does."""
    from repro_torch.roofline.op_stats import record_kernel
    B, Sq, H, D = q.shape
    Sk, Dv = k.shape[1], v.shape[3]
    flops = 2 * (D + Dv) * B * H * flash_pairs(Sq, Sk, causal, window,
                                                 q_offset)
    nbytes = (q.numel() + k.numel() + v.numel() + B * Sq * H * Dv) \
        * q.element_size()
    args = dict(causal=causal, window=window, softcap=softcap, scale=scale,
                q_offset=q_offset)
    plain = lambda q, k, v: _ref.flash_attention_ref(q, k, v, **args)
    return record_kernel("flash_attention", (B, Sq, H, Dv), q.dtype, flops,
                         nbytes, q, k, v,
                         plain=(plain, tuple(sorted(args.items()))))


def decode_attention(q, k_cache, v_cache, kv_len, *, window=0, softcap=0.0,
                     scale=None, impl: Optional[str] = None):
    return _ref.decode_attention_ref(q, k_cache, v_cache, kv_len,
                                     window=window, softcap=softcap,
                                     scale=scale)


def linear_scan(q, k, v, log_decay, *, state=None, bonus=None, chunk=128,
                impl: Optional[str] = None):
    if q.device.type == "meta":
        return _meta_scan(q, k, v, log_decay, bonus, chunk)
    if resolve_impl(impl, q.device) == "cuda":
        check(state is None, _ls.ZERO_STATE_ONLY)
        return _ls.LinearScan.apply(q, k, v, log_decay, bonus, chunk, 75.0)
    return _ref.linear_scan_ref(q, k, v, log_decay, state=state, bonus=bonus,
                                chunk=chunk)


def _meta_scan(q, k, v, log_decay, bonus, chunk):
    """The scan on the ``meta`` device (the dry-run): the output (B, S, H,
    V) and final state (B, H, K, V) f32, and the chunked algorithm's work:
    per chunk of L keys the intra-chunk products 2 L^2 (K + V) and the
    state's 4 L K V a head, the inputs read and the outputs written once.
    Its backward holds the plain VJP's temporaries, as the card's does."""
    from repro_torch.roofline.op_stats import record_kernel
    B, S, H, K = q.shape
    Vd = v.shape[3]
    L = min(chunk, S)
    flops = B * H * S * (2 * L * (K + Vd) + 4 * K * Vd)
    nbytes = (3 * B * S * H * K + 2 * B * S * H * Vd) * q.element_size() \
        + 4 * B * S * H * K + 4 * B * H * K * Vd
    plain = lambda q, k, v, ld, u: _ref.linear_scan_ref(
        q, k, v, ld, bonus=u, chunk=chunk, clamp=75.0)[0]
    y = record_kernel("linear_scan", (B, S, H, Vd), q.dtype, flops, nbytes,
                      q, k, v, log_decay, bonus, plain=(plain, (chunk,)))
    return y, torch.zeros((B, H, K, Vd), dtype=torch.float32, device="meta")


def linear_scan_step(q, k, v, log_decay, state, bonus=None):
    return _ref.linear_scan_step(q, k, v, log_decay, state, bonus)
