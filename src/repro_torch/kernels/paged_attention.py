"""Paged attention and the page scatter: the CUDA kernels of the paged KV
pool, their wrappers, and the block-table layout they read.

:func:`build_block_table` packs ragged per-request block lists into the
padded ``(B, max_pages)`` int32 table the attention kernel walks -- width
is the BATCH max, not the engine max, and trailing pre-allocated but
unwritten pages are dead entries (-1).

:func:`paged_attention` and :func:`paged_scatter` are the wrappers of
``csrc/paged_attention.cu`` and ``csrc/paged_scatter.cu``.  Each takes the
plain PyTorch version (``kernels/ref.py``) only for tensors that lie on the
CPU; for CUDA tensors it checks what the kernel relies on, launches it on
the current stream, counts the launch in :data:`launch_counts`, and raises
if the launch failed.  There is no fallback from a CUDA tensor to the
plain version.
"""

from __future__ import annotations

import ctypes
import math
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref as _ref

#: launches of each kernel since the last :func:`reset_launch_counts`
launch_counts: Dict[str, int] = {"paged_attention": 0, "paged_scatter": 0}
_count_lock = threading.Lock()
_fn_lock = threading.Lock()
_fns: Dict[str, object] = {}

_PAGE_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launch_counts() -> None:
    with _count_lock:
        for k in launch_counts:
            launch_counts[k] = 0


def _count(name: str) -> None:
    with _count_lock:
        launch_counts[name] += 1


def to_device(a: np.ndarray, device) -> torch.Tensor:
    """Upload a small host array (indices, token ids) without blocking the
    host: through pinned memory on a CUDA device, where a pageable copy
    would synchronise the stream."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    device = torch.device(device)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def build_block_table(
    blocks: Sequence[Sequence[int]],
    lengths: Sequence[int],
    *,
    page: int,
    min_pages: int = 1,
    device="cpu",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pack per-request block lists into a padded ``(B, max_pages)`` table.

    ``blocks[b]`` is request b's physical page list (block-pool ids, prefix-
    shared pages first); ``lengths[b]`` the number of tokens it currently
    holds.  Only the pages that cover ``lengths[b]`` tokens enter the row;
    the rest of the row is -1.  Width is max(ceil(len/page)) over the batch,
    floored at ``min_pages``.  Returns int32 ``(table, lengths)`` on
    ``device``.
    """
    rows: List[List[int]] = []
    for i, (bl, ln) in enumerate(zip(blocks, lengths)):
        used = -(-int(ln) // page)          # pages holding actual tokens
        if len(bl) < used:
            # silent truncation would mask positions the caller claims
            # exist -- wrong attention with no error; fail loudly instead
            raise ValueError(
                f"request {i}: {int(ln)} tokens need {used} pages, "
                f"block list has {len(bl)}")
        rows.append(list(bl[:used]))
    width = max([min_pages] + [len(r) for r in rows])
    table = np.full((len(rows), width), -1, np.int32)
    for i, r in enumerate(rows):
        table[i, :len(r)] = r
    return (to_device(table, device),
            to_device(np.asarray(lengths, np.int32), device))


def _fn(name: str):
    """The kernel's ctypes entry point, built and typed on first use."""
    with _fn_lock:
        fn = _fns.get(name)
        if fn is not None:
            return fn
        lib = build.load(name)
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        if name == "paged_attention":
            fn = lib.paged_attention_launch
            fn.argtypes = [i, p, p, p, p, p, p, i, i, i, i, i, i, i, f, f, p]
        else:
            fn = lib.paged_scatter_launch
            fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
        _fns[name] = fn
        return fn


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def paged_attention(
    q: torch.Tensor,              # (B, H, D) f32
    k_pages: torch.Tensor,        # (P, page, Hkv, D)
    v_pages: torch.Tensor,        # (P, page, Hkv, D)
    block_table: torch.Tensor,    # (B, max_pages) int32, -1 padded
    lengths: torch.Tensor,        # (B,) int32
    *,
    softcap: float = 0.0,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Ragged paged attention, ``(B, H, D)`` f32 out.  CPU tensors take
    :func:`~repro_torch.kernels.ref.paged_attention_ref`; CUDA tensors the
    kernel of ``csrc/paged_attention.cu``."""
    if q.device.type == "cpu":
        return _ref.paged_attention_ref(q, k_pages, v_pages, block_table,
                                        lengths, softcap=softcap, scale=scale)
    B, H, D = q.shape
    P, page, Hkv, Dk = k_pages.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    dev = q.device
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages),
                    ("block_table", block_table), ("lengths", lengths)):
        _check(t.device == dev, f"{name} on {t.device}, q on {dev}")
        _check(t.is_contiguous(), f"{name} must be contiguous")
    _check(q.dtype == torch.float32 and q.is_contiguous(),
           "q must be contiguous float32")
    _check(k_pages.dtype in _PAGE_DTYPES and v_pages.dtype == k_pages.dtype,
           f"pages must be float32 or bfloat16, got {k_pages.dtype}/"
           f"{v_pages.dtype}")
    _check(v_pages.shape == k_pages.shape and Dk == D,
           f"kernel takes Dv == D: q {tuple(q.shape)}, k_pages "
           f"{tuple(k_pages.shape)}, v_pages {tuple(v_pages.shape)}")
    _check(H % Hkv == 0, f"H={H} is not a multiple of Hkv={Hkv}")
    _check(block_table.dtype == torch.int32 and block_table.dim() == 2
           and block_table.shape[0] == B, "block_table must be (B, n) int32")
    _check(lengths.dtype == torch.int32 and tuple(lengths.shape) == (B,),
           "lengths must be (B,) int32")
    out = torch.empty((B, H, D), dtype=torch.float32, device=dev)
    err = _fn("paged_attention")(
        _PAGE_DTYPES[k_pages.dtype], q.data_ptr(), k_pages.data_ptr(),
        v_pages.data_ptr(), block_table.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), B, H, Hkv, D, P, page, block_table.shape[1],
        float(scale), float(softcap or 0.0),
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "paged_attention")
    _count("paged_attention")
    return out


def paged_scatter(
    k_pages: torch.Tensor,        # (L, P, page, Hkv, D), written in place
    v_pages: torch.Tensor,
    blk: np.ndarray,              # (T,) destination page per token
    slot: np.ndarray,             # (T,) destination slot per token
    k_vals: torch.Tensor,         # (T, Hkv, D) with a layer, else (L, T, ...)
    v_vals: torch.Tensor,
    *,
    layer: Optional[int] = None,
) -> None:
    """``pages[layer, blk[t], slot[t]] = vals[t]`` for K and V at once, for
    one layer or (``layer=None``) every layer.  The values are cast to the
    pages' dtype first.  CPU pages take
    :func:`~repro_torch.kernels.ref.paged_scatter_ref`; CUDA pages one
    launch of ``csrc/paged_scatter.cu``."""
    blk = np.asarray(blk, np.int64).reshape(-1)
    slot = np.asarray(slot, np.int64).reshape(-1)
    L, P, page, Hkv, D = k_pages.shape
    T = blk.shape[0]
    n_layers = L if layer is None else 1
    want = (T, Hkv, D) if layer is not None else (L, T, Hkv, D)
    _check(tuple(k_vals.shape) == want and tuple(v_vals.shape) == want,
           f"values must be {want}, got {tuple(k_vals.shape)}/"
           f"{tuple(v_vals.shape)}")
    _check(slot.shape[0] == T, "blk and slot differ in length")
    _check(T == 0 or (blk.min() >= 0 and blk.max() < P),
           f"block ids must lie in [0, {P})")
    _check(T == 0 or (slot.min() >= 0 and slot.max() < page),
           f"slots must lie in [0, {page})")
    _check(layer is None or 0 <= layer < L, f"layer {layer} not in [0, {L})")
    if k_pages.device.type == "cpu":
        _ref.paged_scatter_ref(k_pages, v_pages, torch.from_numpy(blk),
                               torch.from_numpy(slot), k_vals, v_vals,
                               layer=layer)
        return
    dev, dt = k_pages.device, k_pages.dtype
    _check(v_pages.device == dev and v_pages.dtype == dt
           and v_pages.shape == k_pages.shape, "K and V pools differ")
    _check(k_pages.is_contiguous() and v_pages.is_contiguous(),
           "page pools must be contiguous")
    k_vals = k_vals.to(device=dev, dtype=dt).contiguous()
    v_vals = v_vals.to(device=dev, dtype=dt).contiguous()
    row_bytes = Hkv * D * k_pages.element_size()
    _check(row_bytes % 16 == 0,
           f"a (Hkv, D) row of {row_bytes} bytes is not a multiple of 16")
    for t in (k_pages, v_pages, k_vals, v_vals):
        _check(t.data_ptr() % 16 == 0, "tensors must be 16-byte aligned")
    if T == 0:
        return
    idx = to_device(np.stack([blk, slot]).astype(np.int32), dev)
    err = _fn("paged_scatter")(
        k_pages.data_ptr(), v_pages.data_ptr(), k_vals.data_ptr(),
        v_vals.data_ptr(), idx[0].data_ptr(), idx[1].data_ptr(),
        0 if layer is None else layer, n_layers, P, page, T, row_bytes,
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "paged_scatter")
    _count("paged_scatter")
