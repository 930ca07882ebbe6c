"""Paged attention and the page scatter: the CUDA kernels of the paged KV
pool, their wrappers, and the block-table layout they read.

:func:`build_block_table` packs ragged per-request block lists into the
padded ``(B, max_pages)`` int32 table the attention kernel walks -- width
is the BATCH max, not the engine max, and trailing pre-allocated but
unwritten pages are dead entries (-1).

:func:`paged_attention` and :func:`paged_scatter` are the wrappers of
``csrc/paged_attention.cu`` and ``csrc/paged_scatter.cu``;
:func:`paged_scatter_indexed` is the scatter's per-layer form, through a
:class:`ScatterIndex` that :func:`scatter_index` builds once per forward
and pools that :func:`check_scatter_pools` checked once.  Each takes the
plain PyTorch version (``kernels/ref.py``) only for tensors that lie on the
CPU; for CUDA tensors it checks what the kernel relies on, launches it on
the current stream, counts the launch in ``build.launch_counts``, and
raises if the launch failed.  There is no fallback from a CUDA tensor to the
plain version.
"""

from __future__ import annotations

import ctypes
import math
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.build import check, count, raise_on

_PAGE_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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
        check(t.device == dev, f"{name} on {t.device}, q on {dev}")
        check(t.is_contiguous(), f"{name} must be contiguous")
    check(q.dtype == torch.float32 and q.is_contiguous(),
          "q must be contiguous float32")
    check(k_pages.dtype in _PAGE_DTYPES and v_pages.dtype == k_pages.dtype,
          f"pages must be float32 or bfloat16, got {k_pages.dtype}/"
          f"{v_pages.dtype}")
    check(v_pages.shape == k_pages.shape and Dk == D,
          f"kernel takes Dv == D: q {tuple(q.shape)}, k_pages "
          f"{tuple(k_pages.shape)}, v_pages {tuple(v_pages.shape)}")
    check(H % Hkv == 0, f"H={H} is not a multiple of Hkv={Hkv}")
    check(block_table.dtype == torch.int32 and block_table.dim() == 2
          and block_table.shape[0] == B, "block_table must be (B, n) int32")
    check(lengths.dtype == torch.int32 and tuple(lengths.shape) == (B,),
          "lengths must be (B,) int32")
    out = torch.empty((B, H, D), dtype=torch.float32, device=dev)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    err = build.entry("paged_attention",
                      [i, p, p, p, p, p, p, i, i, i, i, i, i, i, f, f, p])(
        _PAGE_DTYPES[k_pages.dtype], q.data_ptr(), k_pages.data_ptr(),
        v_pages.data_ptr(), block_table.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), B, H, Hkv, D, P, page, block_table.shape[1],
        float(scale), float(softcap or 0.0),
        torch.cuda.current_stream(dev).cuda_stream)
    raise_on(err, "paged_attention")
    count("paged_attention")
    return out


class ScatterIndex(NamedTuple):
    """The ``(blk, slot)`` destinations of T tokens, range-checked once, as
    one ``(2, T)`` int32 tensor on the pages' device (row 0 the page ids,
    row 1 the slots).  A forward builds it once and hands it to every
    layer's write."""
    idx: torch.Tensor
    T: int


def scatter_index(blk, slot, *, num_blocks: int, page: int,
                  device) -> ScatterIndex:
    """Check ``blk`` in ``[0, num_blocks)`` and ``slot`` in ``[0, page)`` on
    the host and upload them as one :class:`ScatterIndex`.

    On a CUDA device the upload goes through a fresh pinned buffer on the
    current stream (:func:`to_device`), ahead of every scatter that reads
    it; PyTorch's caching host allocator keeps that buffer until the copy
    has run, so a later forward's index never lands under this one's."""
    blk = np.asarray(blk, np.int64).reshape(-1)
    slot = np.asarray(slot, np.int64).reshape(-1)
    T = blk.shape[0]
    check(slot.shape[0] == T, "blk and slot differ in length")
    check(T == 0 or (blk.min() >= 0 and blk.max() < num_blocks),
          f"block ids must lie in [0, {num_blocks})")
    check(T == 0 or (slot.min() >= 0 and slot.max() < page),
          f"slots must lie in [0, {page})")
    return ScatterIndex(to_device(np.stack([blk, slot]).astype(np.int32),
                                  device), T)


def check_scatter_pools(k_pages: torch.Tensor, v_pages: torch.Tensor) -> None:
    """What the scatter kernel relies on in the ``(L, P, page, Hkv, D)``
    pools: one device, dtype and shape, contiguous, 16-byte aligned, and a
    ``(Hkv, D)`` row a multiple of 16 bytes.  Properties of the two
    tensors, checked once where they are made (``PagedKVStore``)."""
    check(k_pages.dim() == 5, "page pools must be (L, P, page, Hkv, D)")
    check(v_pages.device == k_pages.device and v_pages.dtype == k_pages.dtype
          and v_pages.shape == k_pages.shape, "K and V pools differ")
    check(k_pages.is_contiguous() and v_pages.is_contiguous(),
          "page pools must be contiguous")
    row_bytes = k_pages.shape[3] * k_pages.shape[4] * k_pages.element_size()
    check(row_bytes % 16 == 0,
          f"a (Hkv, D) row of {row_bytes} bytes is not a multiple of 16")
    check(k_pages.data_ptr() % 16 == 0 and v_pages.data_ptr() % 16 == 0,
          "tensors must be 16-byte aligned")


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
    pages' dtype first.  Checks the pools and the indices, then
    :func:`paged_scatter_indexed`: CPU pages take
    :func:`~repro_torch.kernels.ref.paged_scatter_ref`, CUDA pages one
    launch of ``csrc/paged_scatter.cu``."""
    if k_pages.device.type != "cpu":
        check_scatter_pools(k_pages, v_pages)
    index = scatter_index(blk, slot, num_blocks=k_pages.shape[1],
                          page=k_pages.shape[2], device=k_pages.device)
    paged_scatter_indexed(k_pages, v_pages, index, k_vals, v_vals,
                          layer=layer)


def paged_scatter_indexed(
    k_pages: torch.Tensor,        # (L, P, page, Hkv, D), written in place
    v_pages: torch.Tensor,
    index: ScatterIndex,          # from scatter_index, on the pages' device
    k_vals: torch.Tensor,         # (T, Hkv, D) with a layer, else (L, T, ...)
    v_vals: torch.Tensor,
    *,
    layer: Optional[int] = None,
) -> None:
    """:func:`paged_scatter` through a prepared index: checks the values'
    shapes and the layer, then launches.  The pools are taken as
    :func:`check_scatter_pools` passed them and the index as
    :func:`scatter_index` checked it."""
    L, P, page, Hkv, D = k_pages.shape
    T = index.T
    want = (T, Hkv, D) if layer is not None else (L, T, Hkv, D)
    check(tuple(k_vals.shape) == want and tuple(v_vals.shape) == want,
          f"values must be {want}, got {tuple(k_vals.shape)}/"
          f"{tuple(v_vals.shape)}")
    check(layer is None or 0 <= layer < L, f"layer {layer} not in [0, {L})")
    if k_pages.device.type == "cpu":
        _ref.paged_scatter_ref(k_pages, v_pages, index.idx[0], index.idx[1],
                               k_vals, v_vals, layer=layer)
        return
    dev, dt = k_pages.device, k_pages.dtype
    check(index.idx.device == dev, f"index on {index.idx.device}, pages on "
          f"{dev}")
    if k_vals.dtype != dt or k_vals.device != dev:
        k_vals = k_vals.to(device=dev, dtype=dt)
    if v_vals.dtype != dt or v_vals.device != dev:
        v_vals = v_vals.to(device=dev, dtype=dt)
    k_vals, v_vals = k_vals.contiguous(), v_vals.contiguous()
    check(k_vals.data_ptr() % 16 == 0 and v_vals.data_ptr() % 16 == 0,
          "tensors must be 16-byte aligned")
    if T == 0:
        return
    ptr = index.idx.data_ptr()
    p, i = ctypes.c_void_p, ctypes.c_int
    err = build.entry("paged_scatter", [p, p, p, p, p, p, i, i, i, i, i, i, p])(
        k_pages.data_ptr(), v_pages.data_ptr(), k_vals.data_ptr(),
        v_vals.data_ptr(), ptr, ptr + 4 * T,
        0 if layer is None else layer, L if layer is None else 1, P, page, T,
        Hkv * D * k_pages.element_size(),
        torch.cuda.current_stream(dev).cuda_stream)
    raise_on(err, "paged_scatter")
    count("paged_scatter")
