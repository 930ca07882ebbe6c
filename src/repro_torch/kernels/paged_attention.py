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
and pools that :func:`check_scatter_pools` checked once.
``paged_attention(..., write=...)`` is the attention launch with the
layer's new K/V rows folded in (the decode and chunked-prefill write):
it writes them into the pages and reads them where they already are,
through a :class:`WriteIndex` that :func:`write_index` builds once per
forward; the standalone scatter serves every write that no attention
follows.  Each takes the
plain PyTorch version (``kernels/ref.py``) only for tensors that lie on the
CPU; for CUDA tensors it checks what the kernel relies on, launches it on
the current stream, counts the launch in ``build.launch_counts``, and
raises if the launch failed.  There is no fallback from a CUDA tensor to the
plain version.
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading
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


#: the kernel's constants (``csrc/paged_attention.cu``)
WARPS = 4                 # warps a block, one unit of pages each at a time
SLICE = 16                # positions a warp scores at once
MAX_UNITS = _ref.PAGED_MAX_UNITS   # partials per (row, kv head) at most
BLOCKS_PER_SM = 2         # what split_plan aims for
MAX_GD = 2048             # G * D the accumulator registers hold
MAX_SMEM = 232448         # bytes of shared memory a block may use on sm_90


class SplitPlan(NamedTuple):
    """How one launch cuts each (row, kv head) over blocks: ``n_splits``
    blocks (the grid's third axis) and room for ``max_units`` partials in
    the scratch buffer."""
    n_splits: int
    max_units: int


def split_plan(B: int, Hkv: int, max_pages: int, n_sm: int) -> SplitPlan:
    """The launch's split over pages, from shapes only -- never from the
    lengths or the table, which live on the device: about
    ``BLOCKS_PER_SM`` blocks on each of ``n_sm`` SMs, but no more than the
    units a row of ``max_pages`` pages can give the block's warps."""
    max_units = max(1, min(max_pages, MAX_UNITS))
    want = max(1, BLOCKS_PER_SM * n_sm // max(1, B * Hkv))
    return SplitPlan(min(want, -(-max_units // WARPS)), max_units)


#: ``(U, n_units)`` of a row of ``n_live`` live pages: units of U pages, at
#: most MAX_UNITS of them, from the row's length only -- so the kernel's
#: fold, and its bits, do not change with the table's width or the split
row_units = _ref.paged_row_units


def split_pages(plan: SplitPlan, n_live: int):
    """Where the kernel takes each live page of a row: ``[(split, warp,
    unit, pages)]``, the blocks' contiguous unit ranges and each warp's
    every ``WARPS``-th unit, as ``csrc/paged_attention.cu`` walks them."""
    U, n = row_units(n_live)
    per_split = -(-n // plan.n_splits)
    work = []
    for z in range(plan.n_splits):
        for w in range(WARPS):
            for u in range(z * per_split + w, min(n, (z + 1) * per_split),
                           WARPS):
                work.append((z, w, u, list(range(u * U,
                                                 min(n_live, (u + 1) * U)))))
    return work


@functools.lru_cache(maxsize=None)
def smem_bytes(dtype: torch.dtype, G: int, D: int) -> int:
    """The kernel's shared memory for one block (``smem_bytes`` in the
    source): q as f32 rows for G rounded up to 4 heads, each warp's two
    stages of K and V slices (rows padded by 16 bytes), each warp's
    scores and running m, l and correction, and the fold's final m and l
    and per-unit weights of each head."""
    elem = torch.tensor([], dtype=dtype).element_size()
    return (4 * (-(-G // 4) * 4) * D
            + elem * WARPS * 4 * SLICE * (D + 16 // elem)
            + 4 * WARPS * (G * SLICE + 3 * G) + 4 * (2 + MAX_UNITS) * G)


_counters: dict = {}
_counters_lock = threading.Lock()
_n_sm: dict = {}


def _arrival_counters(dev: torch.device, stream: int, n: int) -> torch.Tensor:
    """``n`` int32 arrival counters for the launches on ``stream``,
    zero between launches (the last block of each (row, kv head) resets
    its own).  One buffer per stream, made once and grown with
    ``torch.zeros`` on that stream: launches on one stream run in order,
    so they never share a counter at the same time."""
    key = (dev.index, stream)
    with _counters_lock:
        buf = _counters.get(key)
        if buf is None or buf.numel() < n:
            buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=dev)
            _counters[key] = buf
        return buf


def paged_attention(
    q: torch.Tensor,              # (B, H, D) f32
    k_pages: torch.Tensor,        # (P, page, Hkv, D)
    v_pages: torch.Tensor,        # (P, page, Hkv, D)
    block_table: torch.Tensor,    # (B, max_pages) int32, -1 padded
    lengths: torch.Tensor,        # (B,) int32
    *,
    softcap: float = 0.0,
    scale: Optional[float] = None,
    write: Optional[tuple] = None,
) -> torch.Tensor:
    """Ragged paged attention, ``(B, H, D)`` f32 out.  CPU tensors take
    :func:`~repro_torch.kernels.ref.paged_attention_ref`; CUDA tensors the
    kernel of ``csrc/paged_attention.cu``, split over pages by
    :func:`split_plan`, with its partials in a scratch buffer from
    ``torch.empty``.  Reads neither the lengths nor the table to the host.

    ``write=(index, k_new, v_new, new_lo, new_base)`` folds a write into
    the launch: the T new rows ``k_new``/``v_new`` ``(T, Hkv, D)``, in the
    pages' dtype, land at ``index``'s ``(blk, slot)`` (a
    :class:`ScatterIndex`), and row b reads its positions ``p >=
    new_lo[b]`` from new row ``new_base[b] + p - new_lo[b]`` (``(B,)``
    int32 tensors, from :func:`write_index`).  The caller's contract: that
    row is the one the table names for p, and no row reads a written slot
    below its ``new_lo``.  The result and the pages are then those of
    :func:`paged_scatter_indexed` followed by the attention alone, bit for
    bit; CPU tensors take
    :func:`~repro_torch.kernels.ref.paged_attention_write_ref`.  Counted
    as ``paged_attention+write``."""
    if write is not None:
        _check_write(write, q, k_pages)
    if q.device.type == "cpu":
        if write is not None:
            index, k_new, v_new, _, _ = write
            return _ref.paged_attention_write_ref(
                q, k_pages, v_pages, block_table, lengths, index.idx[0],
                index.idx[1], k_new, v_new, softcap=softcap, scale=scale)
        return _ref.paged_attention_ref(q, k_pages, v_pages, block_table,
                                        lengths, softcap=softcap, scale=scale)
    B, H, D = q.shape
    P, page, Hkv, Dk = k_pages.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    dev = q.device
    # messages are str.format patterns, filled only on a failure: these
    # checks run on every layer's launch
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages),
                    ("block_table", block_table), ("lengths", lengths)):
        check(t.device == dev, "{} on {}, q on {}", name, t.device, dev)
        check(t.is_contiguous(), "{} must be contiguous", name)
    check(q.dtype == torch.float32 and q.is_contiguous(),
          "q must be contiguous float32")
    check(k_pages.dtype in _PAGE_DTYPES and v_pages.dtype == k_pages.dtype,
          "pages must be float32 or bfloat16, got {}/{}", k_pages.dtype,
          v_pages.dtype)
    check(v_pages.shape == k_pages.shape and Dk == D,
          "kernel takes Dv == D: q {}, k_pages {}, v_pages {}",
          tuple(q.shape), tuple(k_pages.shape), tuple(v_pages.shape))
    check(H % Hkv == 0, "H={} is not a multiple of Hkv={}", H, Hkv)
    check(block_table.dtype == torch.int32 and block_table.dim() == 2
          and block_table.shape[0] == B, "block_table must be (B, n) int32")
    check(lengths.dtype == torch.int32 and lengths.shape == (B,),
          "lengths must be (B,) int32")
    elem = k_pages.element_size()
    G = H // Hkv
    check(D * elem % 16 == 0 and G * D <= MAX_GD,
          "kernel takes rows of a multiple of 16 bytes and G * D <= {}: "
          "D={} ({}), G={}", MAX_GD, D, k_pages.dtype, G)
    check(k_pages.data_ptr() % 16 == 0 and v_pages.data_ptr() % 16 == 0,
          "page pools must be 16-byte aligned")
    smem = smem_bytes(k_pages.dtype, G, D)
    check(smem <= MAX_SMEM, "G={}, D={} in {} needs {} bytes of shared "
          "memory, more than {}", G, D, k_pages.dtype, smem, MAX_SMEM)
    check(B <= 2 ** 31 - 1 and Hkv <= 65535, "grid ({}, {}) too large", B,
          Hkv)
    out = torch.empty((B, H, D), dtype=torch.float32, device=dev)
    if B == 0:
        return out
    n_sm = _n_sm.get(dev.index)
    if n_sm is None:
        n_sm = _n_sm.setdefault(
            dev.index, torch.cuda.get_device_properties(dev)
            .multi_processor_count)
    plan = split_plan(B, Hkv, block_table.shape[1], n_sm)
    part = torch.empty((B, Hkv, plan.max_units, G * (D + 2)),
                       dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    counters = _arrival_counters(dev, stream, B * Hkv)
    new = [None] * 6 + [0]
    if write is not None:
        index, k_new, v_new, new_lo, new_base = write
        ptr = index.idx.data_ptr()
        new = [k_new.data_ptr(), v_new.data_ptr(), ptr, ptr + 4 * index.T,
               new_lo.data_ptr(), new_base.data_ptr(), index.T]
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    err = build.entry("paged_attention",
                      [i] + [p] * 14 + [i] * 10 + [f, f, p])(
        _PAGE_DTYPES[k_pages.dtype], q.data_ptr(), k_pages.data_ptr(),
        v_pages.data_ptr(), block_table.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), part.data_ptr(), counters.data_ptr(), *new, B, H,
        Hkv, D, P, page, block_table.shape[1], plan.max_units,
        plan.n_splits, float(scale), float(softcap or 0.0), stream)
    name = "paged_attention" if write is None else "paged_attention+write"
    raise_on(err, name)
    count(name)
    return out


def _check_write(write, q, k_pages) -> None:
    """What the fused write relies on, on any device: the five parts,
    new rows ``(T, Hkv, D)`` in the pages' dtype on their device,
    contiguous, a :class:`ScatterIndex` of T rows there, ``(B,)`` int32
    ``new_lo``/``new_base``, and at least one row for the launch's blocks
    to write from; on a CUDA device also 16-byte aligned new rows (the
    pools' rows the attention checks).  Messages are formatted only on a
    failure: this runs on every layer's launch."""
    check(isinstance(write, tuple) and len(write) == 5,
          "write must be (index, k_new, v_new, new_lo, new_base)")
    index, k_new, v_new, new_lo, new_base = write
    check(isinstance(index, ScatterIndex), "write's index must be a "
          "ScatterIndex (scatter_index / write_index)")
    B, T = q.shape[0], index.T
    dev, dt = k_pages.device, k_pages.dtype
    want = (T, k_pages.shape[2], k_pages.shape[3])
    for name, t in (("k_new", k_new), ("v_new", v_new)):
        check(t.shape == want, "{} must be {}, got {}", name, want,
              t.shape)
        check(t.dtype == dt, "{} must be in the pages' dtype {}, got {}",
              name, dt, t.dtype)
        check(t.device == dev and t.is_contiguous(),
              "{} must be contiguous on {}", name, dev)
    for name, t in (("new_lo", new_lo), ("new_base", new_base)):
        check(t.dtype == torch.int32 and t.shape == (B,) and t.device == dev
              and t.is_contiguous(), "{} must be ({},) int32 on {}", name,
              B, dev)
    check(index.idx.device == dev and index.idx.shape == (2, T)
          and index.idx.is_contiguous(), "write's index must be (2, {}) on "
          "{}", T, dev)
    check(B > 0 or T == 0, "a write needs a row to launch from")
    if dev.type == "cuda":
        check(k_new.data_ptr() % 16 == 0 and v_new.data_ptr() % 16 == 0,
              "new rows must be 16-byte aligned")


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
    blk, slot = _checked(blk, slot, num_blocks, page)
    return ScatterIndex(to_device(np.stack([blk, slot]).astype(np.int32),
                                  device), blk.shape[0])


def _checked(blk, slot, num_blocks: int, page: int):
    """``blk``/``slot`` as int64 vectors, checked in range."""
    blk = np.asarray(blk, np.int64).reshape(-1)
    slot = np.asarray(slot, np.int64).reshape(-1)
    T = blk.shape[0]
    check(slot.shape[0] == T, "blk and slot differ in length")
    check(T == 0 or (blk.min() >= 0 and blk.max() < num_blocks),
          f"block ids must lie in [0, {num_blocks})")
    check(T == 0 or (slot.min() >= 0 and slot.max() < page),
          f"slots must lie in [0, {page})")
    return blk, slot


class WriteIndex(NamedTuple):
    """A fused write's index, from one upload: the new rows'
    :class:`ScatterIndex` and each attention row's ``new_lo`` (its first
    position held by a new row) and ``new_base`` (that new row), ``(B,)``
    int32 on the pages' device."""
    index: ScatterIndex
    new_lo: torch.Tensor
    new_base: torch.Tensor


def write_index(blk, slot, new_lo, new_base, *, num_blocks: int, page: int,
                device) -> WriteIndex:
    """:func:`scatter_index` of the T new rows and the B rows' ``new_lo``
    / ``new_base``, checked on the host (``new_lo >= 0``, ``new_base`` in
    ``[0, T)``) and uploaded as one int32 buffer."""
    blk, slot = _checked(blk, slot, num_blocks, page)
    lo = np.asarray(new_lo, np.int64).reshape(-1)
    base = np.asarray(new_base, np.int64).reshape(-1)
    T, B = blk.shape[0], lo.shape[0]
    check(base.shape[0] == B, "new_lo and new_base differ in length")
    check(B == 0 or (lo.min() >= 0 and base.min() >= 0
                     and base.max() < max(T, 1)),
          f"new_lo must be >= 0 and new_base in [0, {T})")
    buf = to_device(np.concatenate([blk, slot, lo, base]).astype(np.int32),
                    device)
    return WriteIndex(ScatterIndex(buf[:2 * T].view(2, T), T),
                      buf[2 * T:2 * T + B], buf[2 * T + B:])


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
