"""Paged KV store: the physical half of the POP-managed block pool.

:class:`~repro_torch.runtime.block_pool.BlockPool` owns block *identity* --
allocation, ownership, reader sessions, and (through the pluggable
:class:`~repro_torch.runtime.reclaim.ReclaimPolicy`) the decision of when a
retired block may be recycled.  :class:`PagedKVStore` owns the block
*contents*: one physical K page and one V page per (layer, block id), laid
out as the paged-attention kernel reads them -- ``(num_blocks, page, Hkv,
hd)`` per layer -- so a decode step gathers shared prefix pages through the
block table instead of replaying a per-request dense cache.

Lifecycle of a physical page (the paper's retire/ping/free cycle):

    allocate ── the pool hands the block id to an engine; ``on_alloc``
                clears the poison mark and zeroes the page
    write    ── chunked prefill (``write_prefill``) or the batched decode
                append (``append_tokens``) fill slots; shared-prefix pages
                are written ONCE by whichever engine prefilled them
    share    ── the block id enters the pool's prefix cache; readers gather
                the same physical page through their block tables, no copy
    retire   ── last reference drops; the block waits on the retired list
                while the SMR policy proves no reader session spans it
    poison   ── the policy frees the block (``on_free``): the store marks
                the id and fills the page with a huge finite sentinel
                (``POISON``), so a freed-then-read gather trips a hard
                :class:`~repro_torch.core.sim.engine.UseAfterFree`
    recycle  ── the pool re-allocates the id; ``on_alloc`` un-poisons it

WHERE the pages live is the ``storage`` seam:

* ``storage="device"`` -- one contiguous ``(L, num_blocks, page, Hkv, hd)``
  tensor each for K and V on the store's device, updated IN PLACE.  Every
  token write is one launch of the page-scatter kernel (one per layer, or
  one for all layers with ``layer=None``), through a scatter index that a
  forward builds once (:meth:`scatter_index`, :meth:`token_index`) and
  hands to every layer's write; ``layer_pages`` returns the
  zero-copy views ``k[li]``/``v[li]``, so a steady-state decode step moves
  no host->device KV bytes.  The zero and poison fills are
  ``index_fill_`` on the same stream.
* ``storage="host"`` -- the same tensors in host memory.  Cheap to write,
  but every read uploads the whole layer to the device: O(pool) bytes per
  layer per step.  Kept as the reference storage and for A/B measurement.

Both meter data movement: ``bytes_h2d`` counts host->device KV bytes
(host storage: every layer read; device storage: only host-sourced writes),
``bytes_d2h`` the reverse (host storage: every write of device-computed
K/V).  Index vectors and token ids are O(batch) scalars and not counted:
the metric is KV *payload* traffic.

Stream order is part of the SMR contract: every page write, read and fill
goes on the one current CUDA stream, so a fill issued after a reader's
kernel runs after it.
"""

from __future__ import annotations

import contextlib
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.bridge import numpy_to_tensor
from repro_torch.core.sim.engine import UseAfterFree
from repro_torch.kernels import ops as kops
from repro_torch.kernels.paged_attention import (ScatterIndex,
                                                build_block_table,
                                                check_scatter_pools,
                                                scatter_index, to_device)
from repro_torch.models.layers import torch_dtype

__all__ = ["PagedKVStore", "kv_layer_order"]


def kv_layer_order(cfg) -> List[Tuple[int, int, int]]:
    """Global layer enumeration ``[(group, pattern_pos, repeat), ...]`` in
    execution order -- the order the paged forward indexes physical layers
    by."""
    order: List[Tuple[int, int, int]] = []
    for gi, g in enumerate(cfg.groups):
        for rep in range(g.repeats):
            for pi in range(len(g.pattern)):
                order.append((gi, pi, rep))
    return order


class PagedKVStore:
    """Physical page tensors for K and V, keyed by BlockPool block ids.

    Thread-safe for the serving runtime's access pattern: every block is
    written by exactly one engine (its owner) while it is live, and the
    poison/unpoison transitions are serialized by the pool's free-list lock
    (the listeners fire inside pool operations).  A small internal lock
    guards the poison set so ``assert_alive`` can run from any reader;
    device storage additionally serializes its writes behind
    :meth:`write_guard`.

    ``device`` is where the kernels run (``cuda`` unless given);
    ``storage`` where the pages live (see the module docstring);
    ``scatter_impl`` ("torch" | "cuda" | None) picks the write primitive
    (None: the kernel on a CUDA device, the plain version on the CPU).
    """

    #: freed-page fill value (finite on purpose; see :meth:`on_free`)
    POISON = 1e9

    def __init__(self, cfg, num_blocks: int, page_size: int, dtype=None,
                 storage: str = "host", device=None,
                 scatter_impl: Optional[str] = None):
        if storage not in ("host", "device"):
            raise ValueError(
                f"storage must be 'host' or 'device', got {storage!r}")
        self.cfg = cfg
        self.num_blocks = num_blocks
        self.page = page_size
        self.storage = storage
        self.device = torch.device(device if device is not None else "cuda")
        self.scatter_impl = kops.resolve_impl(scatter_impl, self.device)
        self.layer_order = kv_layer_order(cfg)
        L = len(self.layer_order)
        Hkv, hd = cfg.n_kv_heads, cfg.head_dim_
        # pages live in the MODEL dtype, so the paged path stores exactly
        # the values the dense cache would
        self.dtype = torch_dtype(cfg.dtype if dtype is None else dtype)
        home = self.device if storage == "device" else torch.device("cpu")
        shape = (L, num_blocks, page_size, Hkv, hd)
        self._k = torch.zeros(shape, dtype=self.dtype, device=home)
        self._v = torch.zeros(shape, dtype=self.dtype, device=home)
        if home.type == "cuda":
            # what the scatter kernel relies on, once: its per-layer calls
            # check only the values
            check_scatter_pools(self._k, self._v)
        self._guard = (threading.RLock() if storage == "device"
                       else contextlib.nullcontext())
        self._lock = threading.Lock()
        self._poisoned: set = set()
        self._bytes_h2d = 0
        self._bytes_d2h = 0
        # observability: the benchmark's bytes-moved axes read these
        self.bytes_written = 0          # KV bytes physically written
        self.poisons = 0                # pages poisoned (freed under the store)
        self.index_builds = 0           # scatter indices built (and uploaded)
        self.token_bytes = int(2 * L * Hkv * hd * self._k.element_size())

    # ------------------------------------------------------------------
    # physical storage
    # ------------------------------------------------------------------

    def _tensor(self, x) -> torch.Tensor:
        """Write input -> tensor on the pages' side, metering the copy."""
        home = self._k.device
        if isinstance(x, np.ndarray):
            if home.type != "cpu":
                self._bytes_h2d += int(x.nbytes)
            return numpy_to_tensor(x, home)
        if self.storage == "host":
            # device-computed K/V come down to the host first: the d2h half
            # of the host storage's per-token round trip
            self._bytes_d2h += int(x.numel() * x.element_size())
        elif x.device != home:
            self._bytes_h2d += int(x.numel() * x.element_size())
        return x.to(home)

    def _scatter(self, layer, index: ScatterIndex, k, v) -> None:
        with self._guard:
            k, v = self._tensor(k), self._tensor(v)
            impl = self.scatter_impl if self.storage == "device" else "torch"
            kops.paged_scatter(self._k, self._v, index, k, v,
                               layer=layer, impl=impl)

    def _fill(self, blocks, value: float) -> None:
        bl = list(blocks)
        if not bl:
            return
        idx = to_device(np.asarray(bl, np.int64), self._k.device)
        with self._guard:
            self._k.index_fill_(1, idx, value)
            self._v.index_fill_(1, idx, value)

    # ------------------------------------------------------------------
    # pool listener hooks (wired via BlockPool.add_block_listener)
    # ------------------------------------------------------------------

    def on_alloc(self, blocks: Sequence[int]) -> None:
        """A block id left the free list: its previous life is over, the new
        owner may write.  Clearing the mark here (not at write time) keeps
        ``assert_alive`` honest for tail pages that are allocated but not
        yet written; zeroing keeps not-yet-written slots inert."""
        with self._lock:
            self._poisoned.difference_update(blocks)
            self._fill(blocks, 0.0)

    def on_free(self, blocks: Sequence[int]) -> None:
        """The reclaim policy freed the block -- safely, or, under
        :class:`~repro_torch.runtime.reclaim.UnsafeEagerPolicy`, out from
        under live readers.  Either way the page is dead: mark it so a stale
        gather is a hard error, and fill it with a huge FINITE sentinel (not
        NaN: a NaN would leak through masked lanes as 0 * NaN) so junk read
        past a bypassed checker shows up as blown-out logits."""
        with self._lock:
            self._poisoned.update(blocks)
            self._fill(blocks, self.POISON)
            self.poisons += len(blocks)

    # ------------------------------------------------------------------
    # writes (owner-engine only)
    # ------------------------------------------------------------------

    def scatter_index(self, blk: Sequence[int],
                      slot: Sequence[int]) -> ScatterIndex:
        """Token t's destination ``(blk[t], slot[t])``, range-checked and
        uploaded to the pages' device once, for as many writes as the
        caller makes with it (one per layer of a forward).  The upload goes
        on the current stream, ahead of those writes."""
        with self._lock:
            self.index_builds += 1
        return scatter_index(blk, slot, num_blocks=self.num_blocks,
                             page=self.page, device=self._k.device)

    def token_index(self, blocks: Sequence[int], start: int,
                    T: int) -> ScatterIndex:
        """:meth:`scatter_index` of T consecutive positions from ``start``,
        through the request's page list ``blocks``."""
        pos = np.arange(start, start + T)
        blk = np.asarray(blocks, np.int64)[pos // self.page]
        return self.scatter_index(blk, pos % self.page)

    def write_prefill(self, blocks: Sequence[int], k, v,
                      start: int = 0, layer: Optional[int] = None, *,
                      index: Optional[ScatterIndex] = None) -> int:
        """Write a token range into ``blocks``: ``k``/``v`` are
        ``(L, T, Hkv, hd)`` post-rope K/V of T consecutive tokens from
        sequence position ``start`` (or ``(T, Hkv, hd)`` of one ``layer``).
        ``blocks`` is the request's page list from position 0; ``index``,
        where given, is its :meth:`token_index` for this range, built once
        for every layer.  One scatter launch either way.  Returns the
        number of bytes written."""
        T = k.shape[1] if layer is None else k.shape[0]
        if index is None:
            index = self.token_index(blocks, start, T)
        self._scatter(layer, index, k, v)
        nl = len(self.layer_order) if layer is None else 1
        written = int(2 * T * nl * (self.token_bytes //
                                    (2 * len(self.layer_order))))
        self.bytes_written += written
        return written

    def append_token(self, block: int, slot: int, k, v,
                     layer: Optional[int] = None) -> int:
        """Write one decoded token's K/V into ``block`` at ``slot`` -- a
        single-slot scatter.  With ``layer=None`` the arrays are ``(L, Hkv,
        hd)`` and every layer is written; with a layer index they are
        ``(Hkv, hd)``.  Batched decode steps should prefer
        :meth:`append_tokens` (one scatter for the whole batch row-set)."""
        index = self.scatter_index([block], [slot])
        if layer is None:
            self._scatter(None, index, k[:, None], v[:, None])
        else:
            self._scatter(layer, index, k[None], v[None])
        written = 2 * int(np.prod(k.shape)) * self._k.element_size()
        self.bytes_written += written
        return written

    def append_tokens(self, blocks: Sequence[int], slots: Sequence[int],
                      k, v, layer: int, *,
                      index: Optional[ScatterIndex] = None) -> int:
        """Batched decode append: token b lands in ``blocks[b]`` slot
        ``slots[b]`` of ``layer``.  ``k``/``v`` are ``(B, Hkv, hd)`` -- ONE
        scatter for the whole ragged batch.  ``index``, where given, is
        ``scatter_index(blocks, slots)``, built once for every layer."""
        if index is None:
            index = self.scatter_index(blocks, slots)
        self._scatter(layer, index, k, v)
        written = 2 * int(k.numel()) * self._k.element_size()
        self.bytes_written += written
        return written

    def write_guard(self):
        """Held by the paged forward across its per-layer write -> fetch ->
        kernel-launch window: an RLock on device storage (writers issue in
        turn), a no-op on host storage."""
        return self._guard

    def sync(self) -> None:
        """Wait until every issued device write has landed."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------
    # reads (any engine holding a reservation)
    # ------------------------------------------------------------------

    def assert_alive(self, engine: int, blocks: Sequence[int]) -> None:
        """The physical-page use-after-free tripwire: raise if any block a
        reader is about to gather was freed (poisoned) under it."""
        with self._lock:
            bad = self._poisoned.intersection(blocks)
        if bad:
            raise UseAfterFree(engine, min(bad), "kv-gather")

    def gather_table(self, blocks: Sequence[Sequence[int]],
                     lengths: Sequence[int], *, min_pages: int = 1):
        """Padded int32 block table and lengths on the store's device (see
        :func:`repro_torch.kernels.paged_attention.build_block_table`)."""
        return build_block_table(blocks, lengths, page=self.page,
                                 min_pages=min_pages, device=self.device)

    def layer_pages(self, layer: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """The ``(num_blocks, page, Hkv, hd)`` K and V pages of one layer on
        the store's device: views of the resident tensors on device storage
        (zero bytes moved), an upload of the layer on host storage."""
        k, v = self._k[layer], self._v[layer]
        if self.storage == "host":
            # the host storage's read tax: one full-layer upload per call
            self._bytes_h2d += 2 * int(k.numel()) * k.element_size()
            k, v = k.to(self.device), v.to(self.device)
        return k, v

    # whole-pool views (tests/debugging): the live tensors, not copies

    @property
    def k(self) -> torch.Tensor:
        return self._k

    @property
    def v(self) -> torch.Tensor:
        return self._v

    # ------------------------------------------------------------------
    # observability
    # ------------------------------------------------------------------

    @property
    def bytes_h2d(self) -> int:
        """Host->device KV bytes moved through the store (0 in steady-state
        decode on device storage)."""
        return self._bytes_h2d

    @property
    def bytes_d2h(self) -> int:
        """Device->host KV bytes (host storage pays it for every write)."""
        return self._bytes_d2h

    @property
    def poisoned_blocks(self) -> int:
        with self._lock:
            return len(self._poisoned)

    def is_poisoned(self, block: int) -> bool:
        with self._lock:
            return block in self._poisoned

    @property
    def nbytes(self) -> int:
        """Total physical pool footprint (constant)."""
        return 2 * int(self._k.numel()) * self._k.element_size()
