"""The port's PagedKVStore against the reference store: poison-on-free
tripwires, zero-on-realloc, the same page contents after the same writes,
and zero host->device KV bytes in steady-state decode on device storage.

Mirrors ``tests/test_kv_store.py`` (the physical-page use-after-free and
device-residency sections), on the CPU.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.configs.base import ArchConfig as JArch
from repro.configs.base import dense_stack as j_stack
from repro.runtime.kv_store import PagedKVStore as JStore
from repro_torch.bridge import numpy_to_tensor
from repro_torch.configs.base import ArchConfig, dense_stack
from repro_torch.core.sim.engine import UseAfterFree
from repro_torch.models.model import init_params
from repro_torch.runtime.block_pool import BlockPool
from repro_torch.runtime.kv_store import PagedKVStore, kv_layer_order
from repro_torch.runtime.reclaim import UnsafeEagerPolicy
from repro_torch.serve.paged_model import (paged_decode_step,
                                           prefill_chunk_step,
                                           prefill_kv_chunked)

PAGE = 4
KW = dict(name="kv-plain", d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
          vocab=64, remat="none", dtype="float32")
CFG = ArchConfig(groups=dense_stack(2), **KW)
JCFG = JArch(groups=j_stack(2), **KW)


def _store(storage, n=8, cfg=CFG, **kw):
    return PagedKVStore(cfg, n, PAGE, storage=storage, device="cpu", **kw)


@pytest.mark.parametrize("storage", ["host", "device"])
def test_poison_on_unsafe_free_trips_gather(storage):
    """A freed-then-gathered page is a hard UseAfterFree, and the page
    itself holds the poison value."""
    pool = BlockPool(8, n_engines=2, policy=UnsafeEagerPolicy())
    store = _store(storage, pool.num_blocks)
    pool.add_block_listener(store)
    blocks = pool.allocate(0, 2)
    L = len(kv_layer_order(CFG))
    store.write_prefill(blocks, np.ones((L, PAGE, 2, 8), np.float32),
                        np.ones((L, PAGE, 2, 8), np.float32))
    pool.reserve(1, blocks)
    store.assert_alive(1, blocks)              # still live: no error
    pool.retire(0, blocks)                     # unsafe: freed immediately
    assert all(store.is_poisoned(b) for b in blocks)
    with pytest.raises(UseAfterFree):
        store.assert_alive(1, blocks)
    assert float(store.k[:, blocks[0]].max()) >= PagedKVStore.POISON
    assert store.poisons == 2


def test_safe_policy_keeps_pages_alive_under_session():
    """Under the default EpochPOP policy the open reader session pins the
    retired blocks; they are poisoned only after it closes."""
    pool = BlockPool(8, n_engines=2, reclaim_threshold=1, pressure_factor=1,
                     ping_timeout_s=0.2)
    store = _store("device", pool.num_blocks)
    pool.add_block_listener(store)
    pool.start_step(1)
    blocks = pool.allocate(0, 2)
    pool.reserve(1, blocks)
    pool.retire(0, blocks)
    pool.reclaim(0)
    store.assert_alive(1, blocks)
    assert not any(store.is_poisoned(b) for b in blocks)
    pool.end_step(1)
    pool.reclaim(0)
    assert all(store.is_poisoned(b) for b in blocks)
    with pytest.raises(UseAfterFree):
        store.assert_alive(1, blocks)


@pytest.mark.parametrize("storage", ["host", "device"])
def test_realloc_unpoisons_and_zeroes(storage):
    pool = BlockPool(2, n_engines=1, policy=UnsafeEagerPolicy())
    store = _store(storage, pool.num_blocks)
    pool.add_block_listener(store)
    blocks = pool.allocate(0, 2)
    pool.retire(0, blocks)                     # freed + poisoned
    assert float(store.k.max()) == PagedKVStore.POISON
    again = pool.allocate(0, 2)                # recycled ids
    assert sorted(again) == sorted(blocks)
    store.assert_alive(0, again)
    assert float(store.k.abs().max()) == 0.0
    assert float(store.v.abs().max()) == 0.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("storage", ["host", "device"])
def test_pages_match_reference_store(storage, dtype):
    """The same writes -- a whole-prompt prefill over every layer, a
    per-layer chunk at ``start=``, a batched decode append -- leave the
    same page contents as the reference store's ``stacked()`` view, bit
    for bit."""
    rng = np.random.default_rng(21)
    L, Hkv, hd = len(kv_layer_order(CFG)), CFG.n_kv_heads, CFG.head_dim_
    mine = _store(storage, dtype=dtype)
    ref = JStore(JCFG, 8, PAGE, dtype=jnp.dtype(dtype), storage=storage)

    def vals(*shape):
        a = np.asarray(jnp.asarray(rng.standard_normal(shape), dtype))
        return a, numpy_to_tensor(a)

    k, kt = vals(L, 6, Hkv, hd)
    v, vt = vals(L, 6, Hkv, hd)
    ref.write_prefill([3, 1], k, v)
    mine.write_prefill([3, 1], kt, vt)
    k, kt = vals(3, Hkv, hd)
    v, vt = vals(3, Hkv, hd)
    ref.write_prefill([3, 1, 6], k, v, start=6, layer=1)
    mine.write_prefill([3, 1, 6], kt, vt, start=6, layer=1)
    k, kt = vals(2, Hkv, hd)
    v, vt = vals(2, Hkv, hd)
    ref.append_tokens([6, 0], [1, 2], k, v, layer=0)
    mine.append_tokens([6, 0], [1, 2], kt, vt, layer=0)
    for got, want in ((mine.k, ref.k), (mine.v, ref.v)):
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32))
    assert mine.bytes_written == ref.bytes_written
    assert mine.token_bytes == ref.token_bytes


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layer", [1, None])
def test_prepared_index_pages_match_numpy_index_and_reference_store(layer,
                                                                    dtype):
    """Writes through an index built once (``token_index`` /
    ``scatter_index``, reused for two writes as a forward reuses it per
    layer) leave pages bit-identical to the numpy-index path's and to the
    reference store's."""
    rng = np.random.default_rng(22)
    L, Hkv, hd = len(kv_layer_order(CFG)), CFG.n_kv_heads, CFG.head_dim_
    prepared, plain = _store("device", dtype=dtype), _store("device",
                                                           dtype=dtype)
    ref = JStore(JCFG, 8, PAGE, dtype=jnp.dtype(dtype), storage="device")
    lead = (L,) if layer is None else ()

    def vals(T):
        a = np.asarray(jnp.asarray(rng.standard_normal((*lead, T, Hkv, hd)),
                                   dtype))
        return a, numpy_to_tensor(a)

    blocks = [5, 2, 7]
    index = prepared.token_index(blocks, 3, 6)
    for _ in range(2):
        (k, kt), (v, vt) = vals(6), vals(6)
        ref.write_prefill(blocks, k, v, start=3, layer=layer)
        plain.write_prefill(blocks, kt, vt, start=3, layer=layer)
        prepared.write_prefill(blocks, kt, vt, start=3, layer=layer,
                               index=index)
    blk, slot = [6, 0, 4], [1, 3, 0]
    index = prepared.scatter_index(blk, slot)
    (k, kt), (v, vt) = vals(3), vals(3)
    if layer is None:
        ref.write_prefill([6], k[:, :1], v[:, :1], start=1)   # one token
        plain.write_prefill([6], kt[:, :1], vt[:, :1], start=1)
        prepared.write_prefill([6], kt[:, :1], vt[:, :1], start=1,
                               index=prepared.scatter_index([6], [1]))
    else:
        ref.append_tokens(blk, slot, k, v, layer=layer)
        plain.append_tokens(blk, slot, kt, vt, layer=layer)
        prepared.append_tokens(blk, slot, kt, vt, layer=layer, index=index)
    for a, b, want in ((prepared.k, plain.k, ref.k),
                       (prepared.v, plain.v, ref.v)):
        assert torch.equal(a, b)
        np.testing.assert_array_equal(a.float().numpy(),
                                      np.asarray(want, np.float32))
    assert prepared.bytes_written == plain.bytes_written == ref.bytes_written


@pytest.mark.parametrize("layer", [1, None])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("storage", ["host", "device"])
def test_append_token_matches_reference_store(storage, dtype, layer):
    """Single-slot writes (``append_token``) of one layer's ``(Hkv, hd)`` or
    every layer's ``(L, Hkv, hd)``, from numpy and from tensors, leave the
    reference store's pages bit for bit, and count the bytes it counts."""
    rng = np.random.default_rng(23)
    L, Hkv, hd = len(kv_layer_order(CFG)), CFG.n_kv_heads, CFG.head_dim_
    mine = _store(storage, dtype=dtype)
    ref = JStore(JCFG, 8, PAGE, dtype=jnp.dtype(dtype), storage=storage)
    shape = (Hkv, hd) if layer is not None else (L, Hkv, hd)
    for i, (blk, slot) in enumerate(((4, 0), (4, 3), (0, 2), (4, 3))):
        k = np.asarray(jnp.asarray(rng.standard_normal(shape), dtype))
        v = np.asarray(jnp.asarray(rng.standard_normal(shape), dtype))
        want = ref.append_token(blk, slot, k, v, layer=layer)
        if i % 2:
            k, v = numpy_to_tensor(k), numpy_to_tensor(v)
        assert mine.append_token(blk, slot, k, v, layer=layer) == want
    for got, want in ((mine.k, ref.k), (mine.v, ref.v)):
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32))
    assert mine.bytes_written == ref.bytes_written > 0


def test_forward_builds_its_scatter_index_once_not_per_layer():
    """A decode step and a prefill chunk each build (and upload) one
    scatter index for all their layers' writes: the store's
    ``index_builds`` counter moves by one per forward, while every layer
    still writes its K/V."""
    L = len(kv_layer_order(CFG))
    assert L > 1
    params = init_params(CFG, torch.Generator().manual_seed(9), device="cpu")
    store = _store("device")
    blocks = [0, 1, 2]
    prefill_chunk_step(params, CFG, store, blocks, [3, 1, 4, 1, 5], 0)
    assert store.index_builds == 1
    assert store.bytes_written == 5 * store.token_bytes
    for step in range(3):
        paged_decode_step(params, CFG, store, [blocks], [5 + step], [7])
        assert store.index_builds == 2 + step
    assert store.bytes_written == 8 * store.token_bytes
    # the numpy-index form of a write still builds its own index
    one = np.zeros((L, 1, CFG.n_kv_heads, CFG.head_dim_), np.float32)
    store.write_prefill(blocks, one, one, start=8)
    assert store.index_builds == 5


def test_device_steady_state_decode_moves_zero_kv_bytes():
    """Once a request's pages are resident, decode steps upload NO KV
    bytes and write the resident tensors in place."""
    params = init_params(CFG, torch.Generator().manual_seed(6), device="cpu")
    prompt = [3, 1, 4, 1, 5]
    store = _store("device")
    blocks = [0, 1, 2]
    for _ in prefill_kv_chunked(params, CFG, store, blocks, prompt, 3):
        pass
    ptr = store.layer_pages(0)[0].data_ptr()
    tok, n = prompt[-1], len(prompt)
    for _ in range(4):
        logits = paged_decode_step(params, CFG, store, [blocks], [n], [tok])
        tok, n = int(logits[0].argmax()), n + 1
    assert store.bytes_h2d == 0 and store.bytes_d2h == 0
    assert store.layer_pages(0)[0].data_ptr() == ptr
    assert store.bytes_written == n * store.token_bytes


def test_host_storage_pays_per_step_upload_device_does_not():
    params = init_params(CFG, torch.Generator().manual_seed(8), device="cpu")
    moved = {}
    for storage in ("host", "device"):
        store = _store(storage)
        paged_decode_step(params, CFG, store, [[0, 1]], [5], [7])
        moved[storage] = (store.bytes_h2d, store.bytes_d2h)
    L = len(kv_layer_order(CFG))
    layer_bytes = 2 * 8 * PAGE * CFG.n_kv_heads * CFG.head_dim_ * 4
    assert moved["host"] == (L * layer_bytes, L * 2 * CFG.n_kv_heads
                             * CFG.head_dim_ * 4)
    assert moved["device"] == (0, 0)


def test_bad_storage_rejected():
    with pytest.raises(ValueError, match="storage"):
        PagedKVStore(CFG, 4, PAGE, storage="hbm", device="cpu")
