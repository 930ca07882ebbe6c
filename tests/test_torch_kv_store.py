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
from repro_torch.serve.paged_model import paged_decode_step, prefill_kv_chunked

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
