"""The paged attention launch with the page write folded in: a decode
step's and a prefill chunk's new K/V rows written into the pages by the
layer's attention launch, which reads them where they already are.

On the CPU the wrapper takes its plain version
(``ref.paged_attention_write_ref``: the scatter, then the attention), so
these tests hold that function against the reference package's two Pallas
kernels, ``paged_scatter_pallas`` then ``paged_attention_pallas``, run in
interpret mode on the same numpy-seeded inputs: the pools bit for bit, the
outputs within 2e-5 in f32 and 2e-2 in bf16 (``tests/test_kernels.py``'s
attention tolerances).  The store's fused entry point
(``PagedKVStore.attend``) is held to the two-step path it replaces: the
same pages and outputs, and the same ``bytes_written`` and
``index_builds``.  The last test runs the CUDA kernel against the
standalone scatter followed by the attention alone, bit for bit, and skips
without a card.

JAX is imported inside the tests that use it, so the card's test runs
where JAX is not installed.
"""

import numpy as np
import pytest
import torch

from repro_torch.bridge import numpy_to_tensor
from repro_torch.configs.base import ArchConfig, dense_stack
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels import paged_attention as pa
from repro_torch.models.model import init_params
from repro_torch.runtime.kv_store import PagedKVStore, kv_layer_order
from repro_torch.serve.paged_model import (paged_decode_step,
                                           prefill_chunk_step)

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
POISON = 1e9
P, PAGE, HKV, G, D = 24, 4, 2, 2, 32


def _jax():
    import jax.numpy as jnp

    from repro.kernels.paged_attention import (paged_attention_pallas,
                                               paged_scatter_pallas)
    return jnp, paged_attention_pallas, paged_scatter_pallas


def _rows(kind):
    """A case's attention rows and its write: (table blocks per row,
    attention lengths, blk, slot, new_lo, new_base, pages zero-filled
    before the write, as ``on_alloc`` leaves a fresh page)."""
    if kind == "decode":
        # ragged rows: rows 0-2 share two full prefix pages (3, 7); row
        # 1's new token opens the fresh page 12 (slot 0); row 4 held no
        # token before this one
        blocks = [[3, 7, 11], [3, 7, 12], [3, 7, 13, 14], [6], [9]]
        stored = [9, 8, 13, 2, 0]
        blk = [bl[n // PAGE] for bl, n in zip(blocks, stored)]
        slot = [n % PAGE for n in stored]
        return (blocks, [n + 1 for n in stored], blk, slot, stored,
                list(range(len(stored))), [12])
    # a chunk of 6 positions (5..10) over one table, its last page fresh
    prompt_blocks, start, c = [5, 1, 10, 2], 5, 6
    pos = np.arange(start, start + c)
    blk = [prompt_blocks[p // PAGE] for p in pos]
    return ([prompt_blocks] * c, list(range(start + 1, start + c + 1)), blk,
            list(pos % PAGE), [start] * c, [0] * c, [10])


def _inputs(kind, dtype, rng, min_pages=1):
    """Pools (dead pages poisoned, fresh pages zero), q, the table (at
    least ``min_pages`` wide: -1 entries past the live range), the new
    rows and the write's index, all as numpy and as the port's tensors."""
    blocks, lens, blk, slot, lo, base, fresh = _rows(kind)
    B, T = len(blocks), len(blk)
    k = rng.standard_normal((P, PAGE, HKV, D)).astype(np.float32)
    v = rng.standard_normal((P, PAGE, HKV, D)).astype(np.float32)
    live = {b for bl in blocks for b in bl}
    for p in range(P):
        if p not in live:
            k[p] = v[p] = POISON
    for p in fresh:
        k[p] = v[p] = 0.0
    q = rng.standard_normal((B, HKV * G, D)).astype(np.float32)
    k_new = rng.standard_normal((T, HKV, D)).astype(np.float32)
    v_new = rng.standard_normal((T, HKV, D)).astype(np.float32)
    table, tlens = pa.build_block_table(blocks, lens, page=PAGE,
                                        min_pages=min_pages)
    wi = pa.write_index(blk, slot, lo, base, num_blocks=P, page=PAGE,
                        device="cpu")
    t = {name: numpy_to_tensor(np.asarray(a, np.float32)).to(getattr(
        torch, dtype)) for name, a in (("k", k), ("v", v), ("k_new", k_new),
                                       ("v_new", v_new))}
    return dict(np=(k, v, q, k_new, v_new, blk, slot), q=torch.from_numpy(q),
                table=table, lens=tlens, wi=wi, **t)


def _write(x):
    return (x["wi"].index, x["k_new"], x["v_new"], x["wi"].new_lo,
            x["wi"].new_base)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind,min_pages", [("decode", 1), ("decode", 6),
                                            ("chunk", 1), ("chunk", 5)])
def test_fused_write_matches_pallas_scatter_then_attention(kind, min_pages,
                                                           dtype):
    """Decode rows (ragged, shared prefix pages, a new token opening a
    zero-filled page) and chunk rows over one table (causal within the
    chunk), with poisoned dead pages and, at the wider tables, -1 entries:
    the pools bit-exact and the output within tolerance of the reference's
    scatter followed by its attention."""
    jnp, attention_pallas, scatter_pallas = _jax()
    x = _inputs(kind, dtype, np.random.default_rng(40), min_pages)
    q, blk, slot = x["np"][2], x["np"][5], x["np"][6]
    # the same values in jax: the port's, exactly (bf16 -> f32 -> bf16)
    jt = lambda t: jnp.asarray(t.float().numpy()).astype(dtype)
    b, s = jnp.asarray(blk, jnp.int32), jnp.asarray(slot, jnp.int32)
    kj = scatter_pallas(jt(x["k"]), b, s, jt(x["k_new"]), interpret=True)
    vj = scatter_pallas(jt(x["v"]), b, s, jt(x["v_new"]), interpret=True)
    want = attention_pallas(jnp.asarray(q), kj, vj,
                            jnp.asarray(x["table"].numpy()),
                            jnp.asarray(x["lens"].numpy()), interpret=True)
    kp, vp = x["k"].clone(), x["v"].clone()
    got = pa.paged_attention(x["q"], kp, vp, x["table"], x["lens"],
                             write=_write(x))
    for mine, theirs in ((kp, kj), (vp, vj)):
        np.testing.assert_array_equal(mine.float().numpy(),
                                      np.asarray(theirs, np.float32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL[dtype],
                               rtol=TOL[dtype])
    # the dispatcher's plain version is the same function
    kp2, vp2 = x["k"].clone(), x["v"].clone()
    again = ops.paged_attention(x["q"], kp2, vp2, x["table"], x["lens"],
                                write=_write(x), impl="torch")
    assert torch.equal(again, got) and torch.equal(kp2, kp)


def test_fused_write_equals_the_standalone_pair_and_reads_no_dead_page():
    """The fused plain version against the standalone scatter followed by
    the attention alone, bit for bit; the poisoned dead pages never reach
    the output (finite, below the poison), and re-poisoning them changes
    nothing."""
    x = _inputs("decode", "float32", np.random.default_rng(41), 6)
    kp, vp = x["k"].clone(), x["v"].clone()
    got = pa.paged_attention(x["q"], kp, vp, x["table"], x["lens"],
                             write=_write(x))
    k2, v2 = x["k"].clone()[None], x["v"].clone()[None]
    pa.paged_scatter_indexed(k2, v2, x["wi"].index, x["k_new"], x["v_new"],
                             layer=0)
    pair = pa.paged_attention(x["q"], k2[0], v2[0], x["table"], x["lens"])
    assert torch.equal(got, pair)
    assert torch.equal(kp, k2[0]) and torch.equal(vp, v2[0])
    assert torch.isfinite(got).all() and float(got.abs().max()) < 1e3
    live = {int(p) for p in x["table"].flatten() if p >= 0}
    dead = [p for p in range(P) if p not in live]
    kp[dead] = 2 * POISON
    vp[dead] = -2 * POISON
    assert torch.equal(pa.paged_attention(x["q"], kp, vp, x["table"],
                                          x["lens"]), got)


def test_wrapper_rejects_what_the_fused_kernel_does_not_take():
    x = _inputs("decode", "float32", np.random.default_rng(42))
    q, k, v, table, lens = x["q"], x["k"], x["v"], x["table"], x["lens"]
    idx, kn, vn, lo, base = _write(x)

    def call(write, q=q):
        pa.paged_attention(q, k.clone(), v.clone(), table, lens, write=write)

    bad = [
        ((idx, kn, vn, lo), "write must be"),
        ((idx.idx, kn, vn, lo, base), "ScatterIndex"),
        ((idx, kn[:-1], vn, lo, base), "k_new must be"),
        ((idx, kn, vn.double(), lo, base), "pages' dtype"),
        ((idx, kn, vn.to(torch.bfloat16), lo, base), "pages' dtype"),
        ((idx, kn, torch.zeros((idx.T, D, HKV)).transpose(1, 2), lo, base),
         "contiguous"),
        ((idx, kn, vn, lo.long(), base), "new_lo must be"),
        ((idx, kn, vn, lo, base[:-1]), "new_base must be"),
        ((pa.ScatterIndex(idx.idx.reshape(-1), idx.T), kn, vn, lo, base),
         "index must be"),
    ]
    for write, msg in bad:
        with pytest.raises(ValueError, match=msg):
            call(write)
    empty = q[:0]
    no_rows = (idx, kn, vn, lo[:0], base[:0])
    with pytest.raises(ValueError, match="a row to launch from"):
        pa.paged_attention(empty, k, v, table[:0], lens[:0], write=no_rows)
    for args, msg in ((([0], [0], [-1], [0]), "new_lo"),
                      (([0], [0], [0], [1]), "new_base"),
                      (([0], [0], [0, 1], [0]), "differ in length"),
                      (([P], [0], [0], [0]), "block ids"),
                      (([0], [PAGE], [0], [0]), "slots")):
        with pytest.raises(ValueError, match=msg):
            pa.write_index(*args, num_blocks=P, page=PAGE, device="cpu")


def test_write_index_is_one_buffer():
    """The scatter index and the rows' new_lo / new_base come from one
    upload: views of one int32 buffer, each contiguous."""
    wi = pa.write_index([3, 5, 7], [0, 1, 2], [4, 9], [0, 2], num_blocks=8,
                        page=4, device="cpu")
    assert wi.index.idx.tolist() == [[3, 5, 7], [0, 1, 2]]
    assert wi.new_lo.tolist() == [4, 9] and wi.new_base.tolist() == [0, 2]
    base = wi.index.idx.untyped_storage().data_ptr()
    for t in (wi.index.idx, wi.new_lo, wi.new_base):
        assert t.dtype == torch.int32 and t.is_contiguous()
        assert t.untyped_storage().data_ptr() == base


KW = dict(name="kv-plain", d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
          vocab=64, remat="none", dtype="float32")
CFG = ArchConfig(groups=dense_stack(2), **KW)


def _store(storage, n=16, dtype=None):
    return PagedKVStore(CFG, n, PAGE, storage=storage, device="cpu",
                        dtype=dtype)


@pytest.mark.parametrize("storage", ["host", "device"])
@pytest.mark.parametrize("kind", ["decode", "chunk"])
def test_store_attend_equals_the_two_step_path(kind, storage):
    """``PagedKVStore.attend`` per layer against the two-step path it
    replaces (``append_tokens`` / ``write_prefill`` through one index,
    then the attention over ``layer_pages``): the same pages, outputs,
    ``bytes_written`` and ``index_builds``."""
    rng = np.random.default_rng(43)
    blocks, lens, blk, slot, lo, base, _ = _rows(kind)
    B, T = len(blocks), len(blk)
    hd, H = CFG.head_dim_, CFG.n_heads
    fused, pair = _store(storage), _store(storage)
    pool = torch.from_numpy(rng.standard_normal(fused.k.shape, np.float32))
    for st in (fused, pair):
        st.k.copy_(pool)
        st.v.copy_(pool * 0.5)
    table, tlens = pa.build_block_table(blocks, lens, page=PAGE)
    wi = fused.write_index(blk, slot, lo, base)
    index = (pair.scatter_index(blk, slot) if kind == "decode"
             else pair.token_index(blocks[0], lo[0], T))
    for layer in range(len(kv_layer_order(CFG))):
        q = torch.from_numpy(rng.standard_normal((B, H, hd), np.float32))
        k = torch.from_numpy(rng.standard_normal((T, CFG.n_kv_heads, hd),
                                                 np.float32))
        v = k.flip(0).contiguous()
        got = fused.attend(layer, q, table, tlens, wi, k, v)
        if kind == "decode":
            pair.append_tokens(blk, slot, k, v, layer=layer, index=index)
        else:
            pair.write_prefill(blocks[0], k, v, start=lo[0], layer=layer,
                               index=index)
        kp, vp = pair.layer_pages(layer)
        assert torch.equal(got, ops.paged_attention(q, kp, vp, table, tlens))
    assert torch.equal(fused.k, pair.k) and torch.equal(fused.v, pair.v)
    assert fused.bytes_written == pair.bytes_written > 0
    assert fused.index_builds == pair.index_builds == 1
    assert (fused.bytes_h2d, fused.bytes_d2h) == (pair.bytes_h2d,
                                                  pair.bytes_d2h)


def test_store_attend_casts_new_rows_to_the_pages_dtype():
    """Pages stored in bf16 under an f32 model: the new rows are cast as
    the standalone scatter casts them, and the result equals the plain
    two-step path on the cast rows."""
    rng = np.random.default_rng(44)
    blocks, lens, blk, slot, lo, base, _ = _rows("decode")
    st = _store("device", dtype="bfloat16")
    table, tlens = pa.build_block_table(blocks, lens, page=PAGE)
    q = torch.from_numpy(rng.standard_normal((len(blocks), CFG.n_heads,
                                              CFG.head_dim_), np.float32))
    k = torch.from_numpy(rng.standard_normal((len(blk), CFG.n_kv_heads,
                                              CFG.head_dim_), np.float32))
    got = st.attend(1, q, table, tlens, st.write_index(blk, slot, lo, base),
                    k, k)
    kb = k.to(torch.bfloat16)
    want_pages = torch.zeros_like(st.k[1])
    want_pages[torch.tensor(blk), torch.tensor(slot)] = kb
    assert torch.equal(st.k[1], want_pages) and torch.equal(st.v[1],
                                                            want_pages)
    assert torch.equal(got, ref.paged_attention_ref(q, want_pages,
                                                    want_pages, table, tlens))


def test_paged_forward_device_storage_equals_host_storages_two_steps():
    """A prefill chunk and decode steps through the fused entry point
    (device storage) against host storage, which keeps the two-step write
    (the scatter in host memory, then the attention): logits and pages bit
    for bit, the counters alike, and one index build per forward."""
    params = init_params(CFG, torch.Generator().manual_seed(11),
                         device="cpu")
    stores = {s: _store(s) for s in ("device", "host")}
    blocks, prompt = [4, 9, 2], [3, 1, 4, 1, 5, 9]
    logits = {}
    for name, st in stores.items():
        outs = [prefill_chunk_step(params, CFG, st, blocks, prompt[:4], 0),
                prefill_chunk_step(params, CFG, st, blocks, prompt[4:], 4)]
        tok, n = prompt[-1], len(prompt)
        for _ in range(3):
            lg = paged_decode_step(params, CFG, st, [blocks], [n], [tok])
            outs.append(lg)
            tok, n = int(lg[0].argmax()), n + 1
        logits[name] = torch.cat(outs)
        assert st.index_builds == 5
        assert st.bytes_written == n * st.token_bytes
    dev, host = stores["device"], stores["host"]
    assert torch.equal(logits["device"], logits["host"])
    assert torch.equal(dev.k, host.k) and torch.equal(dev.v, host.v)
    assert dev.bytes_h2d == dev.bytes_d2h == 0 < host.bytes_h2d


def test_fused_launches_are_counted_apart():
    """The launch counts keep the fused launches under a name of their
    own, beside the attention alone and the standalone scatter."""
    assert {"paged_attention", "paged_attention+write",
            "paged_scatter"} <= set(build.launch_counts)
    build.reset_launch_counts()
    assert build.launch_counts["paged_attention+write"] == 0


@pytest.mark.cuda
def test_cuda_fused_write_matches_the_standalone_pair_on_card():
    """The CUDA kernel with the write folded in against the standalone
    scatter kernel followed by the attention kernel alone, on the card:
    pools and outputs bit for bit, in f32 and bf16, at decode rows and at
    chunk rows; one ``paged_attention+write`` launch each."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    rng = np.random.default_rng(45)
    for dtype in ("float32", "bfloat16"):
        for kind in ("decode", "chunk"):
            x = _inputs(kind, dtype, rng, 6)
            dev = {n: t.cuda() for n, t in x.items()
                   if isinstance(t, torch.Tensor)}
            wi = pa.write_index(*(x["np"][5:7]), *_rows(kind)[4:6],
                                num_blocks=P, page=PAGE, device="cuda")
            kp, vp = dev["k"].clone(), dev["v"].clone()
            build.reset_launch_counts()
            got = pa.paged_attention(
                dev["q"], kp, vp, dev["table"], dev["lens"],
                write=(wi.index, dev["k_new"], dev["v_new"], wi.new_lo,
                       wi.new_base))
            assert build.launch_counts["paged_attention+write"] == 1
            k2, v2 = dev["k"].clone()[None], dev["v"].clone()[None]
            pa.paged_scatter_indexed(k2, v2, wi.index, dev["k_new"],
                                     dev["v_new"], layer=0)
            pair = pa.paged_attention(dev["q"], k2[0], v2[0], dev["table"],
                                      dev["lens"])
            torch.cuda.synchronize()
            assert torch.equal(got, pair), (dtype, kind)
            assert torch.equal(kp, k2[0]) and torch.equal(vp, v2[0])
