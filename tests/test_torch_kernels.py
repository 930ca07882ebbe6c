"""The port's paged kernels against the reference package's Pallas kernels.

On the CPU the port's wrappers take their plain PyTorch versions
(``repro_torch/kernels/ref.py``), so these tests hold that arithmetic --
which the CUDA kernels are held to on the card by ``chip_smoke.py`` --
against ``paged_attention_pallas``/``paged_scatter_pallas`` run in
interpret mode, on the same numpy-seeded inputs.  Tolerances follow
``tests/test_kernels.py``: 2e-5 in f32 and 2e-2 in bf16 for attention,
bit-exact for the scatter.  The last test runs the CUDA kernels themselves
and skips without a card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ref as jref
from repro.kernels.paged_attention import build_block_table as jax_table
from repro.kernels.paged_attention import (paged_attention_pallas,
                                           paged_scatter_pallas)
from repro_torch.bridge import numpy_to_tensor
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import ref

PAGED_CASES = [
    # (B, H, Hkv, D, n_pool_pages, page, max_pages, softcap)
    (2, 4, 2, 32, 16, 16, 4, 0.0),
    (3, 8, 8, 64, 32, 8, 6, 0.0),
    (1, 4, 4, 32, 8, 16, 3, 0.0),
    (3, 9, 3, 32, 16, 4, 5, 30.0),       # G = 3, not a power of two
]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _both(a: np.ndarray, dtype: str):
    """The same values as a jax array and a torch tensor of ``dtype``."""
    j = jnp.asarray(a, jnp.float32).astype(dtype)
    return j, numpy_to_tensor(np.asarray(j))


def _tables(rng, B, P, page, max_pages):
    lengths = rng.integers(1, page * max_pages, B).astype(np.int32)
    table = np.full((B, max_pages), -1, np.int32)
    pids = rng.permutation(P)
    at = 0
    for b in range(B):
        n = -(-int(lengths[b]) // page)
        table[b, :n] = pids[at:at + n]
        at += n
    return table, lengths


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", PAGED_CASES)
def test_paged_attention_ref_matches_pallas(case, dtype):
    B, H, Hkv, D, P, page, max_pages, cap = case
    rng = np.random.default_rng(11)
    qj, qt = _both(rng.standard_normal((B, H, D)), dtype)
    kj, kt = _both(rng.standard_normal((P, page, Hkv, D)), dtype)
    vj, vt = _both(rng.standard_normal((P, page, Hkv, D)), dtype)
    table, lengths = _tables(rng, B, P, page, max_pages)
    want = paged_attention_pallas(qj, kj, vj, jnp.asarray(table),
                                  jnp.asarray(lengths), softcap=cap,
                                  interpret=True)
    got = pa.paged_attention(qt, kt, vt, torch.from_numpy(table),
                             torch.from_numpy(lengths), softcap=cap)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


def test_dead_entries_and_poisoned_pages_do_not_contribute():
    """-1 entries past the live range and pages no live entry names are
    never read: poisoning them with 1e9 changes nothing, and the result
    matches the Pallas kernel's."""
    B, H, D, P, page = 1, 2, 32, 8, 8
    rng = np.random.default_rng(12)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    kp = rng.standard_normal((P, page, H, D)).astype(np.float32)
    vp = rng.standard_normal((P, page, H, D)).astype(np.float32)
    table = np.asarray([[3, 5, -1, -1]], np.int32)
    lengths = np.asarray([12], np.int32)
    want = paged_attention_pallas(jnp.asarray(q), jnp.asarray(kp),
                                  jnp.asarray(vp), jnp.asarray(table),
                                  jnp.asarray(lengths), interpret=True)
    kp2, vp2 = kp.copy(), vp.copy()
    for dead in (0, 1, 2, 4, 6, 7):
        kp2[dead] = 1e9
        vp2[dead] = 1e9
    t = torch.from_numpy
    clean = pa.paged_attention(t(q), t(kp), t(vp), t(table), t(lengths))
    poisoned = pa.paged_attention(t(q), t(kp2), t(vp2), t(table), t(lengths))
    assert torch.equal(clean, poisoned)
    np.testing.assert_allclose(clean.numpy(), np.asarray(want),
                               atol=2e-5, rtol=2e-5)


def test_all_dead_row_is_exact_zeros():
    """A length-0 row (all entries -1) next to a live one: exact zeros, as
    the Pallas kernel gives -- not NaN, not a mean over junk."""
    P, page, H, D = 8, 4, 2, 32
    rng = np.random.default_rng(13)
    q = rng.standard_normal((2, H, D)).astype(np.float32)
    kp = rng.standard_normal((P, page, H, D)).astype(np.float32)
    table, lens = pa.build_block_table([[], [3, 5]], [0, 6], page=page)
    t = torch.from_numpy
    got = pa.paged_attention(t(q), t(kp), t(kp), table, lens)
    want = paged_attention_pallas(jnp.asarray(q), jnp.asarray(kp),
                                  jnp.asarray(kp), jnp.asarray(table.numpy()),
                                  jnp.asarray(lens.numpy()), interpret=True)
    assert torch.all(got[0] == 0)
    assert float(got[1].abs().max()) > 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


def test_decode_attention_ref_matches_jax():
    B, S, H, Hkv, D = 3, 12, 6, 2, 16
    rng = np.random.default_rng(14)
    q = rng.standard_normal((B, 1, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    n = np.asarray([1, 7, 12], np.int32)
    want = jref.decode_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), jnp.asarray(n),
                                     window=5, softcap=20.0)
    t = torch.from_numpy
    got = ref.decode_attention_ref(t(q), t(k), t(v), t(n), window=5,
                                   softcap=20.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_scatter_matches_pallas_bit_exact(dtype):
    P, page, Hkv, D, T = 6, 4, 2, 16, 7
    rng = np.random.default_rng(15)
    pj, pt = _both(rng.standard_normal((P, page, Hkv, D)), dtype)
    vj, vt = _both(rng.standard_normal((T, Hkv, D)), dtype)
    blk = rng.permutation(P * page)[:T]            # distinct (page, slot)
    b, s = (blk // page).astype(np.int32), (blk % page).astype(np.int32)
    want = paged_scatter_pallas(pj, jnp.asarray(b), jnp.asarray(s), vj,
                                interpret=True)
    kp, vp = pt.clone()[None], pt.clone()[None]    # one layer of K and V
    ref.paged_scatter_ref(kp, vp, torch.from_numpy(b), torch.from_numpy(s),
                          vt, vt, layer=0)
    for got in (kp[0], vp[0]):
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32))


@pytest.mark.parametrize("layer", [1, None])
def test_scatter_wrapper_writes_k_and_v(layer):
    """The wrapper's CPU path: one call writes K and V, for one layer or
    every layer, and leaves everything else untouched."""
    L, P, page, Hkv, D, T = 3, 5, 4, 2, 8, 4
    rng = np.random.default_rng(16)
    kp = torch.zeros((L, P, page, Hkv, D))
    vp = torch.zeros((L, P, page, Hkv, D))
    blk, slot = np.asarray([0, 2, 2, 4]), np.asarray([3, 0, 1, 3])
    lead = () if layer is not None else (L,)
    kv = torch.from_numpy(rng.standard_normal((*lead, T, Hkv, D),
                                              np.float32))
    vv = torch.from_numpy(rng.standard_normal((*lead, T, Hkv, D),
                                              np.float32))
    pa.paged_scatter(kp, vp, blk, slot, kv, vv, layer=layer)
    want_k, want_v = torch.zeros_like(kp), torch.zeros_like(vp)
    sel = slice(None) if layer is None else layer
    want_k[sel, blk, slot] = kv
    want_v[sel, blk, slot] = vv
    assert torch.equal(kp, want_k) and torch.equal(vp, want_v)


def test_scatter_wrapper_rejects_what_the_kernel_does_not_take():
    kp = torch.zeros((2, 4, 4, 2, 8))
    vals = torch.zeros((1, 2, 8))
    with pytest.raises(ValueError, match="block ids"):
        pa.paged_scatter(kp, kp.clone(), [4], [0], vals, vals, layer=0)
    with pytest.raises(ValueError, match="slots"):
        pa.paged_scatter(kp, kp.clone(), [0], [4], vals, vals, layer=0)
    with pytest.raises(ValueError, match="values must be"):
        pa.paged_scatter(kp, kp.clone(), [0], [0], vals, vals, layer=None)


@pytest.mark.parametrize("blocks,lengths,min_pages", [
    ([[7, 2, 4], [1]], [5, 1], 1),
    ([[], [3, 5]], [0, 6], 1),
    ([[], []], [0, 0], 1),
    ([[9, 8]], [3], 4),
])
def test_build_block_table_matches_jax(blocks, lengths, min_pages):
    got_t, got_l = pa.build_block_table(blocks, lengths, page=4,
                                        min_pages=min_pages)
    want_t, want_l = jax_table(blocks, lengths, page=4, min_pages=min_pages)
    assert got_t.dtype == torch.int32 and got_l.dtype == torch.int32
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))


def test_build_block_table_short_block_list_raises_like_jax():
    for fn in (pa.build_block_table, jax_table):
        with pytest.raises(ValueError, match="need 2 pages"):
            fn([[1]], [5], page=4)


def test_ops_dispatch():
    rng = np.random.default_rng(17)
    q = torch.from_numpy(rng.standard_normal((1, 2, 8), np.float32))
    kp = torch.from_numpy(rng.standard_normal((2, 4, 2, 8), np.float32))
    table, lens = pa.build_block_table([[1]], [3], page=4)
    plain = ops.paged_attention(q, kp, kp, table, lens, impl="torch")
    for impl in ("cuda", None):       # CPU tensors: the plain version
        got = ops.paged_attention(q, kp, kp, table, lens, impl=impl)
        assert torch.equal(got, plain)
    with pytest.raises(ValueError, match="impl"):
        ops.paged_attention(q, kp, kp, table, lens, impl="pallas")


@pytest.mark.cuda
def test_cuda_kernels_match_plain_versions_on_card():
    """The CUDA kernels themselves, against their plain versions on the
    card (G = 9, D = 128, bf16 and f32, a length-0 row; long rows split
    over many blocks, the same bits twice and with a wider table)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    rng = np.random.default_rng(18)
    P, page, H, Hkv, D = 64, 16, 36, 4, 128
    for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
        kp = torch.from_numpy(rng.standard_normal((P, page, Hkv, D),
                                                  np.float32)).cuda().to(dtype)
        q = torch.from_numpy(rng.standard_normal((3, H, D),
                                                 np.float32)).cuda()
        table, lens = pa.build_block_table([[], [5], [1, 2, 3]], [0, 9, 40],
                                           page=page, device="cuda")
        got = pa.paged_attention(q, kp, kp, table, lens)
        want = ref.paged_attention_ref(q, kp, kp, table, lens)
        assert float((got - want).abs().max()) <= tol
        assert torch.all(got[0] == 0)
        # long rows (up to 2000 tokens over 64 pages, pages reused across
        # rows): several blocks a (row, kv head) and several pages a unit
        lp = torch.from_numpy(rng.standard_normal((64, page, Hkv, D),
                                                  np.float32)).cuda().to(dtype)
        rows = [list(rng.integers(0, 64, 125)) for _ in range(4)]
        lt, ll = pa.build_block_table(rows, [2000, 1500, 17, 0], page=page,
                                      device="cuda")
        lq = torch.from_numpy(rng.standard_normal((4, H, D),
                                                  np.float32)).cuda()
        plan = pa.split_plan(4, Hkv, lt.shape[1], torch.cuda
                             .get_device_properties(0).multi_processor_count)
        assert plan.n_splits > 1 and pa.row_units(125)[0] > 1
        long = pa.paged_attention(lq, lp, lp, lt, ll)
        assert float((long - ref.paged_attention_ref(lq, lp, lp, lt, ll))
                     .abs().max()) <= tol
        assert torch.all(long[3] == 0)
        wide = torch.cat([lt, torch.full((4, 7), -1, dtype=torch.int32,
                                         device="cuda")], 1)
        assert torch.equal(pa.paged_attention(lq, lp, lp, lt, ll), long)
        assert torch.equal(pa.paged_attention(lq, lp, lp, wide, ll), long)
        pages = kp[None].repeat(2, 1, 1, 1, 1)
        expect = pages.clone()
        vals = torch.randn((2, 3, Hkv, D), device="cuda").to(dtype)
        pa.paged_scatter(pages, pages.clone(), [1, 7, 9], [0, 5, 15],
                         vals, vals, layer=None)
        expect[:, [1, 7, 9], [0, 5, 15]] = vals
        assert torch.equal(pages, expect)
