"""The algorithms of the port's redesigned paged-attention and linear-scan
kernels, in plain PyTorch, against the reference package's Pallas kernels.

The CUDA kernels run only on the card, where ``chip_smoke.py`` holds them
to their plain versions.  What their new structure computes can be held
here: ``paged_attention_split_ref`` (per-split partial softmaxes, folded in
a fixed order) and ``linear_scan_chunked_ref`` (chunk states, the state
passed along the chunks, chunk outputs) go through the same inputs, made
from a seed with numpy, as ``paged_attention_pallas`` and
``linear_scan_pallas`` in interpret mode.  Tolerances follow
``tests/test_kernels.py``: 2e-5 (f32) / 2e-2 (bf16) for attention, 2e-4 /
5e-2 for the scan.  The host-side split plan is a function of shapes
alone; the wrappers' new refusals are checked on ``meta`` tensors.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.linear_scan import linear_scan_pallas
from repro.kernels.paged_attention import paged_attention_pallas
from repro_torch.bridge import numpy_to_tensor
from repro_torch.kernels import linear_scan as ls
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import ref

PAGED_CASES = [
    # (B, H, Hkv, D, n_pool_pages, page, max_pages, softcap): the cases of
    # tests/test_torch_kernels.py
    (2, 4, 2, 32, 16, 16, 4, 0.0),
    (3, 8, 8, 64, 32, 8, 6, 0.0),
    (1, 4, 4, 32, 8, 16, 3, 0.0),
    (3, 9, 3, 32, 16, 4, 5, 30.0),       # G = 3, not a power of two
]
ATT_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
SCAN_TOL = {"float32": 2e-4, "bfloat16": 5e-2}


def _both(a: np.ndarray, dtype: str):
    """The same values as a jax array and a torch tensor of ``dtype``."""
    j = jnp.asarray(a, jnp.float32).astype(dtype)
    return j, numpy_to_tensor(np.asarray(j))


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(
        x, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


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


# ----------------------------------------------------------------------------
# paged attention: split over pages, partials folded in a fixed order
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("pages_per_split", [1, 2, 3, "max_pages"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", PAGED_CASES)
def test_paged_split_ref_matches_pallas(case, dtype, pages_per_split):
    B, H, Hkv, D, P, page, max_pages, cap = case
    pps = max_pages if pages_per_split == "max_pages" else pages_per_split
    rng = np.random.default_rng(31)
    qj, qt = _both(rng.standard_normal((B, H, D)), dtype)
    kj, kt = _both(rng.standard_normal((P, page, Hkv, D)), dtype)
    vj, vt = _both(rng.standard_normal((P, page, Hkv, D)), dtype)
    table, lengths = _tables(rng, B, P, page, max_pages)
    want = paged_attention_pallas(qj, kj, vj, jnp.asarray(table),
                                  jnp.asarray(lengths), softcap=cap,
                                  interpret=True)
    t = torch.from_numpy
    got = ref.paged_attention_split_ref(qt, kt, vt, t(table), t(lengths),
                                        softcap=cap, pages_per_split=pps)
    assert got.dtype == qt.dtype and got.shape == (B, H, D)
    _close(got, want, ATT_TOL[dtype])
    _close(got, ref.paged_attention_ref(qt, kt, vt, t(table), t(lengths),
                                        softcap=cap), ATT_TOL[dtype])


def _dead_case():
    """Rows of 0, 1, 9 and 45 tokens over pages of 4, in a table 12 wide."""
    rng = np.random.default_rng(32)
    P, page, Hkv, G, D = 40, 4, 2, 3, 32
    q = torch.from_numpy(rng.standard_normal((4, Hkv * G, D), np.float32))
    kp = torch.from_numpy(rng.standard_normal((P, page, Hkv, D), np.float32))
    vp = torch.from_numpy(rng.standard_normal((P, page, Hkv, D), np.float32))
    blocks = [[], [7], [1, 2, 3], list(range(20, 32))]
    table, lens = pa.build_block_table(blocks, [0, 1, 9, 45], page=page,
                                       min_pages=12)
    return q, kp, vp, table, lens


@pytest.mark.parametrize("pages_per_split", [1, 2, 3, None])
def test_paged_split_ref_all_dead_row_is_exact_zeros(pages_per_split):
    q, kp, vp, table, lens = _dead_case()
    got = ref.paged_attention_split_ref(q, kp, vp, table, lens,
                                        pages_per_split=pages_per_split)
    assert torch.all(got[0] == 0)
    assert all(float(got[b].abs().max()) > 0 for b in (1, 2, 3))


@pytest.mark.parametrize("pages_per_split", [1, 2, 3, None])
def test_paged_split_ref_poisoned_dead_pages_are_bit_identical(
        pages_per_split):
    """Pages no live entry names poisoned with 1e9 and the table widened by
    dead entries: the same bits, for every split size."""
    q, kp, vp, table, lens = _dead_case()
    clean = ref.paged_attention_split_ref(q, kp, vp, table, lens,
                                          pages_per_split=pages_per_split)
    live = {int(p) for p in table.flatten().tolist() if p >= 0}
    dead = torch.tensor(sorted(set(range(kp.shape[0])) - live))
    kp2, vp2 = kp.clone(), vp.clone()
    kp2[dead] = 1e9
    vp2[dead] = 1e9
    wide = torch.cat([table, torch.full((4, 5), -1, dtype=torch.int32)], 1)
    poisoned = ref.paged_attention_split_ref(q, kp2, vp2, wide, lens,
                                             pages_per_split=pages_per_split)
    assert torch.equal(clean, poisoned)


@pytest.mark.parametrize("B,Hkv,max_pages,n_sm", [
    (8, 4, 16, 132),      # starcoder2 decode
    (32, 4, 8, 132),      # a prefill chunk of 32 rows
    (8, 4, 512, 132),     # 8192-token rows
    (1, 1, 1, 132),
    (3, 2, 100, 7),
    (256, 8, 3, 132),     # many rows: one split each
])
def test_split_plan_covers_every_live_page_once(B, Hkv, max_pages, n_sm):
    plan = pa.split_plan(B, Hkv, max_pages, n_sm)
    assert plan.n_splits >= 1 and 1 <= plan.max_units <= pa.MAX_UNITS
    assert plan.max_units <= max(1, max_pages)
    for n_live in range(max_pages + 1):
        work = pa.split_pages(plan, n_live)
        pages = sorted(p for _, _, _, ps in work for p in ps)
        assert pages == list(range(n_live))       # each live page once
        for z, w, u, ps in work:
            assert 0 <= z < plan.n_splits and 0 <= w < pa.WARPS
            assert u < plan.max_units             # its partial has room
            assert all(p < max_pages for p in ps)
        units = [u for _, _, u, _ in work]
        assert sorted(units) == list(range(len(units)))
        U, n_units = pa.row_units(n_live)
        assert n_units == len(units) and n_units <= pa.MAX_UNITS
        # a block's units are one contiguous range
        for z in range(plan.n_splits):
            mine = sorted(u for zz, _, u, _ in work if zz == z)
            assert not mine or mine == list(range(mine[0],
                                                  mine[0] + len(mine)))


def test_split_plan_reads_no_tensor():
    """The plan is a function of four ints: the lengths and the table stay
    on the device, and a wider table only adds dead units."""
    sig = inspect.signature(pa.split_plan)
    assert list(sig.parameters) == ["B", "Hkv", "max_pages", "n_sm"]
    assert all(p.annotation in (int, "int") for p in sig.parameters.values())
    assert pa.split_plan(8, 4, 16, 132) == pa.split_plan(8, 4, 16, 132)
    # the decode shape: a warp for every live page (4 splits x 32 (row, kv
    # head) = 128 blocks of 4 warps); long rows: about two blocks an SM
    plan = pa.split_plan(8, 4, 16, 132)
    assert plan.n_splits * 8 * 4 * pa.WARPS >= 16 * 8 * 4
    long = pa.split_plan(8, 4, 512, 132)
    assert 8 * 4 * long.n_splits <= pa.BLOCKS_PER_SM * 132
    # the units of a row depend on its live pages only
    assert pa.row_units(17) == (1, 17) and pa.row_units(512) == (8, 64)
    assert pa.row_units(0) == (1, 0)


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_paged_wrapper_rejects_what_the_split_kernel_does_not_take():
    table = _meta(2, 4, dtype=torch.int32)
    lens = _meta(2, dtype=torch.int32)
    q = _meta(2, 8, 4, dtype=torch.float32)
    with pytest.raises(ValueError, match="multiple of 16 bytes"):
        pa.paged_attention(q, _meta(8, 16, 2, 4), _meta(8, 16, 2, 4), table,
                           lens)
    with pytest.raises(ValueError, match="G \\* D"):
        pa.paged_attention(_meta(2, 64, 64, dtype=torch.float32),
                           _meta(8, 16, 1, 64), _meta(8, 16, 1, 64), table,
                           lens)
    with pytest.raises(ValueError, match="shared memory"):
        pa.paged_attention(_meta(2, 8, 256, dtype=torch.float32),
                           _meta(8, 16, 1, 256, dtype=torch.float32),
                           _meta(8, 16, 1, 256, dtype=torch.float32),
                           table, lens)
    # the main path's shapes fit, in both page dtypes
    for dtype in (torch.float32, torch.bfloat16):
        assert pa.smem_bytes(dtype, 9, 128) <= pa.MAX_SMEM


# ----------------------------------------------------------------------------
# linear scan: chunk states, state passing, chunk outputs
# ----------------------------------------------------------------------------

SCAN_CASES = [
    # (B, S, H, K, Vd, vector_decay, bonus, chunk): tests/test_kernels.py's
    (2, 128, 2, 32, 32, False, False, 32),        # mamba2-style
    (1, 96, 4, 16, 64, False, False, 32),         # Vd != K
    (2, 128, 2, 32, 32, True, True, 32),          # rwkv6-style
    (1, 64, 2, 16, 16, True, True, 16),
    # S not a multiple of the chunk, both decays
    (1, 100, 2, 32, 32, False, False, 32),
    (2, 50, 3, 16, 16, True, True, 32),
]
# (B, S, H, K, Vd, vector_decay, bonus, chunk): log decays of 2.4-2.55 a
# step, so -cl passes the 75 clamp inside a 32-step chunk (and stays above
# f32's smallest normal exponent, where XLA's CPU and torch agree)
CLAMP_CASES = [
    (2, 64, 2, 16, 16, False, False, 32),
    (1, 64, 2, 16, 16, True, True, 32),
]


def _scan_inputs(case, dtype, seed, lo=0.01, hi=1.0):
    B, S, H, K, Vd, vec, bonus, chunk = case
    rng = np.random.default_rng(seed)
    qj, qt = _both(rng.standard_normal((B, S, H, K)), dtype)
    kj, kt = _both(rng.standard_normal((B, S, H, K)), dtype)
    vj, vt = _both(rng.standard_normal((B, S, H, Vd)), dtype)
    ld = -rng.uniform(lo, hi, (B, S, H, K) if vec else (B, S, H)).astype(
        np.float32)
    u = rng.standard_normal((H, K)).astype(np.float32) if bonus else None
    jax_args = (qj, kj, vj, jnp.asarray(ld))
    torch_args = (qt, kt, vt, torch.from_numpy(ld))
    return (jax_args, None if u is None else jnp.asarray(u), torch_args,
            None if u is None else torch.from_numpy(u))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", SCAN_CASES)
def test_linear_scan_chunked_ref_matches_pallas_and_exact(case, dtype):
    chunk = case[-1]
    ja, ju, ta, tu = _scan_inputs(case, dtype, 33)
    got, st = ref.linear_scan_chunked_ref(*ta, bonus=tu, chunk=chunk)
    assert got.dtype == ta[2].dtype and st.dtype == torch.float32
    tol = SCAN_TOL[dtype]
    want, st_want = linear_scan_pallas(*ja, bonus=ju, chunk=chunk,
                                       interpret=True)
    _close(got, want, tol)
    _close(st, st_want, tol)
    exact, st_exact = jref.linear_scan_exact(*ja, bonus=ju, chunk=chunk)
    _close(got, exact, tol)
    _close(st, st_exact, tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CLAMP_CASES)
def test_linear_scan_chunked_ref_keeps_the_clamp(case, dtype):
    """Where -cl passes 75 the factored form departs from the exact
    recurrence by design; the three phases keep the reference's clamp and
    agree with the Pallas kernel and ``linear_scan_ref``."""
    chunk = case[-1]
    ja, ju, ta, tu = _scan_inputs(case, dtype, 34, lo=2.4, hi=2.55)
    ld = ta[3] if ta[3].dim() == 4 else ta[3][..., None]
    B, S = ld.shape[:2]
    cl = torch.cumsum(ld.reshape(B, S // chunk, chunk, *ld.shape[2:]), 2)
    assert float((-cl).max()) > 75.0            # the clamp is active
    got, st = ref.linear_scan_chunked_ref(*ta, bonus=tu, chunk=chunk)
    tol = SCAN_TOL[dtype]
    want, st_want = linear_scan_pallas(*ja, bonus=ju, chunk=chunk,
                                       interpret=True)
    _close(got, want, tol)
    _close(st, st_want, tol)
    mine, my_st = ref.linear_scan_ref(*ta, bonus=tu, chunk=chunk)
    _close(got, mine, tol)
    _close(st, my_st, tol)


def test_scan_wrapper_rejects_what_the_kernels_do_not_take():
    x = _meta(2, 16, 4, 32)
    ld = _meta(2, 16, 4, dtype=torch.float32)
    with pytest.raises(ValueError, match="state pass"):
        big = _meta(1024, 4, 65, 16)
        ls.linear_scan(big, big, big, _meta(1024, 4, 65, dtype=torch.float32))
    with pytest.raises(ValueError, match="shared memory"):
        f = _meta(1, 512, 1, 128, dtype=torch.float32)
        ls.linear_scan(f, f, f, _meta(1, 512, 1, dtype=torch.float32),
                       chunk=256)
    with pytest.raises(ValueError, match="zero state"):
        ls.linear_scan(x, x, x, ld, state=torch.zeros(2, 4, 32, 32))


@pytest.mark.parametrize("K,Vd,L,mma", [
    (64, 64, 128, True),       # mamba2
    (64, 64, 32, True),        # rwkv6
    (32, 16, 64, True),
    (128, 128, 128, True),
    (64, 64, 256, False),      # chunk above 128
    (8, 4, 8, False),          # not multiples of 16
    (48, 24, 32, False),
])
def test_scan_tensor_core_shapes_and_shared_memory(K, Vd, L, mma):
    """Which shapes take the tensor cores, and that their bf16 blocks take
    less shared memory than the f32 ones (and, with a scalar decay, fit
    the card); the main paths' shapes fit with either decay."""
    assert ls.mma_shape(K, Vd, L) is mma
    for Kd, bonus in ((1, False), (K, True)):
        bf = ls.smem_bytes(K, Vd, Kd, L, bonus, torch.bfloat16)
        f32 = ls.smem_bytes(K, Vd, Kd, L, bonus, torch.float32)
        assert (bf < f32) is mma and (bf == f32) is (not mma)
        if mma and Kd == 1:
            assert bf <= ls.MAX_SMEM
    assert ls.smem_bytes(64, 64, 1, 128, False, torch.bfloat16) <= ls.MAX_SMEM
    assert ls.smem_bytes(64, 64, 64, 32, True, torch.bfloat16) <= ls.MAX_SMEM
