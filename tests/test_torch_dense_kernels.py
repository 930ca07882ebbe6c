"""The port's flash-attention and linear-scan kernels against the
reference package's Pallas kernels.

On the CPU the port's wrappers take their plain PyTorch versions
(``repro_torch/kernels/ref.py``), so these tests hold that arithmetic --
which the CUDA kernels are held to on the card by ``chip_smoke.py`` and
the last test here -- against ``flash_attention_pallas`` and
``linear_scan_pallas`` run in interpret mode, on the same numpy-seeded
inputs.  Tolerances follow ``tests/test_kernels.py``: 2e-5 (f32) and 2e-2
(bf16) for attention, 2e-4 / 5e-2 for the scan, whose factored form
differs from the exact oracle by rounding.  The wrappers' refusals are
checked on ``meta`` tensors, which reach the checks without a card.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_pallas
from repro.kernels.linear_scan import linear_scan_pallas
from repro_torch.bridge import numpy_to_tensor
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import linear_scan as ls
from repro_torch.kernels import ops, ref

FLASH_CASES = [
    # (B, Sq, Sk, H, Hkv, D, causal, window, softcap): tests/test_kernels.py's
    (1, 128, 128, 4, 4, 64, True, 0, 0.0),
    (2, 64, 64, 4, 2, 32, True, 0, 0.0),          # GQA
    (2, 64, 64, 8, 2, 32, True, 24, 0.0),         # sliding window
    (1, 128, 128, 4, 4, 64, True, 0, 50.0),       # softcap (gemma2)
    (2, 96, 96, 4, 4, 32, False, 0, 0.0),         # bidirectional (whisper enc)
    (1, 80, 80, 2, 2, 64, True, 0, 0.0),          # non-multiple of block
    # and zamba2's head_dim, with G = 3 query heads per kv head
    (1, 72, 72, 6, 2, 80, True, 0, 0.0),
]
SCAN_CASES = [
    # (B, S, H, K, Vd, vector_decay, bonus, chunk): tests/test_kernels.py's
    (2, 128, 2, 32, 32, False, False, 32),        # mamba2-style
    (1, 96, 4, 16, 64, False, False, 32),         # Vd != K, ragged S
    (2, 128, 2, 32, 32, True, True, 32),          # rwkv6-style
    (1, 64, 2, 16, 16, True, True, 16),
]
ATT_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
SCAN_TOL = {"float32": 2e-4, "bfloat16": 5e-2}


def _both(a: np.ndarray, dtype: str):
    """The same values as a jax array and a torch tensor of ``dtype``."""
    j = jnp.asarray(a, jnp.float32).astype(dtype)
    return j, numpy_to_tensor(np.asarray(j))


def _close(got, want, tol):
    """assert_allclose, with the largest error and the pytest worker named
    in the message, so that a failure seen only in a parallel run says
    whether it was a wrong result and where it ran."""
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    err = (float(np.max(np.abs(np.asarray(got, np.float32) - want)))
           if np.shape(got) == want.shape else float("nan"))
    np.testing.assert_allclose(
        got, want, atol=tol, rtol=tol,
        err_msg=f"max |err| {err:.3e} at tolerance {tol:.0e}, worker "
                f"{os.environ.get('PYTEST_XDIST_WORKER', 'main')}, "
                f"{torch.get_num_threads()} torch threads")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_attention_plain_version_matches_pallas(case, dtype):
    B, Sq, Sk, H, Hkv, D, causal, window, cap = case
    rng = np.random.default_rng(21)
    qj, qt = _both(rng.standard_normal((B, Sq, H, D)), dtype)
    kj, kt = _both(rng.standard_normal((B, Sk, Hkv, D)), dtype)
    vj, vt = _both(rng.standard_normal((B, Sk, Hkv, D)), dtype)
    want = flash_attention_pallas(qj, kj, vj, causal=causal, window=window,
                                  softcap=cap, block_q=32, block_kv=32,
                                  interpret=True)
    got = fa.flash_attention(qt, kt, vt, causal=causal, window=window,
                             softcap=cap)
    assert got.dtype == qt.dtype and got.shape == (B, Sq, H, D)
    _close(got, want, ATT_TOL[dtype])


def test_flash_attention_ref_chunking_and_q_offset_match_jax():
    """Small q/kv blocks (several of each, ragged) and a q offset -- the
    reference's context-parallel continuation -- give the reference's
    numbers."""
    rng = np.random.default_rng(22)
    q = rng.standard_normal((2, 40, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 70, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 70, 2, 24)).astype(np.float32)
    kw = dict(causal=True, window=17, softcap=30.0, q_offset=30, q_block=16,
              kv_block=32)
    want = jref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), **kw)
    t = torch.from_numpy
    _close(ref.flash_attention_ref(t(q), t(k), t(v), **kw), want, 2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", SCAN_CASES)
def test_linear_scan_plain_version_matches_pallas_and_exact(case, dtype):
    B, S, H, K, Vd, vec, bonus, chunk = case
    rng = np.random.default_rng(23)
    qj, qt = _both(rng.standard_normal((B, S, H, K)), dtype)
    kj, kt = _both(rng.standard_normal((B, S, H, K)), dtype)
    vj, vt = _both(rng.standard_normal((B, S, H, Vd)), dtype)
    ld = -rng.uniform(0.01, 1.0, (B, S, H, K) if vec else (B, S, H)).astype(
        np.float32)
    u = rng.standard_normal((H, K)).astype(np.float32) if bonus else None
    ju = None if u is None else jnp.asarray(u)
    tu = None if u is None else torch.from_numpy(u)
    got, st = ls.linear_scan(qt, kt, vt, torch.from_numpy(ld), bonus=tu,
                             chunk=chunk)
    assert got.dtype == vt.dtype and st.dtype == torch.float32
    tol = SCAN_TOL[dtype]
    want, st_want = linear_scan_pallas(qj, kj, vj, jnp.asarray(ld), bonus=ju,
                                       chunk=chunk, interpret=True)
    _close(got, want, tol)
    _close(st, st_want, tol)
    exact, st_exact = jref.linear_scan_exact(qj, kj, vj, jnp.asarray(ld),
                                             bonus=ju, chunk=chunk)
    _close(got, exact, tol)
    _close(st, st_exact, tol)
    mine, my_st = ref.linear_scan_exact(qt, kt, vt, torch.from_numpy(ld),
                                        bonus=tu, chunk=chunk)
    _close(mine, exact, tol)
    _close(my_st, st_exact, tol)


def test_linear_scan_matches_sequential_steps():
    """The chunked scan (model-path chunk 128 over a ragged S) against the
    port's own step recurrence, which the decode path runs."""
    B, S, H, K, Vd = 1, 40, 2, 8, 8
    rng = np.random.default_rng(24)
    t = torch.from_numpy
    q, k = (t(rng.standard_normal((B, S, H, K)).astype(np.float32))
            for _ in range(2))
    v = t(rng.standard_normal((B, S, H, Vd)).astype(np.float32))
    ld = t(-rng.uniform(0.05, 0.5, (B, S, H, K)).astype(np.float32))
    u = t(rng.standard_normal((H, K)).astype(np.float32))
    got, st_got = ops.linear_scan(q, k, v, ld, bonus=u, chunk=128)
    st = torch.zeros((B, H, K, Vd))
    outs = []
    for i in range(S):
        o, st = ref.linear_scan_step(q[:, i], k[:, i], v[:, i], ld[:, i], st,
                                     u)
        outs.append(o)
    _close(got, torch.stack(outs, 1).numpy(), 1e-3)
    _close(st_got, st.numpy(), 1e-3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("vec", [False, True])
def test_linear_scan_step_matches_jax(vec, dtype):
    B, H, K, Vd = 2, 3, 8, 12
    rng = np.random.default_rng(25)
    qj, qt = _both(rng.standard_normal((B, H, K)), dtype)
    kj, kt = _both(rng.standard_normal((B, H, K)), dtype)
    vj, vt = _both(rng.standard_normal((B, H, Vd)), dtype)
    ld = -rng.uniform(0.01, 1.0, (B, H, K) if vec else (B, H)).astype(
        np.float32)
    st = rng.standard_normal((B, H, K, Vd)).astype(np.float32)
    u = rng.standard_normal((H, K)).astype(np.float32) if vec else None
    want, wst = jref.linear_scan_step(qj, kj, vj, jnp.asarray(ld),
                                      jnp.asarray(st),
                                      None if u is None else jnp.asarray(u))
    got, gst = ops.linear_scan_step(qt, kt, vt, torch.from_numpy(ld),
                                    torch.from_numpy(st),
                                    None if u is None else torch.from_numpy(u))
    assert got.dtype == qt.dtype
    _close(got, want, SCAN_TOL[dtype])
    _close(gst, wst, 2e-5)


@pytest.mark.parametrize("window,cap", [(0, 0.0), (3, 0.0), (0, 25.0)])
def test_decode_attention_matches_jax(window, cap):
    B, S, H, Hkv, D = 2, 10, 4, 2, 16
    rng = np.random.default_rng(26)
    q = rng.standard_normal((B, 1, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    n = np.asarray([4, 10], np.int32)
    want = jref.decode_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), jnp.asarray(n),
                                     window=window, softcap=cap)
    t = torch.from_numpy
    got = ops.decode_attention(t(q), t(k), t(v), t(n), window=window,
                               softcap=cap)
    _close(got, want, 2e-5)


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_wrappers_reject_what_the_kernels_do_not_take():
    q, kv = _meta(1, 8, 4, 16), _meta(1, 8, 2, 16)
    with pytest.raises(ValueError, match="multiple"):
        fa.flash_attention(q, _meta(1, 8, 3, 16), _meta(1, 8, 3, 16))
    with pytest.raises(ValueError, match="float32"):
        fa.flash_attention(q, kv.float(), kv)
    with pytest.raises(ValueError, match="Dv <= 128"):
        fa.flash_attention(q, kv, _meta(1, 8, 2, 256))
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q.transpose(1, 2), kv, kv)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fa.flash_attention(q.half(), kv.half(), kv.half())

    x = _meta(2, 16, 4, 32)
    ld = _meta(2, 16, 4, dtype=torch.float32)
    with pytest.raises(ValueError, match="zero state"):
        ls.linear_scan(x, x, x, ld, state=torch.zeros(2, 4, 32, 32))
    with pytest.raises(ValueError, match="zero state"):      # on the CPU too
        c = torch.zeros(2, 16, 4, 32)
        ls.linear_scan(c, c, c, torch.zeros(2, 16, 4),
                       state=torch.zeros(2, 4, 32, 32))
    with pytest.raises(ValueError, match="log_decay"):
        ls.linear_scan(x, x, x, ld.to(torch.bfloat16))
    with pytest.raises(ValueError, match="log_decay"):
        ls.linear_scan(x, x, x, _meta(2, 16, 4, 8, dtype=torch.float32))
    with pytest.raises(ValueError, match="dense in its last dim"):
        ls.linear_scan(x.transpose(2, 3).contiguous().transpose(2, 3), x, x,
                       ld)
    with pytest.raises(ValueError, match="shared memory"):
        ls.linear_scan(_meta(1, 512, 1, 128), _meta(1, 512, 1, 128),
                       _meta(1, 512, 1, 128),
                       _meta(1, 512, 1, 128, dtype=torch.float32),
                       bonus=_meta(1, 128, dtype=torch.float32), chunk=256)
    with pytest.raises(ValueError, match="bonus"):
        ls.linear_scan(x, x, x, ld, bonus=_meta(3, 32, dtype=torch.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_wrapper_accepts_every_head_dim_it_took(dtype):
    """Every D in 1..256 and Dv in 1..128 passes the wrapper's checks in
    both dtypes (the bf16 kernel pads both to multiples of 16), and what lies
    outside is refused, as before."""
    def meta(*shape):
        return _meta(*shape, dtype=dtype)

    for D in range(1, fa.MAX_D + 1):
        Dv = min(D, fa.MAX_DV)
        fa.check_inputs(meta(2, 9, 6, D), meta(2, 5, 2, D), meta(2, 5, 2, Dv))
    for Dv in range(1, fa.MAX_DV + 1):
        fa.check_inputs(meta(1, 7, 3, 192), meta(1, 7, 1, 192),
                        meta(1, 7, 1, Dv))
    for D, Dv in ((257, 64), (64, 129), (0, 64), (64, 0)):
        with pytest.raises(ValueError, match="D <= 256 and Dv <= 128"):
            fa.check_inputs(meta(1, 4, 2, D), meta(1, 4, 2, D),
                            meta(1, 4, 2, Dv))
    with pytest.raises(ValueError, match="window"):
        fa.check_inputs(meta(1, 4, 2, 8), meta(1, 4, 2, 8), meta(1, 4, 2, 8),
                        window=-1)
    with pytest.raises(ValueError, match="grid"):       # B * Hkv
        fa.check_inputs(meta(65536, 1, 1, 8), meta(65536, 1, 1, 8),
                        meta(65536, 1, 1, 8))


def test_stride_zero_heads_are_read_in_place():
    """Mamba2's B/C arrive as stride-0 views over the heads; the wrapper
    takes them as they are (on the CPU: the plain version, same numbers as
    a materialised copy)."""
    rng = np.random.default_rng(27)
    bm = torch.from_numpy(rng.standard_normal((2, 20, 1, 8)).astype(
        np.float32))
    qk = bm.expand(2, 20, 5, 8)
    v = torch.from_numpy(rng.standard_normal((2, 20, 5, 4)).astype(
        np.float32))
    ld = torch.from_numpy(-rng.uniform(0.01, 1.0, (2, 20, 5)).astype(
        np.float32))
    a = ls.linear_scan(qk, qk, v, ld, chunk=8)
    b = ls.linear_scan(qk.contiguous(), qk.contiguous(), v, ld, chunk=8)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


# (B, Sq, Sk, H, Hkv, D, Dv, causal, window, softcap): the flash kernel's
# edges on the card -- head dims 1..256 (16-byte copies or element copies,
# padding to 16), G in {1, 2, 3, 4, 9}, S off the 64-key tile, a window
# that leaves a row's first tiles wholly masked, a softcap, Sq != Sk
FLASH_CARD_CASES = [
    (1, 130, 130, 2, 2, 16, 16, True, 0, 0.0),
    (2, 200, 200, 8, 2, 80, 80, True, 0, 0.0),
    (1, 300, 300, 4, 2, 128, 128, True, 70, 50.0),
    (1, 150, 150, 3, 1, 192, 128, True, 0, 0.0),      # MLA's D / Dv
    (1, 100, 100, 9, 1, 128, 128, True, 0, 0.0),      # starcoder2's G
    (1, 260, 260, 2, 2, 64, 64, True, 100, 0.0),
    (2, 96, 160, 4, 4, 32, 32, True, 0, 0.0),
    (1, 160, 96, 4, 2, 48, 48, False, 0, 0.0),
    (1, 77, 77, 4, 4, 20, 20, True, 0, 0.0),
    (1, 90, 90, 2, 1, 256, 100, False, 30, 0.0),
    (1, 64, 64, 2, 2, 1, 1, True, 0, 0.0),
]


@pytest.mark.cuda
def test_cuda_kernels_match_plain_versions_on_card():
    """Both CUDA kernels against their plain versions on the card: flash
    with GQA, a window and a softcap, D = 80, a ragged S, and at
    ``FLASH_CARD_CASES``, in both dtypes; the scan with scalar decay
    through stride-0 heads and with vector decay and a bonus, several
    chunks, S off the chunk, and decays that take -cl past the 75 clamp."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    g = torch.Generator(device="cuda").manual_seed(28)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    for dtype in (torch.float32, torch.bfloat16):
        att = ATT_TOL[str(dtype)[6:]]
        for (B, S, H, Hkv, D, window, cap) in ((2, 200, 8, 2, 80, 0, 0.0),
                                                (1, 300, 4, 2, 128, 70, 50.0)):
            q, k, v = (randn(B, S, h, D, dtype=dtype)
                       for h in (H, Hkv, Hkv))
            got = fa.flash_attention(q, k, v, window=window, softcap=cap)
            want = ref.flash_attention_ref(q, k, v, window=window,
                                           softcap=cap)
            assert float((got.float() - want.float()).abs().max()) <= att
        # the edges, at chip_smoke.py's rule: |a - b| <= tol + tol |b|
        for (B, Sq, Sk, H, Hkv, D, Dv, causal, window,
             cap) in FLASH_CARD_CASES:
            q = randn(B, Sq, H, D, dtype=dtype)
            k = randn(B, Sk, Hkv, D, dtype=dtype)
            v = randn(B, Sk, Hkv, Dv, dtype=dtype)
            kw = dict(causal=causal, window=window, softcap=cap)
            got = fa.flash_attention(q, k, v, **kw).float()
            want = ref.flash_attention_ref(q, k, v, **kw).float()
            assert bool(((got - want).abs()
                         <= att + att * want.abs()).all())
        tol = SCAN_TOL[str(dtype)[6:]]
        bm = randn(2, 300, 1, 64, dtype=dtype).expand(2, 300, 6, 64)
        v = randn(2, 300, 6, 64, dtype=dtype)
        ld = -torch.rand((2, 300, 6), generator=g, device="cuda")
        # decays of 0.6-0.8 (chunk 128) and 2.4-2.6 (chunk 32) a step: -cl
        # passes the clamp inside a chunk
        steep = -(0.6 + 0.2 * torch.rand((2, 300, 6), generator=g,
                                         device="cuda"))
        steep_vec = -(2.4 + 0.2 * torch.rand((2, 300, 6, 64), generator=g,
                                             device="cuda"))
        for args, kw in (((bm, bm, v, ld), dict(chunk=128)),
                         ((v, v, v, ld[..., None].expand(2, 300, 6, 64)
                           .contiguous()),
                          dict(chunk=32, bonus=randn(6, 64))),
                         ((bm, bm, v, steep), dict(chunk=128)),
                         ((v, v, v, steep_vec),
                          dict(chunk=32, bonus=randn(6, 64)))):
            got, st = ls.linear_scan(*args, **kw)
            want, st_want = ref.linear_scan_ref(*args, **kw)
            assert float((got.float() - want.float()).abs().max()) <= tol
            assert float((st - st_want).abs().max()) <= tol * max(
                1.0, float(st_want.abs().max()))
