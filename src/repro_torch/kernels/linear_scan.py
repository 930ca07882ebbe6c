"""Chunked gated linear scan (Mamba2 / RWKV6): the wrapper of
``csrc/linear_scan.cu``.

Replaces the reference's Pallas TPU kernel ``linear_scan_pallas``
(``src/repro/kernels/linear_scan.py:81``): S_t = a_t S_{t-1} + k_t v_t^T
in the chunked SSD form of
:func:`~repro_torch.kernels.ref.linear_scan_ref`, scalar (Mamba2) or
per-K vector (RWKV6) decay, the RWKV6 bonus, from a zero state.  The TPU
kernel walks the chunks in order; on the card one call runs three
launches, so the chunk-local work runs in parallel over (batch, head,
chunk) (:func:`~repro_torch.kernels.ref.linear_scan_chunked_ref` is the
same split in plain PyTorch):

1. per chunk, its total decay and its state contribution k_rem^T v, f32,
   into a ``(B, H, n_chunks, K, Vd)`` scratch from ``torch.empty``;
2. the state passed from chunk to chunk, parallel over (batch, head, K,
   Vd): each chunk's incoming state, and the final state;
3. per chunk, the output from its scores and its incoming state.

In bf16 at the main paths' shapes phases 1 and 3 run their products on the
tensor cores (``mma.sync``); f32 runs on the CUDA cores.

Inputs are read through their strides (the last dim must be dense): the
Mamba2 B and C matrices, shared by every head, arrive as stride-0 views
over the heads and are never copied per head.

:func:`linear_scan` takes the plain version only for tensors on the CPU;
for CUDA tensors it checks what the kernels rely on, launches them on the
current stream, counts the call in ``build.launch_counts`` (one count for
the three launches), and raises if a launch failed.  There is no fallback
from a CUDA tensor to the plain version.  Like the TPU kernel it starts
from a zero state only: a given ``state`` raises on every device.

Gradients: :class:`LinearScan` is the ``torch.autograd.Function`` over the
kernels, and the only caller of :func:`linear_scan` that may hand it
inputs requiring grad.  Its forward is the kernels (the plain version on
the CPU); its backward recomputes the plain version from the saved
inputs under ``torch.enable_grad()`` and returns its VJP for q, k, v,
``log_decay`` and ``bonus``.  The reference has no backward kernel either
(its trainer differentiates the XLA path), so this is the reference's own
gradient, not a fallback: the forward stays on the kernels.  Mamba2's B
and C stay stride-0 views in the forward; the backward returns their
full-shaped grads and the ``expand`` that made the views sums them over
the heads.  The final state has no gradient: train mode does not read it.
:func:`linear_scan` called directly on inputs that require grad, with
grad mode on, raises ``RuntimeError``, since its outputs would carry no
``grad_fn``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.build import check, count, raise_on

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_SMEM = 232448        # bytes of shared memory a block may use on sm_90
ZERO_STATE_ONLY = ("the kernel computes from a zero state (prefill); an "
                   "initial state is not taken")


def mma_shape(K: int, Vd: int, L: int) -> bool:
    """Whether bf16 runs phases 1 and 3 on the tensor cores (``mma_shape``
    in the source): K, Vd and the chunk L multiples of 16, at most 128."""
    return (L % 16 == 0 and 16 <= L <= 128 and K % 16 == 0 and K <= 128
            and Vd % 16 == 0 and Vd <= 128)


def smem_bytes(K: int, Vd: int, Kd: int, L: int, has_bonus: bool,
               dtype: torch.dtype = torch.float32) -> int:
    """Shared memory of the largest block one call launches
    (``smem_bytes`` in the source).  Tensor cores (bf16 at
    :func:`mma_shape`): bf16 rows padded by 16 bytes -- phase 1 k_rem (hi
    and lo) and v, phase 3 q and k (and the lo halves of q_eff and k_eff
    with a vector decay), v and the incoming state (hi and lo) -- and the
    f32 decay columns (twice with a bonus) and diagonal.  CUDA cores: f32
    rows of q and k at an odd stride, v, the decay columns, the L x L
    scores, the diagonal, the state and the bonus (phase 3; phase 1 is
    smaller)."""
    nd = 2 if has_bonus else 1
    if dtype == torch.bfloat16 and mma_shape(K, Vd, L):
        phase1 = 2 * (2 * L * (K + 8) + L * (Vd + 8)) + 4 * L * Kd
        phase3 = (2 * ((4 if Kd > 1 else 2) * L * (K + 8) + L * (Vd + 8)
                       + 2 * K * (Vd + 8)) + 4 * (nd * L * Kd + L))
    else:
        phase1 = 4 * (L * (K | 1) + L * Vd + L * Kd)
        phase3 = 4 * (2 * L * (K | 1) + L * Vd + nd * L * Kd + L * L + L
                      + K * Vd + K)
    return max(phase1, phase3)


def _rows_16b(t: torch.Tensor) -> bool:
    """Whether every (batch, time, head) row of ``t`` starts 16 bytes
    aligned, so the kernels may read it 16 bytes at a time."""
    per = 16 // t.element_size()
    return t.data_ptr() % 16 == 0 and all(st % per == 0
                                          for st in t.stride()[:3])


def linear_scan(
    q: torch.Tensor,              # (B, S, H, K)
    k: torch.Tensor,              # (B, S, H, K)
    v: torch.Tensor,              # (B, S, H, Vd)
    log_decay: torch.Tensor,      # (B, S, H) scalar or (B, S, H, K) vector
    *,
    state: Optional[torch.Tensor] = None,
    bonus: Optional[torch.Tensor] = None,   # (H, K)
    chunk: int = 128,
    clamp: float = 75.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out (B, S, H, Vd) in v's dtype, final state (B, H, K, Vd) f32)``.
    No gradient: see :class:`LinearScan`."""
    build.refuse_grad("linear_scan", q, k, v, log_decay, bonus)
    check(state is None, ZERO_STATE_ONLY)
    if q.device.type == "cpu":
        return _ref.linear_scan_ref(q, k, v, log_decay, bonus=bonus,
                                    chunk=chunk, clamp=clamp)
    check(q.dim() == 4 and k.shape == q.shape and v.dim() == 4,
          f"q {tuple(q.shape)} and k {tuple(k.shape)} must be (B, S, H, K), "
          f"v (B, S, H, Vd)")
    B, S, H, K = q.shape
    Vd = v.shape[3]
    vec = log_decay.dim() == 4
    Kd = K if vec else 1
    check(tuple(v.shape[:3]) == (B, S, H), f"v {tuple(v.shape)} does not "
          f"match q {tuple(q.shape)}")
    check(tuple(log_decay.shape) == ((B, S, H, K) if vec else (B, S, H)),
          f"log_decay {tuple(log_decay.shape)} must be (B, S, H) or "
          f"(B, S, H, K)")
    check(log_decay.dtype == torch.float32, "log_decay must be float32")
    dev = q.device
    for name, t in (("k", k), ("v", v), ("log_decay", log_decay)):
        check(t.device == dev, f"{name} on {t.device}, q on {dev}")
    check(q.dtype in _DTYPES and k.dtype == q.dtype and v.dtype == q.dtype,
          f"q, k, v must share float32 or bfloat16, got {q.dtype}/"
          f"{k.dtype}/{v.dtype}")
    ld = log_decay if vec else log_decay[..., None]
    for name, t in (("q", q), ("k", k), ("v", v), ("log_decay", ld)):
        check(t.stride(3) == 1 or t.shape[3] == 1,
              f"{name} must be dense in its last dim")
        check(min(t.stride()) >= 0, f"{name} has a negative stride")
    check(chunk >= 1 and S >= 1, f"need chunk >= 1 and S >= 1, got "
          f"{chunk}/{S}")
    check(B * H <= 65535, f"B * H = {B * H} exceeds the state pass's grid")
    smem = smem_bytes(K, Vd, Kd, chunk, bonus is not None, q.dtype)
    check(smem <= MAX_SMEM, f"chunk {chunk} at K={K}, Vd={Vd} needs {smem} "
          f"bytes of shared memory, more than {MAX_SMEM}")
    u = None
    if bonus is not None:
        check(tuple(bonus.shape) == (H, K), f"bonus must be ({H}, {K})")
        check(bonus.device == dev, f"bonus on {bonus.device}, q on {dev}")
        u = bonus.to(torch.float32).contiguous()
    out = torch.empty((B, S, H, Vd), dtype=v.dtype, device=dev)
    st = torch.empty((B, H, K, Vd), dtype=torch.float32, device=dev)
    n = -(-S // chunk)
    ds = torch.empty((B, H, n, K, Vd), dtype=torch.float32, device=dev)
    tot = torch.empty((B, H, n, Kd), dtype=torch.float32, device=dev)
    vec = all(_rows_16b(t) for t in (q, k, v))
    p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
        ctypes.c_longlong
    err = build.entry("linear_scan",
                      [i] + [p] * 9 + [i] * 7 + [f] + [ll] * 12 + [i, p])(
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        ld.data_ptr(), None if u is None else u.data_ptr(), out.data_ptr(),
        st.data_ptr(), ds.data_ptr(), tot.data_ptr(), B, S, H, K, Vd, Kd,
        chunk, float(clamp), *q.stride()[:3], *k.stride()[:3],
        *v.stride()[:3], *ld.stride()[:3], int(vec),
        torch.cuda.current_stream(dev).cuda_stream)
    raise_on(err, "linear_scan")
    count("linear_scan")
    return out, st


class LinearScan(torch.autograd.Function):
    """:func:`linear_scan` with a gradient: the kernels' forward, the plain
    version's VJP backward (module docstring).  Returns ``(out, final
    state)``, the state marked non-differentiable."""

    @staticmethod
    def forward(ctx, q, k, v, log_decay, bonus, chunk, clamp):
        ctx.save_for_backward(q, k, v, log_decay, bonus)
        ctx.args = dict(chunk=chunk, clamp=clamp)
        out, st = linear_scan(q, k, v, log_decay, bonus=bonus, **ctx.args)
        ctx.mark_non_differentiable(st)
        return out, st

    @staticmethod
    def backward(ctx, g, _g_state):
        ins = [None if t is None else t.detach().requires_grad_(need)
               for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        plain = lambda q, k, v, ld, u: _ref.linear_scan_ref(
            q, k, v, ld, bonus=u, **ctx.args)[0]
        return build.vjp("linear_scan", plain, ins, g) + (None, None)
