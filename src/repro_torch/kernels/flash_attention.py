"""Flash attention: the wrapper of ``csrc/flash_attention.cu``.

Replaces the reference's Pallas TPU kernel ``flash_attention_pallas``
(``src/repro/kernels/flash_attention.py:94``): full-sequence attention,
causal or bidirectional, with an optional sliding window and logit
softcap, GQA, Sq != Sk and Dv != D.  Its callers are every full-sequence
attention of ``models/attention.py``: causal self attention (GQA, local
windows, softcaps), MLA's explicit form at D = 192 over Dv = 128, cross
attention (bidirectional, queries over a frontend's T tokens), and an
encoder's bidirectional self attention.  On the card it is bound by its
operations, not its bytes, at prefill lengths.  In bf16 the kernel runs both products on the tensor
cores (``mma.sync``), keeps Q and the online-softmax state in registers,
and double-buffers 64-key K/V tiles in shared memory with ``cp.async``;
in float32 it runs on the CUDA cores, since the reference's f32 products
are full f32 (see the source for both layouts).

:func:`flash_attention` takes the plain PyTorch version
(:func:`~repro_torch.kernels.ref.flash_attention_ref`) only for tensors on
the CPU; for CUDA tensors it checks what the kernel relies on
(:func:`check_inputs`), launches it on the current stream, counts the
launch in ``build.launch_counts``, and raises if the launch failed.  There
is no fallback from a CUDA tensor to the plain version.

Gradients: :class:`FlashAttention` is the ``torch.autograd.Function``
over the kernel, and the only caller of :func:`flash_attention` that may
hand it inputs requiring grad.  Its forward is the kernel (the plain
version on the CPU); its backward recomputes the plain version from the
saved q, k, v under ``torch.enable_grad()`` and returns its VJP.  The
reference has no backward kernel either (its Pallas kernel has no
``custom_vjp``, and its trainer differentiates the XLA path), so this is
the reference's own gradient, not a fallback: the forward stays on the
kernel.  :func:`flash_attention` called directly on inputs that require
grad, with grad mode on, raises ``RuntimeError``: the kernel writes into a
fresh tensor with no ``grad_fn``, so autograd would silently stop there.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.build import check, count, raise_on

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_D = 256       # bf16: D / 16 Q fragments in registers; f32: shared memory
MAX_DV = 128      # accumulator registers: Dv / 2 a thread (bf16), Dv / 4 (f32)
MAX_GRID_Y = 65535   # the grid's second dimension: B * Hkv


def check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 window: int = 0, q_offset: int = 0) -> None:
    """Raise ``ValueError`` on what the kernel does not take."""
    check(q.dim() == 4 and k.dim() == 4 and v.dim() == 4,
          "q, k, v must be (B, S, heads, dim)")
    B, Sq, H, D = q.shape
    _, Sk, Hkv, Dk = k.shape
    Dv = v.shape[3]
    dev = q.device
    for name, t in (("k", k), ("v", v)):
        check(t.device == dev, f"{name} on {t.device}, q on {dev}")
        check(t.dtype == q.dtype, f"{name} is {t.dtype}, q is {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        check(t.is_contiguous(), f"{name} must be contiguous")
    check(q.dtype in _DTYPES, f"dtype must be float32 or bfloat16, got "
          f"{q.dtype}")
    check(k.shape[0] == B and tuple(v.shape[:3]) == (B, Sk, Hkv),
          f"k {tuple(k.shape)} and v {tuple(v.shape)} do not match q "
          f"{tuple(q.shape)}")
    check(Dk == D, f"q has D={D}, k has {Dk}")
    check(H % Hkv == 0, f"H={H} is not a multiple of Hkv={Hkv}")
    check(0 < D <= MAX_D and 0 < Dv <= MAX_DV,
          f"kernel takes D <= {MAX_D} and Dv <= {MAX_DV}, got {D}/{Dv}")
    check(window >= 0, f"window must be >= 0, got {window}")
    check(q_offset >= 0, f"q_offset must be >= 0, got {q_offset}")
    check(B * Hkv <= MAX_GRID_Y, f"B * Hkv = {B * Hkv} exceeds the grid")


def flash_attention(
    q: torch.Tensor,              # (B, Sq, H, D)
    k: torch.Tensor,              # (B, Sk, Hkv, D)
    v: torch.Tensor,              # (B, Sk, Hkv, Dv)
    *,
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
    scale: Optional[float] = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """``(B, Sq, H, Dv)`` in q's dtype.  Causal masking aligns q[0] with
    k[q_offset]: query row s sits at absolute position s + q_offset (a
    context-parallel shard's slice of the sequence; 0, the TPU kernel's
    only case, aligns q[0] with k[0]).  Every row must see a key (an
    offset row past the keys' end under a window sees none: the kernel
    writes zeros there, the plain version an average).  No gradient: see
    :class:`FlashAttention`."""
    build.refuse_grad("flash_attention", q, k, v)
    if q.device.type == "cpu":
        return _ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                        softcap=softcap, scale=scale,
                                        q_offset=q_offset)
    check_inputs(q, k, v, window, q_offset)
    B, Sq, H, D = q.shape
    Sk, Hkv, Dv = k.shape[1], k.shape[2], v.shape[3]
    dev = q.device
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    out = torch.empty((B, Sq, H, Dv), dtype=q.dtype, device=dev)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    err = build.entry("flash_attention",
                      [i, p, p, p, p, i, i, i, i, i, i, i, f, f, i, i, i, p])(
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), B, Sq, Sk, H, Hkv, D, Dv, float(scale),
        float(softcap or 0.0), int(bool(causal)), int(window), int(q_offset),
        torch.cuda.current_stream(dev).cuda_stream)
    raise_on(err, "flash_attention")
    count("flash_attention")
    return out


class FlashAttention(torch.autograd.Function):
    """:func:`flash_attention` with a gradient: the kernel forward, the
    plain version's VJP backward (module docstring)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, scale, q_offset=0):
        ctx.save_for_backward(q, k, v)
        ctx.args = dict(causal=causal, window=window, softcap=softcap,
                        scale=scale, q_offset=q_offset)
        return flash_attention(q, k, v, **ctx.args)

    @staticmethod
    def backward(ctx, g):
        ins = [t.detach().requires_grad_(need)
               for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        plain = lambda q, k, v: _ref.flash_attention_ref(q, k, v, **ctx.args)
        return build.vjp("flash_attention", plain, ins, g) + (None,) * 5
