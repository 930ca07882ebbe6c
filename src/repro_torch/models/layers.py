"""Shared model primitives: norms, RoPE, activations, the dense MLP, and the
parameter specs and initialiser.

Parameters are plain nested dicts of tensors with the reference package's
key layout, so weights bridge 1:1 (``repro_torch.bridge``).  Every leaf is
declared through :class:`Spec`.  The numerics follow the reference's
``models/layers.py`` exactly where parity depends on it: RMSNorm scales by
``1 + scale`` in f32 and casts back, RoPE rotates interleaved even/odd
pairs (partial rotary) with cos/sin cast to the input dtype, and GELU is
the tanh approximation (``jax.nn.gelu``'s default).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

# ----------------------------------------------------------------------------
# parameter specs
# ----------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Spec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]     # logical axis names, len == ndim
    init: str = "normal"                # normal | zeros | ones
    scale: float = 1.0
    dtype: str = "bfloat16"
    fan_in: Optional[int] = None        # preserved across layer stacking

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def torch_dtype(name) -> torch.dtype:
    """``"bfloat16"``/``"float32"`` (or a torch dtype) -> torch dtype."""
    if isinstance(name, torch.dtype):
        return name
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[str(name)]


def _init_leaf(spec: Spec, generator: torch.Generator, device) -> torch.Tensor:
    dt = torch_dtype(spec.dtype)
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dt, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dt, device=device)
    fan_in = spec.fan_in or (spec.shape[0] if spec.shape else 1)
    std = spec.scale / math.sqrt(max(1, fan_in))
    out = torch.empty(spec.shape, dtype=dt, device=device)
    # a stacked (layers, ...) leaf is drawn one layer at a time, so its f32
    # draw never exists whole next to the cast copy
    stacked = bool(spec.axes) and spec.axes[0] == "layers"
    for dst in (out.unbind(0) if stacked else (out,)):
        dst.copy_(torch.randn(dst.shape, generator=generator, device=device,
                              dtype=torch.float32) * std)
    return out


def materialize(tree, generator: torch.Generator, device):
    """Spec tree -> concrete parameter tree, leaves drawn in key order."""
    if isinstance(tree, Spec):
        return _init_leaf(tree, generator, device)
    return {k: materialize(v, generator, device) for k, v in sorted(tree.items())}


def stack_specs(tree, repeats: int):
    """Add a leading stacked-layer dimension to every Spec in the tree."""
    if isinstance(tree, Spec):
        s = tree
        return Spec((repeats,) + s.shape, ("layers",) + s.axes, s.init,
                    s.scale, s.dtype, s.fan_in or (s.shape[0] if s.shape else 1))
    return {k: stack_specs(v, repeats) for k, v in tree.items()}


# ----------------------------------------------------------------------------
# numerics
# ----------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(x.dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if not cap:
        return x
    return cap * torch.tanh(x / cap)


def rope_angles(positions: torch.Tensor, dim: int,
                theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions: (...,) -> cos/sin of shape (..., dim//2)."""
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                        device=positions.device) / dim))
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float,
                pct: float, dtype) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """The cos/sin tables :func:`rotate` applies, ``(..., 1, rot/2)`` in
    ``dtype``; None when nothing rotates.  Depend only on the positions, so
    a forward computes them once for all layers and both q and k."""
    rot = int(head_dim * pct)
    rot -= rot % 2
    if rot == 0:
        return None
    cos, sin = rope_angles(positions, rot, theta)          # (..., rot/2)
    return cos[..., None, :].to(dtype), sin[..., None, :].to(dtype)


def rotate(x: torch.Tensor, tables) -> torch.Tensor:
    """RoPE on interleaved even/odd pairs of the first ``rot`` features of
    x: (..., H, D), the rest passed through (partial rotary)."""
    if tables is None:
        return x
    cos, sin = tables
    rot = 2 * cos.shape[-1]
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    x1, x2 = x_rot[..., ::2], x_rot[..., 1::2]
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    out = torch.stack([o1, o2], dim=-1).reshape(x_rot.shape)
    return torch.cat([out, x_pass], dim=-1)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               pct: float = 1.0) -> torch.Tensor:
    """x: (..., H, D); positions: x.shape[:-2]. Partial rotary via pct."""
    return rotate(x, rope_tables(positions, x.shape[-1], theta, pct, x.dtype))


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def activation(name: str) -> Callable:
    return {"silu": F.silu, "gelu": _gelu_tanh, "relu": F.relu}[name]


# ----------------------------------------------------------------------------
# dense MLP
# ----------------------------------------------------------------------------


def mlp_specs(d_model: int, d_ff: int, act: str) -> Dict[str, Spec]:
    if act == "silu":  # SwiGLU: gate + up
        return {
            "wi_gate": Spec((d_model, d_ff), ("embed", "mlp")),
            "wi_up": Spec((d_model, d_ff), ("embed", "mlp")),
            "wo": Spec((d_ff, d_model), ("mlp", "embed")),
        }
    return {
        "wi": Spec((d_model, d_ff), ("embed", "mlp")),
        "wo": Spec((d_ff, d_model), ("mlp", "embed")),
    }


def mlp_apply(p: Dict[str, torch.Tensor], x: torch.Tensor, act: str) -> torch.Tensor:
    """Weights are cast to ``x.dtype`` (bf16 weights under an f32 model
    compute in f32, as jnp's type promotion does)."""
    f = activation(act)
    w = {k: v.to(x.dtype) for k, v in p.items()}
    if "wi_gate" in w:
        h = f(x @ w["wi_gate"]) * (x @ w["wi_up"])
    else:
        h = f(x @ w["wi"])
    return h @ w["wo"]
