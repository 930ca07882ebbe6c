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


def abstract(tree):
    """Spec tree -> tree of ``meta`` tensors (the dry-run: no allocation)."""
    if isinstance(tree, Spec):
        return torch.empty(tree.shape, dtype=torch_dtype(tree.dtype),
                           device="meta")
    return {k: abstract(v) for k, v in tree.items()}


def axes_tree(tree):
    """Spec tree -> logical-axes tree."""
    if isinstance(tree, Spec):
        return tree.axes
    return {k: axes_tree(v) for k, v in tree.items()}


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


# Rows a no-gradient rms_norm takes at a time: each of its two f32
# temporaries is one chunk's (256 MiB at d_model 8192), not the whole
# input's (a prefill_32k rank's 65536 rows: 2 GiB each at d_model 8192).
# 8192 rows still give a launch 8M+ elements to fill the card; serving's
# decode steps and 32-token chunks stay below it and keep their one pass.
NORM_CHUNK_ROWS = 8192


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * (1 + scale)`` over the last dim, in
    f32, cast back to ``x.dtype``.  Where no gradient is taken the same
    products run in the same order a row chunk at a time
    (:data:`NORM_CHUNK_ROWS`) into one output, so only one chunk's f32
    temporaries are live; a DTensor whose last dim is whole is normed on
    each rank's local shard (:func:`_norm_local`).  A non-contiguous x
    that its rows cannot view is copied (in x.dtype) before the chunks."""
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        x32 = x.float()
        var = torch.mean(x32 * x32, dim=-1, keepdim=True)
        out = x32 * torch.rsqrt(var + eps) * (1.0 + scale.float())
        return out.to(x.dtype)
    return _norm_local(x, scale, eps)


def _norm_local(x: torch.Tensor, scale: torch.Tensor, eps: float):
    """The no-gradient norm: under a mesh on each rank's local rows (no
    collective: the last dim is whole on every rank), the output in x's
    own placements and global shape (uneven shards too); where the last
    dim is sharded or x is a ``Partial`` sum, DTensor's own ops on the
    whole."""
    from repro_torch.parallel.sharding import (along_last_placements,
                                               is_dtensor)
    if not is_dtensor(x):
        return _norm_rows(x, scale, eps)
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh, where = x.device_mesh, tuple(x.placements)
    if not all(isinstance(p, Replicate) or (isinstance(p, Shard)
                                            and p.dim % x.dim() != x.dim() - 1)
               for p in where):
        return _norm_pass(x, 1.0 + scale.float(), eps)
    stride = tuple(math.prod(x.shape[d + 1:]) for d in range(x.dim()))
    if is_dtensor(scale):
        # a scale sharded over an axis over which x is whole is used where
        # it lies: the output is cut there to the scale's slice of the
        # last dim (``along_last``), the mean still over whole rows
        cut, want = along_last_placements(x, scale)
        scale = scale.redistribute(mesh, want).to_local()
        if cut != where:
            from torch.distributed.tensor._utils import (
                compute_local_shape_and_global_offset)
            lo = compute_local_shape_and_global_offset(
                x.shape, mesh, cut)[1][x.dim() - 1]
            out = _norm_pass(x.to_local(), 1.0 + scale.float(), eps,
                             cut=(lo, lo + scale.shape[0]))
            return DTensor.from_local(out.contiguous(), mesh, cut,
                                      run_check=False, shape=x.shape,
                                      stride=stride)
    out = _norm_rows(x.to_local(), scale, eps).contiguous()
    return DTensor.from_local(out, mesh, where, run_check=False,
                              shape=x.shape, stride=stride)


def _norm_rows(x: torch.Tensor, scale: torch.Tensor, eps: float):
    """One pass when x has at most :data:`NORM_CHUNK_ROWS` rows, else a
    chunk of rows at a time into one output of ``x.dtype``."""
    d = x.shape[-1]
    rows = x.numel() // d if d else 0
    s = 1.0 + scale.float()
    if rows <= NORM_CHUNK_ROWS:
        return _norm_pass(x, s, eps)
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    xs, outs = x.reshape(rows, d), out.view(rows, d)
    for i in range(0, rows, NORM_CHUNK_ROWS):
        _norm_pass(xs[i:i + NORM_CHUNK_ROWS], s, eps,
                   outs[i:i + NORM_CHUNK_ROWS])
    return out


def _norm_pass(x: torch.Tensor, s: torch.Tensor, eps: float,
               out: Optional[torch.Tensor] = None,
               cut: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """The norm of rows ``x`` scaled by ``s`` (``1 + scale`` in f32), into
    ``out`` when given: the grad path's products in its order, in place
    on the f32 copy (one f32 temporary of x's size, not two).  With
    ``cut`` (``lo``, ``hi``) only those entries of each row are scaled
    and returned (``s`` their scale), the mean still over whole rows."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    r = torch.rsqrt(var + eps)
    theirs = x32 is x             # f32: x is the caller's, left as it is
    if cut is not None:
        x, x32 = x[..., cut[0]:cut[1]], x32[..., cut[0]:cut[1]]
    if theirs:
        y = torch.mul(x, r) if out is None else torch.mul(x, r, out=out)
        return y.mul_(s)
    x32.mul_(r).mul_(s)
    return x32.to(x.dtype) if out is None else out.copy_(x32)


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


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor,
                 stationary: bool = False) -> torch.Tensor:
    """Rows ``tokens`` of the embedding table.  Under a mesh (DTensor
    table and tokens) no rank holds the table whole: each looks up, on
    the vocab rows it holds, the tokens those rows answer and zeros for
    the rest, and the sum over the vocab's ranks completes each row (a
    ``Partial`` result, exact: one rank holds each row; the stream's
    first ``constrain`` sums it).  Train and prefill gather the rank's
    vocab slice whole over the axes that shard the embed dim, the FSDP
    axes (``sharding.gather_chunks``: its backward reduce-scatters the
    table's gradient to the shards), and each rank looks up its own
    batch's tokens there.  With ``stationary`` (decode: a few tokens)
    the table stays where it lies and the tokens move: each rank looks
    up every token on its slice of the vocab and of the embed dim."""
    from repro_torch.parallel.sharding import (gather_chunks, is_dtensor,
                                               local_map, partial_over,
                                               replicated_like, shard_index)
    if not is_dtensor(table):
        return F.embedding(tokens.long(), table)
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = table.device_mesh
    tok = tokens if is_dtensor(tokens) else replicated_like(tokens, table)
    w_at = list(table.placements)
    # decode's tokens come whole; train's and prefill's are whole over
    # the vocab's axes and stay as they lie over the others
    t_at = [Replicate() if stationary or isinstance(p, Shard) and p.dim == 0
            else q for p, q in zip(w_at, tok.placements)]
    v_idx, _ = shard_index(mesh, w_at, 0)

    def lookup(t, w):
        ids = t.long() - v_idx * w.shape[0]
        here = (ids >= 0) & (ids < w.shape[0])
        ids = ids.clamp(0, w.shape[0] - 1)
        if stationary:
            rows = F.embedding(ids, w)
        else:
            # the slice's embed chunks (n, V / vocab ranks, D / n) looked up
            # as one table of n x V / vocab ranks rows (F.embedding's
            # backward sums a row's repeats as the unsharded lookup's
            # does), each token's n rows then laid side by side; the
            # slice let go first
            w = gather_chunks(w, mesh, w_at, 1, t_at)
            n, v = w.shape[:2]
            at = ids.reshape(1, -1) + v * torch.arange(
                n, device=ids.device)[:, None]
            del ids
            rows = F.embedding(at, w.reshape(n * v, -1))
            del w, at
            rows = rows.permute(1, 0, 2).reshape(*here.shape, -1)
        return rows.masked_fill_(~here[..., None], 0)

    out = [Partial() if isinstance(p, Shard) and p.dim == 0 else
           Shard(tok.dim()) if isinstance(p, Shard) and stationary else q
           for p, q in zip(w_at, t_at)]
    return local_map(lookup, out, (t_at, w_at),
                     (t_at, partial_over(w_at, t_at)))(tok, table)


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


def linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with ``w`` (K, N) cast to ``x.dtype`` (bf16 weights under
    an f32 model compute in f32, as jnp's type promotion does).  Under a
    mesh, a weight still sharded over an FSDP axis -- decode leaves each
    layer's matrices where they lie -- is used where it lies
    (``parallel/sharding.py::stationary_matmul``)."""
    from repro_torch.parallel.sharding import fsdp_sharded, stationary_matmul
    w = w.to(x.dtype)
    if fsdp_sharded(w):
        return stationary_matmul(x, w)
    return x @ w


def mlp_apply(p: Dict[str, torch.Tensor], x: torch.Tensor, act: str) -> torch.Tensor:
    """Weights are cast to ``x.dtype`` (bf16 weights under an f32 model
    compute in f32, as jnp's type promotion does)."""
    f = activation(act)
    if "wi_gate" in p:
        h = f(linear(x, p["wi_gate"])) * linear(x, p["wi_up"])
    else:
        h = f(linear(x, p["wi"]))
    return linear(h, p["wo"])
