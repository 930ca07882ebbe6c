"""Logical-axis -> mesh-axis sharding rules (MaxText-style), with per-tensor
conflict resolution and divisibility fallback: the reference's
``parallel/sharding.py`` onto a ``torch.distributed`` ``DeviceMesh``.

Production layout: FSDP over ``data`` (+``pod``), tensor/expert
parallelism over ``model``.  A logical dim is dropped to replicated when
(a) its mesh axis is already taken by an earlier dim of the same tensor or
(b) the dim size does not divide the axis size (e.g. whisper's 12 heads on
a 16-way model axis).  long_500k's sequence sharding (SP) falls out of
rule order: batch=1 fails divisibility, so ``kv_seq`` claims ``data``.

:func:`spec_for` returns the reference's ``PartitionSpec`` entries as a
plain tuple (``None | str | tuple[str, ...]`` per tensor dim, trailing
``None``s dropped); :func:`placements` turns one into DTensor placements.
A mesh is anything with ``mesh_dim_names`` and ``shape``: a
``DeviceMesh``, or an :class:`AbstractMesh` (names and sizes, no devices,
no process group) for deciding layouts alone.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

Spec = Tuple[Any, ...]

# logical axis -> candidate mesh targets, tried in order
# ("fsdp" resolves to ("pod","data"))
RULES: Dict[str, Any] = {
    "vocab": ["model"],
    "embed": ["fsdp"],
    "heads": ["model"],
    "kv_heads": ["model"],
    "heads_embed": ["model"],
    "mlp": ["model"],
    "mlp_state": ["model"],
    "experts": ["model"],
    "experts_router": [],
    "q_lora": [],
    "kv_lora": [],
    "head_dim": [],
    "layers": [],
    "conv": [],
    "lora": [],
    "seq": [],
    "embed2": ["fsdp"],
    "embed_out": [],
    # activations / caches
    "batch": ["fsdp"],
    # sequence dim of KV caches: claims whatever primary consumers left free
    # -- "fsdp" when batch=1 (long_500k SP), "model" when kv_heads doesn't
    # divide the model axis
    "kv_seq": ["fsdp", "model"],
}

# assignment priority: primary consumers claim axes before fallbacks
_PRIORITY = {
    "vocab": 0, "heads": 0, "kv_heads": 0, "heads_embed": 0, "mlp": 0,
    "mlp_state": 0, "experts": 0,
    "embed": 1, "embed2": 1, "batch": 1,
    "kv_seq": 9,
}


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's shape and axis names with no devices behind it (the
    counterpart of ``jax.sharding.AbstractMesh``)."""
    shape: Tuple[int, ...]
    mesh_dim_names: Tuple[str, ...]

    def size(self, dim: Optional[int] = None) -> int:
        return math.prod(self.shape) if dim is None else self.shape[dim]


def axis_names(mesh) -> Tuple[str, ...]:
    return tuple(mesh.mesh_dim_names or ())


def axis_size(mesh, name: str) -> int:
    return int(mesh.shape[axis_names(mesh).index(name)])


def fsdp_axes(mesh) -> Tuple[str, ...]:
    """The mesh's FSDP axes: ``("pod", "data")`` where present."""
    return tuple(a for a in ("pod", "data") if a in axis_names(mesh))


def _mesh_axes(mesh, target) -> Tuple[str, ...]:
    if target is None:
        return ()
    if isinstance(target, (list, tuple)):
        for t in target:
            axes = _mesh_axes(mesh, t)
            if axes:
                return axes
        return ()
    if target == "fsdp":
        return fsdp_axes(mesh)
    return (target,) if target in axis_names(mesh) else ()


def _axis_size(mesh, axes: Tuple[str, ...]) -> int:
    return math.prod(axis_size(mesh, a) for a in axes)


def spec_for(mesh, dims: Sequence[Optional[str]],
             shape: Optional[Sequence[int]] = None) -> Spec:
    """Resolve one tensor's logical dims to a partition spec.

    Dims are assigned in _PRIORITY order (not positional order) so fallback
    consumers like kv_seq only claim axes the primary consumers left free;
    a dim is dropped to replicated when its size doesn't divide the axis."""
    taken = set()
    out: list = [None] * len(dims)
    order = sorted(range(len(dims)),
                   key=lambda i: (_PRIORITY.get(dims[i], 5), i))
    for i in order:
        d = dims[i]
        candidates = RULES.get(d, []) if d is not None else []
        for target in candidates:
            axes = _mesh_axes(mesh, target)
            axes = tuple(a for a in axes if a not in taken)
            if not axes:
                continue
            if shape is not None and shape[i] % _axis_size(mesh, axes) != 0:
                # try the suffix (just "data" of ("pod","data")), else next
                if (len(axes) > 1
                        and shape[i] % _axis_size(mesh, axes[-1:]) == 0):
                    axes = axes[-1:]
                else:
                    continue
            taken.update(axes)
            out[i] = axes[0] if len(axes) == 1 else tuple(axes)
            break
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def placements(mesh, spec: Spec):
    """DTensor placements of a partition spec on ``mesh``: a tensor dim
    over one or more mesh axes is ``Shard(dim)`` on each of them (in mesh
    order, so ``("pod", "data")`` splits pod-major as the reference's
    spec does); every other mesh axis is ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    where = {}
    for d, entry in enumerate(spec):
        for a in ((entry,) if isinstance(entry, str) else entry or ()):
            where[a] = d
    return tuple(Shard(where[a]) if a in where else Replicate()
                 for a in axis_names(mesh))


_CURRENT_MESH = None


def set_mesh(mesh) -> None:
    """Install the mesh used by in-model activation sharding constraints
    and the mesh-only branches (context-parallel flash, expert-parallel
    MoE).  None disables them (single-device runs)."""
    global _CURRENT_MESH
    _CURRENT_MESH = mesh


def get_mesh():
    return _CURRENT_MESH


def _set_implicit(on: bool) -> bool:
    """Turn DTensor's implicit replication on or off for this thread;
    returns what it was."""
    from torch.distributed.tensor import DTensor
    d = DTensor._op_dispatcher
    was = bool(d._allow_implicit_replication)
    d._allow_implicit_replication = on
    return was


def under_mesh(fn):
    """Run ``fn`` with DTensor's implicit replication on while a mesh is
    set: a plain tensor that meets a DTensor (a mask, a position table, a
    scalar) is taken as replicated on every rank.  Reentrant; the flag is
    per thread, so a backward pass gets it from :func:`backward_under_mesh`."""
    import functools

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        if _CURRENT_MESH is None:
            return fn(*args, **kwargs)
        was = _set_implicit(True)
        try:
            return fn(*args, **kwargs)
        finally:
            _set_implicit(was)
    return wrapped


class _ImplicitInBackward(torch.autograd.Function):
    """Identity whose backward turns implicit replication on for the
    thread that runs the rest of the backward pass (autograd runs a CUDA
    graph's backward on a device thread of its own)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        _set_implicit(True)
        return g


def backward_under_mesh(loss):
    """``loss`` marked so that its backward pass, on whichever thread
    autograd runs it, takes plain tensors as replicated (see
    :func:`under_mesh`); as it is without a mesh."""
    if _CURRENT_MESH is None or not is_dtensor(loss):
        return loss
    return _ImplicitInBackward.apply(loss)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


class _Pin(torch.autograd.Function):
    """``x`` redistributed to ``want``, and its gradient to ``grad_want``:
    the counterpart of ``with_sharding_constraint``, which constrains the
    cotangent as well.  DTensor's own redistribution hands a ``Partial``
    input's gradient back replicated but leaves a gradient that arrives
    ``Partial`` as it is."""

    @staticmethod
    def forward(ctx, x, want, grad_want):
        ctx.grad_want = grad_want
        return x.redistribute(x.device_mesh, want) \
            if tuple(x.placements) != want else x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if is_dtensor(g) and tuple(g.placements) != ctx.grad_want:
            g = g.redistribute(g.device_mesh, ctx.grad_want)
        return g, None, None


def constrain(x, dims: Sequence[Optional[str]]):
    """Redistribute a DTensor to the layout of its logical dims, and its
    gradient in the backward; a no-op without a mesh or on a plain tensor.

    Keeping the residual stream pinned to (batch=data, ...) stops the
    sharding propagation from turning FSDP products into batch-replicated
    partial sums.  Pinning its gradient matters as much: a column-parallel
    product's input gradient is ``Partial`` over ``model``, and left so it
    reaches the previous row-parallel product, whose backward then gathers
    its weight whole and redoes the product on every ``model`` rank."""
    if _CURRENT_MESH is None or not is_dtensor(x):
        return x
    want = placements(x.device_mesh, spec_for(x.device_mesh, dims, x.shape))
    if tuple(x.placements) == want and not x.requires_grad:
        return x
    return _Pin.apply(x, want, want)


def relayout(x, want, grad_want):
    """DTensor ``x`` redistributed to placements ``want``, and its
    gradient to ``grad_want`` (:class:`_Pin`): where a gradient should
    stay ``Partial`` over an axis for a later reduce-scatter, not be
    all-reduced here as DTensor's own redistribution would."""
    return _Pin.apply(x, tuple(want), tuple(grad_want))


def whole_last_dim(x):
    """A DTensor's last dim gathered whole (over the mesh axes that shard
    it), its gradient cut back to the shards: for a column-parallel
    product's output that is then cut at boundaries the shards do not
    follow (Mamba2's in_proj into z, x, B, C, dt).  Left to DTensor, the
    backward gathers that gradient whole too, and the weight's gradient
    product runs at full width on every rank.  A no-op on a plain
    tensor."""
    if _CURRENT_MESH is None or not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard
    last = x.dim() - 1
    have = tuple(x.placements)
    want = tuple(Replicate() if isinstance(p, Shard) and p.dim == last
                 else p for p in have)
    if want == have:
        return x
    return _Pin.apply(x, want, have)


def _is_axes_leaf(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def _is_record(x) -> bool:
    """A NamedTuple node (the optimizer state) of an axes or spec tree."""
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_specs(mesh, axes_tree, shapes_tree=None):
    """axes tree (+ a matching tree of tensors or shapes) -> spec tree;
    nested dicts and NamedTuples (``opt_state_axes``)."""
    if _is_record(axes_tree):
        return type(axes_tree)(*(
            tree_specs(mesh, getattr(axes_tree, f), None if shapes_tree is None
                       else getattr(shapes_tree, f))
            for f in axes_tree._fields))
    if _is_axes_leaf(axes_tree):
        shape = None if shapes_tree is None else tuple(
            getattr(shapes_tree, "shape", shapes_tree))
        return spec_for(mesh, axes_tree, shape)
    return {k: tree_specs(mesh, v, None if shapes_tree is None
                          else shapes_tree[k])
            for k, v in axes_tree.items()}


def tree_shardings(mesh, axes_tree, shapes_tree=None):
    """axes tree (+ matching tensors or shapes) -> tree of placements."""
    specs = tree_specs(mesh, axes_tree, shapes_tree)

    def walk(s):
        if isinstance(s, dict):
            return {k: walk(v) for k, v in s.items()}
        if _is_record(s):
            return type(s)(*(walk(getattr(s, f)) for f in s._fields))
        return placements(mesh, s)
    return walk(specs)


def batch_spec(mesh) -> Spec:
    """tokens/targets: batch over (pod, data)."""
    fsdp = fsdp_axes(mesh)
    return (fsdp if len(fsdp) > 1 else (fsdp[0] if fsdp else None),)


def batch_sharding(mesh, ndim: int = 2):
    return placements(mesh, batch_spec(mesh))


def input_specs_for(mesh, specs: Dict[str, Any], cache_axes=None):
    """Partition specs for the ``input_specs()`` dict of one dry-run cell
    (the reference's ``input_shardings``, as specs)."""
    out: Dict[str, Any] = {}
    for name, v in specs.items():
        if name in ("tokens", "targets"):
            out[name] = spec_for(mesh, ("batch",) + (None,) * (v.dim() - 1),
                                 tuple(v.shape))
        elif name == "frontend":
            out[name] = spec_for(mesh, ("batch", None, None), tuple(v.shape))
        elif name == "cache":
            assert cache_axes is not None
            out[name] = tree_specs(mesh, cache_axes, v)
        else:
            raise KeyError(name)
    return out


def input_shardings(mesh, specs: Dict[str, Any], cache_axes=None):
    """Placements for the ``input_specs()`` dict of one dry-run cell."""
    def walk(s):
        if isinstance(s, dict):
            return {k: walk(v) for k, v in s.items()}
        return placements(mesh, s)
    return walk(input_specs_for(mesh, specs, cache_axes))


def distribute(t: torch.Tensor, mesh, spec: Spec):
    """``t`` (the whole tensor, the same on every rank) as a DTensor laid
    out by ``spec``: each rank keeps its own shard; no communication."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(t, mesh, placements(mesh, spec),
                             src_data_rank=None)


def tree_distribute(mesh, tree, axes_tree):
    """Every leaf of ``tree`` laid out by :func:`spec_for` of its logical
    axes and shape."""
    if isinstance(tree, dict):
        return {k: tree_distribute(mesh, v, axes_tree[k])
                for k, v in tree.items()}
    return distribute(tree, mesh, spec_for(mesh, axes_tree, tuple(tree.shape)))


def local_map(fn, out_placements, in_placements, in_grad_placements=None):
    """``fn`` over each rank's local shards of DTensor arguments (the
    counterpart of ``shard_map``): inputs redistributed to
    ``in_placements`` first, outputs wrapped as DTensors with
    ``out_placements``; differentiable.  An input that is replicated over
    a mesh axis but meets different data on each rank of it (a weight over
    batch-sharded tokens) takes :func:`partial_over` as its grad
    placements.  How a kernel is reached under a mesh: its wrapper reads
    ``data_ptr()``, so it must see local tensors."""
    from torch.distributed.tensor.experimental import local_map as _lm
    return _lm(fn, out_placements=out_placements,
               in_placements=in_placements,
               in_grad_placements=in_grad_placements,
               redistribute_inputs=True)


def partial_over(placements_, data_placements):
    """The grad placements of an input laid out as ``placements_`` whose
    every use meets data laid out as ``data_placements``: ``Partial()``
    (a sum over ranks) on each mesh axis the data is sharded over and the
    input is not."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    return [Partial() if isinstance(d, Shard) and isinstance(p, Replicate)
            else p for p, d in zip(placements_, data_placements)]


def layout(mesh, dims, t) -> list:
    """The placements of ``t`` by its logical dims (and shape)."""
    return list(placements(mesh, spec_for(mesh, dims, tuple(t.shape))))


def shard_index(mesh, placements_, dim: int):
    """(this rank's chunk index along tensor dim ``dim`` of a DTensor laid
    out as ``placements_``, the process groups of the mesh axes that
    shard that dim): the axes nest in mesh order, as DTensor's chunks
    do."""
    from torch.distributed.tensor import Shard
    idx, groups = 0, []
    for m, p in enumerate(placements_):
        if isinstance(p, Shard) and p.dim == dim:
            idx = idx * mesh.size(m) + mesh.get_local_rank(m)
            groups.append(mesh.get_group(m))
    return idx, groups


def all_reduce(t: torch.Tensor, op: str, groups) -> torch.Tensor:
    """``t`` reduced (``op``: "sum", "max", ...) over each process group of
    ``groups`` in turn: a local tensor inside a ``local_map``."""
    import torch.distributed._functional_collectives as funcol
    for g in groups:
        t = funcol.wait_tensor(funcol.all_reduce(t, op, g))
    return t


class _Gather(torch.autograd.Function):
    """A local shard's peers over process groups (the mesh axes that shard
    one of its dims, outermost first, as :func:`shard_index` gives them),
    stacked on a new leading dim in that chunk order: the innermost axis
    first, each one all-gather into a new tensor, no copy of the shard.
    Its gradient goes back to the shard the same way in reverse: summed
    over a group whose ranks met different data (``sums``: one
    reduce-scatter), else cut to the rank's chunk (every rank of it holds
    the same gradient)."""

    @staticmethod
    def forward(ctx, t, groups, ranks, sums):
        ctx.args = (groups, ranks, sums)
        f = torch.ops._c10d_functional
        out = t
        for g in reversed(groups):
            out = f.wait_tensor(f.all_gather_into_tensor(
                out.contiguous(), g.size(), g.group_name))
        return out.view(-1, *t.shape)

    @staticmethod
    def backward(ctx, g):
        groups, ranks, sums = ctx.args
        f = torch.ops._c10d_functional
        g = g.flatten(0, 1)
        for grp, r, s in zip(groups, ranks, sums):
            g = f.wait_tensor(f.reduce_scatter_tensor(
                g.contiguous(), "sum", grp.size(), grp.group_name)) if s \
                else g.chunk(grp.size())[r]
        return g, None, None, None


def gather_chunks(t: torch.Tensor, mesh, placements_, dim: int,
                  data_placements) -> torch.Tensor:
    """Inside a ``local_map``: every rank's chunk of tensor dim ``dim`` of a
    DTensor laid out as ``placements_``, gathered over just the mesh axes
    that shard that dim, as ``(n, *t.shape)``: chunk ``i`` of the dim at
    index ``i``, no copy (DTensor's redistribution re-lays each gather's
    result along ``dim`` by a copy, two of the whole live at once).  Its
    gradient is reduce-scattered back to the shard over
    each axis over which the data it meets (``data_placements``) is
    sharded, and cut to the shard over the others; so the input's grad
    placements are ``partial_over(placements_, data_placements)``."""
    from torch.distributed.tensor import Shard
    axes = [m for m, p in enumerate(placements_)
            if isinstance(p, Shard) and p.dim == dim]
    if not axes:
        return t[None]
    return _Gather.apply(
        t, [mesh.get_group(m) for m in axes],
        [mesh.get_local_rank(m) for m in axes],
        [isinstance(data_placements[m], Shard) for m in axes])


def add_in_place(x: torch.Tensor, o: torch.Tensor):
    """``x += o`` in x's own buffer, where no gradient is taken; None
    where the layouts do not allow it (the caller adds).  Under a mesh
    ``o`` may be a ``Partial`` sum over mesh axes where ``x`` is whole (a
    row-parallel product's output): it is all-reduced in place on its
    local tensor first, the one all-reduce of the stream's size that
    DTensor's ``x + o`` issues on a new tensor."""
    if x.shape != o.shape or x.dtype != o.dtype:
        return None
    if not is_dtensor(x) and not is_dtensor(o):
        return x.add_(o)
    if not (is_dtensor(x) and is_dtensor(o)) or \
            x.device_mesh != o.device_mesh:
        return None
    from torch.distributed.tensor import Partial
    reduce = []
    for m, (px, po) in enumerate(zip(x.placements, o.placements)):
        if po == px:
            continue
        if not (isinstance(po, Partial) and po.reduce_op == "sum"
                and px.is_replicate()):
            return None
        reduce.append(m)
    xl, ol = x.to_local(), o.to_local()
    if xl.shape != ol.shape:
        return None
    f = torch.ops._c10d_functional
    for m in reduce:
        group = x.device_mesh.get_group(m).group_name
        ol = f.wait_tensor(f.all_reduce_(ol, "sum", group))
    xl.add_(ol)
    return x


def fsdp_sharded(w) -> bool:
    """Whether DTensor ``w`` is still sharded over an FSDP axis (decode
    leaves a layer's matrices so: :func:`stationary_matmul`)."""
    if not is_dtensor(w):
        return False
    from torch.distributed.tensor import Shard
    fsdp = set(fsdp_axes(w.device_mesh))
    return any(isinstance(p, Shard) and n in fsdp
               for n, p in zip(axis_names(w.device_mesh), w.placements))


def stationary_matmul(x, w):
    """``x @ w`` (``w`` (K, N)) with ``w`` left where it lies: the
    activation moves, not the weight.  Each mesh axis that shards ``w``'s
    K takes the matching slice of ``x``'s last dim and sums its partial
    products (``Partial``); an axis that shards N splits the output; an
    axis over which ``w`` is whole splits whichever of N and K no other
    axis splits (a local slice of the weight, no communication), so every
    rank does its own share of the product and no rank redoes another's.
    ``x`` comes whole over its leading (batch) dims: one decode token a
    row, so the activations moved are small.  The result is laid out as
    the product after FSDP's gather would be: ``x``'s leading dims as they
    came, N sharded where ``w``'s N is over a non-FSDP axis, ``Partial``
    where its K is -- but where an FSDP axis gathers N whole (rows whole
    on every rank), each sum is taken first on the N shard and the result
    comes out whole.  No gradient: decode's products."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = w.device_mesh
    names, fsdp = axis_names(mesh), set(fsdp_axes(mesh))
    K, N = w.shape
    last = x.dim() - 1
    taken = {p.dim for p in w.placements if isinstance(p, Shard)}
    wpl, xpl, ypl = [], [], []
    for m, p in enumerate(w.placements):
        if not isinstance(p, Shard):
            if 1 not in taken and N % mesh.size(m) == 0:
                p = Shard(1)
            elif 0 not in taken and K % mesh.size(m) == 0:
                p = Shard(0)
            if isinstance(p, Shard):
                taken.add(p.dim)
        wpl.append(p)
        if isinstance(p, Shard) and p.dim == 0:
            xpl.append(Shard(last))
            ypl.append(Partial())
        elif isinstance(p, Shard):
            xpl.append(Replicate())
            ypl.append(Shard(last))
        else:
            xpl.append(Replicate())
            ypl.append(Replicate())
    y = local_map(lambda xs, ws: xs @ ws, ypl, (xpl, wpl))(x, w)
    want = []
    for n, p, xp in zip(names, w.placements, x.placements):
        if isinstance(xp, Shard) and xp.dim < last:
            want.append(xp)
        elif n in fsdp or not isinstance(p, Shard):
            want.append(Replicate())
        else:
            want.append(Shard(last) if p.dim == 1 else Partial())
    if any(isinstance(p, Shard) and p.dim == last and q.is_replicate()
           for p, q in zip(ypl, want)):
        # N is gathered whole (rows whole on every rank: a batch-1 decode
        # token): each sum over ranks is taken first, on the N shard, so
        # its all-reduce moves a shard of the row, not the whole row, and
        # the result comes out whole (the sum it stood for, taken)
        want = [Replicate() if isinstance(q, Partial) else q for q in want]
        y = y.redistribute(mesh, [
            Replicate() if isinstance(p, Partial) and q.is_replicate() else p
            for p, q in zip(ypl, want)])
    return y.redistribute(mesh, want)


def along_last(x, v):
    """``(x, v)`` laid out for an elementwise product of ``x`` with a
    vector ``v`` along its last dim.  Over a mesh axis that shards ``v``
    and over which ``x`` is whole (or has its last dim sharded as ``v``
    is), ``v`` is used where it lies and ``x`` cut to its slice (a local
    view: no communication); over an axis that shards ``x``'s rows
    (a batch over the FSDP axes), ``v`` is gathered whole.  A decode step
    at batch 1 thus applies each FSDP-sharded vector (a norm's scale,
    RWKV-6's ``mu``) on the rank's slice of the embed dim, the slice its
    next product (:func:`stationary_matmul`) takes anyway.  Plain tensors
    are returned as they are."""
    if not (is_dtensor(x) and is_dtensor(v)):
        return x, v
    xw, vw = along_last_placements(x, v)
    if xw != tuple(x.placements):
        x = x.redistribute(x.device_mesh, xw)
    if vw != tuple(v.placements):
        v = v.redistribute(v.device_mesh, vw)
    return x, v


def along_last_placements(x, v):
    """:func:`along_last`'s placements of DTensors ``x`` and ``v``."""
    from torch.distributed.tensor import Replicate, Shard
    last = x.dim() - 1
    xw, vw = [], []
    for px, pv in zip(x.placements, v.placements):
        cut = isinstance(pv, Shard) and (px.is_replicate() or (
            isinstance(px, Shard) and px.dim == last))
        xw.append(Shard(last) if cut else px)
        vw.append(Replicate() if isinstance(pv, Shard) and not cut else pv)
    return tuple(xw), tuple(vw)


def chunks(n: int, parts: int):
    """The ``[lo, hi)`` bounds of ``n`` items cut into ``parts`` chunks as
    ``torch.chunk`` and DTensor's ``Shard`` cut them (the last ones short
    or empty)."""
    size = -(-n // parts)
    return tuple((min(i * size, n), min((i + 1) * size, n))
                 for i in range(parts))


@functools.lru_cache(maxsize=None)
def exchange_plan(src, dst, rank: int):
    """How rank ``rank`` of a group realigns a vector's entries: ``src[i]``
    are the global indices rank ``i`` holds and ``dst[j]`` those rank
    ``j`` needs, in its order, each a tuple of ``[lo, hi)`` intervals.
    Each needed entry comes from the rank itself where it holds it, else
    from the lowest rank that does.  Returns (the positions in this rank's
    entries of what it sends, by destination; the counts it sends to each
    rank; the counts it receives from each; the positions in the received
    entries of what it needs, in order)."""
    def ids(iv):
        return [g for lo, hi in iv for g in range(lo, hi)]
    held = [set(ids(s)) for s in src]
    need = [ids(d) for d in dst]
    n = len(src)

    def owner(g, j):
        return j if g in held[j] else next(i for i in range(n)
                                           if g in held[i])
    mine = {g: k for k, g in enumerate(ids(src[rank]))}
    send, sent = [], []
    for j in range(n):
        piece = [g for g in need[j] if owner(g, j) == rank]
        send += [mine[g] for g in piece]
        sent.append(len(piece))
    got, counts = [], []
    for i in range(n):
        piece = [g for g in need[rank] if owner(g, rank) == i]
        got += piece
        counts.append(len(piece))
    at = {g: k for k, g in enumerate(got)}
    return tuple(send), tuple(sent), tuple(counts), tuple(at[g]
                                                         for g in need[rank])


_INDEX: Dict[Any, torch.Tensor] = {}


def _index(pos, device) -> torch.Tensor:
    """``pos`` as an index tensor on ``device``, made once a device."""
    key = (pos, str(device))
    if key not in _INDEX:
        _INDEX[key] = torch.tensor(pos, dtype=torch.long, device=device)
    return _INDEX[key]


def realign(t: torch.Tensor, plan, group) -> torch.Tensor:
    """A local tensor's last dim realigned across a process group by an
    :func:`exchange_plan`: one all-to-all of only the entries each rank
    lacks (and its own, which the exchange hands back), inside a
    ``local_map``.  ``group`` None: a group of one, no exchange."""
    send_pos, sent, counts, perm = plan
    rows = t.reshape(-1, t.shape[-1])
    send = rows.index_select(1, _index(send_pos, t.device)).t().contiguous()
    if group is None:
        got = send
    else:
        import torch.distributed._functional_collectives as funcol
        got = funcol.wait_tensor(funcol.all_to_all_single(
            send, list(counts), list(sent), group))
    out = got.index_select(0, _index(perm, t.device)).t()
    return out.reshape(*t.shape[:-1], len(perm))


def unshard(tree):
    """FSDP's gather at use: every DTensor leaf of ``tree`` redistributed
    to be whole over the FSDP axes (``pod``, ``data``), keeping its
    ``model`` sharding (tensor / expert parallelism); other leaves as they
    are.  Its backward is the reduce-scatter of the grads back to the
    shards.  The model calls it per layer (under remat, again in the
    backward), so one layer's weights are whole at a time."""
    if isinstance(tree, dict):
        return {k: unshard(v) for k, v in tree.items()}
    if not is_dtensor(tree):
        return tree
    from torch.distributed.tensor import Replicate
    mesh = tree.device_mesh
    fsdp = set(fsdp_axes(mesh))
    want = tuple(Replicate() if n in fsdp else p
                 for n, p in zip(axis_names(mesh), tree.placements))
    if want == tuple(tree.placements):
        return tree
    return tree.redistribute(mesh, want)


def replicated_like(t: torch.Tensor, ref):
    """``t`` (the same on every rank) as a replicated DTensor on ``ref``'s
    mesh when ``ref`` is a DTensor; else ``t`` as it is."""
    if not is_dtensor(ref):
        return t
    from torch.distributed.tensor import DTensor, Replicate
    mesh = ref.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def shared_range(t: torch.Tensor, src, lo: int, hi: int, rank: int,
                 group) -> torch.Tensor:
    """Entries ``[lo, hi)`` of a vector's last dim laid out over a group
    by ``src`` (rank ``i`` holds ``src[i]``, one ``[lo, hi)`` interval),
    on every rank: each piece broadcast from the first rank that holds it
    (inside a ``local_map``); taken locally where every rank holds them
    all (``group`` None: a group of one)."""
    a = src[rank][0]
    if group is None or all(s[0] <= lo and hi <= s[1] for s in src):
        return t[..., lo - a: hi - a]
    import torch.distributed._functional_collectives as funcol
    parts, at = [], lo
    while at < hi:
        o = next(i for i, s in enumerate(src) if s[0] <= at < s[1])
        end = min(hi, src[o][1])
        piece = (t[..., at - a: end - a].contiguous() if o == rank else
                 t.new_empty(t.shape[:-1] + (end - at,)))
        parts.append(funcol.wait_tensor(funcol.broadcast(piece, o, group)))
        at = end
    return torch.cat(parts, dim=-1) if len(parts) > 1 else parts[0]


def argmax_last(x):
    """``x.argmax(-1)``.  Where a DTensor's last dim is sharded (the vocab
    over ``model``), each rank takes the argmax of its own slice and the
    ranks that share the rows exchange (value, index) pairs, one of each a
    row: the best value wins, a NaN beating every number and the lower
    index breaking ties, as ``argmax`` of the whole row picks.  A greedy
    decode step moves two numbers a row, not (B, V) logits."""
    if not is_dtensor(x):
        return x.argmax(dim=-1)
    from torch.distributed.tensor import Replicate, Shard
    last = x.dim() - 1
    where = list(x.placements)
    if not any(isinstance(p, Shard) and p.dim == last for p in where):
        return x.argmax(dim=-1)
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    mesh = x.device_mesh
    _, groups = shard_index(mesh, where, last)
    first = compute_local_shape_and_global_offset(x.shape, mesh,
                                                  where)[1][last]
    out = [Replicate() if isinstance(p, Shard) and p.dim == last else p
           for p in where]

    def local(xl):
        import torch.distributed._functional_collectives as funcol
        i = xl.argmax(dim=-1)
        v = xl.gather(-1, i[..., None])[..., 0]
        i = i + first
        for g in groups:
            vs = funcol.wait_tensor(funcol.all_gather_tensor(v[None], 0, g))
            ids = funcol.wait_tensor(funcol.all_gather_tensor(i[None], 0, g))
            nan = vs.isnan()
            top = torch.where(nan, torch.full_like(vs, -math.inf),
                              vs).amax(0)
            anynan = nan.any(0)
            pick = torch.where(anynan, nan, vs == top)
            i = torch.where(pick, ids, torch.iinfo(ids.dtype).max).amin(0)
            v = torch.where(anynan, torch.full_like(top, math.nan), top)
        return i
    return local_map(local, out, (where,))(x)


def full(x):
    """A DTensor gathered whole on every rank; a plain tensor as it is."""
    return x.full_tensor() if is_dtensor(x) else x
