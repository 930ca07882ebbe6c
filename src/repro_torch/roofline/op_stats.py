"""Per-rank counts of a step's work, as it runs: the counterpart of the
reference's ``roofline/hlo_stats.py``.  There is no HLO to parse in eager
PyTorch, so :class:`OpStats` is a ``TorchDispatchMode`` that sees every op
one rank runs -- under DTensor, the local ops and the collectives that
DTensor's sharding propagation turns each global op into -- and records:

* FLOPs of every product (``torch.utils.flop_counter``'s formulas: mm,
  bmm, addmm, baddbmm, convolutions, attention), and of the port's kernels
  on the meta device (:func:`record_kernel`: the work of the kernel the
  card would run);
* bytes read and written at op granularity: each op's tensor inputs and
  outputs once.  This is EAGER traffic -- every elementwise op reads and
  writes device memory -- not XLA's fusion-level count, so it is an upper
  bound on what a fused program moves.  ``hbm_bytes`` leaves out pure data
  movement (copies, casts, views, concatenations), as the reference's
  ``hbm_bytes_semantic`` does; ``hbm_bytes_raw`` keeps it;
* each collective (``_c10d_functional`` all-reduce, all-gather,
  reduce-scatter, all-to-all, broadcast; DTensor's shard-dim all-to-all;
  ``c10d`` send / recv), with its group size and payload, through the ring
  formulas of ``roofline/analysis.py``;
* live bytes: the peak of the bytes held by tensors the step created
  (saved activations included), for the dry-run's ``temp_bytes``;
* FLOPs per product, keyed by the op and its input shapes (a kernel by
  its name and its inputs' shapes): :meth:`OpStats.top_products` says
  which products make a rank's FLOPs, the dry-run's ``top_products``;
* wire bytes per collective, keyed by its kind, payload shape and dtype,
  group size and the port's source line that issued it (forward, or the
  forward line whose backward issued it): :meth:`OpStats.top_collectives`
  says where a rank's collective bytes go, the dry-run's
  ``top_collectives``.

Python loops run their body once per trip, so a layer loop counts once
per layer by nature (the reference's analyzer had to multiply while-loop
bodies by their trip counts).
"""

from __future__ import annotations

import os
import sys
import weakref
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.roofline.analysis import CollectiveStats, ring_bytes

_ACTIVE: List["OpStats"] = []

# collective ops -> kind (payload: the full tensor the ring moves)
_FUNCOL = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "broadcast", "broadcast_": "broadcast",
    "shard_dim_alltoall": "all-to-all",
}
_C10D = {
    "allreduce_": "all-reduce", "allgather_": "all-gather",
    "_allgather_base_": "all-gather", "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter", "alltoall_base_": "all-to-all",
    "broadcast_": "broadcast", "send": "collective-permute",
}
# allocations: no traffic at all
_ALLOC = {"empty", "empty_strided", "empty_like", "new_empty",
          "new_empty_strided", "empty_permuted"}
# pure data movement: left out of the semantic byte count
_MOVEMENT = {"copy_", "_to_copy", "clone", "cat", "stack", "contiguous",
             "index_select", "_unsafe_view", "expand", "repeat",
             "constant_pad_nd", "slice_scatter", "select_scatter", "split",
             "split_with_sizes", "unbind", "zeros_like", "empty_like",
             "new_empty", "new_zeros", "fill_", "zero_", "empty", "zeros",
             "full", "arange", "lift_fresh", "detach"}


# a collective's source: the innermost frame in one of these packages of the
# port, but for the sharding helpers, so that a pin names its caller
_SOURCE_DIRS = tuple(os.sep + os.path.join("repro_torch", d) + os.sep
                     for d in ("models", "train", "parallel"))
_NOT_SOURCE = os.path.join("repro_torch", "parallel", "sharding.py")


def _port_path(filename: str) -> Optional[str]:
    """``filename`` as ``repro_torch/...`` when it can be a source."""
    if filename.endswith(_NOT_SOURCE) or not any(
            d in filename for d in _SOURCE_DIRS):
        return None
    return filename[filename.rindex(os.sep + "repro_torch" + os.sep) + 1:]


def _node_source(node) -> Optional[str]:
    """The innermost source frame of the forward stack anomaly mode
    recorded when autograd ``node`` was made."""
    stack = node.metadata.get("traceback_") or ()
    for entry in reversed(stack):
        line = entry.lstrip().split("\n", 1)[0]       # File "...", line N,
        if not line.startswith('File "'):
            continue
        filename, rest = line[6:].split('", line ', 1)
        path = _port_path(filename)
        if path is not None:
            return f"{path}:{rest.split(',', 1)[0]}"
    return None


def collective_source() -> Tuple[str, str]:
    """(the port's source line of the collective being issued, "forward"
    or "backward").  The innermost frame of the port on the live stack;
    in the backward pass, where the stack reaches the autograd engine
    first (a gradient op, a pin's backward), the line of the forward op
    whose gradient issues it, as anomaly mode recorded it; "unknown" when
    neither names a line of the port."""
    node = torch._C._current_autograd_node()
    f = sys._getframe(1)
    while f is not None and f.f_code.co_name != "_engine_run_backward":
        path = _port_path(f.f_code.co_filename)
        if path is not None:     # forward code (in the backward: remat's)
            return (f"{path}:{f.f_lineno}",
                    "forward" if node is None else "backward")
        f = f.f_back
    src = _node_source(node) if node is not None else None
    return src or "unknown", "forward" if node is None else "backward"


def _under_fake() -> bool:
    return torch._C._get_dispatch_mode(
        torch._C._TorchDispatchModeKey.FAKE) is not None


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for e in x:
            yield from _tensors(e)


@dataclass
class OpStats(TorchDispatchMode):
    """Enter it around one rank's step.  A product's FLOPs use the local
    shapes: a rank's own share of a sharded product."""
    flops: float = 0.0
    hbm_bytes: float = 0.0
    hbm_bytes_raw: float = 0.0
    coll: CollectiveStats = field(default_factory=CollectiveStats)
    collectives: List[Tuple[str, float, int]] = field(default_factory=list)
    kernels: Dict[str, int] = field(default_factory=dict)
    n_ops: int = 0
    live_bytes: int = 0
    peak_bytes: int = 0
    products: Dict[Tuple[str, Tuple], float] = field(default_factory=dict)
    by_source: Dict[Tuple, List[float]] = field(default_factory=dict)

    def __post_init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flop_registry = flop_registry

    def __enter__(self):
        _ACTIVE.append(self)
        self._hooks = torch.autograd.graph.saved_tensors_hooks(
            lambda t: t, lambda t: t)    # saved tensors keep their object
        self._hooks.__enter__()
        # every autograd node keeps its forward stack: a backward
        # collective's source (:func:`collective_source`)
        self._anomaly = torch.autograd.set_detect_anomaly(True,
                                                          check_nan=False)
        return super().__enter__()

    def __exit__(self, *exc):
        super().__exit__(*exc)
        self._anomaly.__exit__(*exc)
        self._hooks.__exit__(*exc)
        _ACTIVE.remove(self)

    # -- live bytes ----------------------------------------------------------
    def _track(self, t: torch.Tensor) -> None:
        n = _nbytes(t)
        if not n:
            return
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(t, self._release, n)

    def _release(self, n: int) -> None:
        self.live_bytes -= n

    # -- recording -----------------------------------------------------------
    def add_collective(self, kind: str, payload: float, n: int,
                       shape: Tuple = (), dtype=None,
                       source: Tuple[str, str] = ("unknown", "forward")
                       ) -> None:
        """One collective of ``payload`` bytes over ``n`` ranks; ``shape``
        and ``dtype`` its payload's, ``source`` (line, pass) where the port
        issued it (:func:`collective_source`)."""
        wire = ring_bytes(kind, payload, n)
        self.collectives.append((kind, float(payload), int(n)))
        self.coll.add(kind, wire)
        key = (kind, tuple(shape), str(dtype).replace("torch.", ""), int(n),
               *source)
        got = self.by_source.setdefault(key, [0, 0.0])
        got[0] += 1
        got[1] += wire

    def _tally(self, op: str, shapes: Tuple, flops: float) -> None:
        key = (op, shapes)
        self.products[key] = self.products.get(key, 0.0) + flops

    def add_kernel(self, name: str, flops: float, nbytes: float,
                   shapes: Tuple = ()) -> None:
        self.kernels[name] = self.kernels.get(name, 0) + 1
        self._tally(name, shapes, flops)
        self.flops += flops
        self.hbm_bytes += nbytes
        self.hbm_bytes_raw += nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            # let DTensor turn the global op into local ops and
            # collectives; this mode sees those next
            return NotImplemented
        out = func(*args, **kwargs)
        if _under_fake():
            # DTensor's sharding propagation runs each op once more on
            # global-shape fake tensors to learn the output's metadata:
            # no work of any rank
            return out
        self.n_ops += 1
        ns = func.namespace
        name = func._schema.name.split("::")[-1]
        ins = list(_tensors(args)) + list(_tensors(list(kwargs.values())))
        outs = list(_tensors(out))
        if ns in ("_c10d_functional", "_dtensor") and name in _FUNCOL:
            group = [a for a in args if isinstance(a, str)][-1]
            from torch.distributed.distributed_c10d import (
                _resolve_process_group)
            n = _resolve_process_group(group).size()
            kind = _FUNCOL[name]
            t = outs[0] if kind == "all-gather" else ins[0]
            self.add_collective(kind, _nbytes(t), n, t.shape, t.dtype,
                                collective_source())
            return out
        if ns == "c10d" and name in _C10D:
            pg = next((a for a in args if hasattr(a, "size")
                       and not isinstance(a, torch.Tensor)), None)
            n = pg.size() if pg is not None else 2
            kind = _C10D[name]
            self.add_collective(kind, sum(_nbytes(t) for t in ins), n,
                                ins[0].shape if ins else (),
                                ins[0].dtype if ins else None,
                                collective_source())
            return out
        if ns in ("_c10d_functional", "c10d"):
            return out                      # wait_tensor, recv, barrier
        flop_fn = self._flop_registry.get(func._overloadpacket)
        if flop_fn is not None:
            f = flop_fn(*args, **kwargs, out_val=out)
            self.flops += f
            self._tally(name, tuple(tuple(t.shape) for t in ins), f)
        views = any(r.alias_info is not None for r in func._schema.returns)
        if name in _ALLOC:
            for t in outs:
                self._track(t)
            return out
        if views and name not in ("copy_", "fill_", "zero_"):
            return out                      # a view or in-place: no traffic
        nbytes = sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        self.hbm_bytes_raw += nbytes
        if name not in _MOVEMENT:
            self.hbm_bytes += nbytes
        if not views:
            for t in outs:
                self._track(t)
        return out

    def top_products(self, n: int = 10) -> List[Dict]:
        """The ``n`` products (op, input shapes) with the most FLOPs, each
        with its FLOPs and its share of all of this rank's FLOPs."""
        top = sorted(self.products.items(), key=lambda kv: -kv[1])[:n]
        return [{"op": op, "shapes": [list(s) for s in shapes],
                 "flops": f, "share": f / self.flops if self.flops else 0.0}
                for (op, shapes), f in top]

    def top_collectives(self, n: Optional[int] = None) -> List[Dict]:
        """The collectives by (kind, payload shape and dtype, group size,
        source line, pass), the most wire bytes first (all of them, or
        the first ``n``): each with its count, its wire bytes and their
        share of all of this rank's collective bytes."""
        top = sorted(self.by_source.items(), key=lambda kv: -kv[1][1])
        total = self.coll.wire_bytes
        return [{"kind": kind, "shape": list(shape), "dtype": dtype,
                 "group": g, "source": src, "pass": pas, "count": c,
                 "bytes": b, "share": b / total if total else 0.0}
                for (kind, shape, dtype, g, src, pas), (c, b)
                in top[:n]]

    def as_dict(self) -> Dict:
        return {"flops": self.flops, "hbm_bytes": self.hbm_bytes,
                "hbm_bytes_raw": self.hbm_bytes_raw,
                "collective_bytes": self.coll.wire_bytes,
                "collective_by_kind": dict(self.coll.by_kind),
                "collective_count": self.coll.count,
                "kernels": dict(self.kernels), "peak_live_bytes":
                self.peak_bytes, "ops": self.n_ops}


def active() -> Optional[OpStats]:
    return _ACTIVE[-1] if _ACTIVE else None


class _MetaKernel(torch.autograd.Function):
    """A kernel's stand-in on the meta device: the output's shape, the
    kernel's work recorded forward, and the backward's (the plain version's
    VJP: its products, 2.5x the forward's operations, and the inputs, the
    output's gradient and the inputs' gradients moved once)."""

    @staticmethod
    def forward(ctx, name, shape, dtype, flops, nbytes, *inputs):
        ctx.name, ctx.flops, ctx.nbytes = name, flops, nbytes
        ctx.shapes = [(t.shape, t.dtype) for t in inputs]
        rec = active()
        if rec is not None:
            rec.add_kernel(name, flops, nbytes,
                           tuple(tuple(s) for s, _ in ctx.shapes))
        return torch.empty(shape, dtype=dtype, device="meta")

    @staticmethod
    def backward(ctx, g):
        rec = active()
        if rec is not None:
            rec.add_kernel(ctx.name + ".vjp", 2.5 * ctx.flops,
                           2 * ctx.nbytes,
                           tuple(tuple(s) for s, _ in ctx.shapes))
        return (None,) * 5 + tuple(
            torch.zeros(s, dtype=d, device="meta") for s, d in ctx.shapes)


def record_kernel(name: str, shape, dtype, flops: float, nbytes: float,
                  *inputs) -> torch.Tensor:
    """An empty meta tensor of ``shape`` standing for kernel ``name``'s
    output, with its work recorded in the active :class:`OpStats` (none:
    nothing recorded) and a backward that records its VJP's."""
    return _MetaKernel.apply(name, tuple(shape), dtype, float(flops),
                             float(nbytes), *inputs)
