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
  (saved activations, the outputs of collectives and the temporaries of
  the kernels' backward, the plain version's VJP, included), for the
  dry-run's ``temp_bytes``; and at that peak the live bytes by their
  source (the port's line that made each tensor, the pass, the dtype):
  :meth:`OpStats.top_live` says what holds a rank's memory, the dry-run's
  ``top_live``;
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

import contextlib
import functools
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


@functools.lru_cache(maxsize=None)
def _port_path(filename: str) -> Optional[str]:
    """``filename`` as ``repro_torch/...`` when it can be a source."""
    if filename.endswith(_NOT_SOURCE) or not any(
            d in filename for d in _SOURCE_DIRS):
        return None
    return filename[filename.rindex(os.sep + "repro_torch" + os.sep) + 1:]


def _node_source(node) -> Optional[str]:
    """The innermost source frame of the forward stack anomaly mode
    recorded when autograd ``node`` was made (kept in the node's metadata:
    a backward runs many ops under one node)."""
    meta = node.metadata
    if "op_stats_source" not in meta:
        meta["op_stats_source"] = _stack_source(meta.get("traceback_") or ())
    return meta["op_stats_source"]


def _stack_source(stack) -> Optional[str]:
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
    """(the port's source line of the op being run -- a collective, or a
    tensor the step holds -- "forward" or "backward").  The innermost
    frame of the port on the live stack; in the backward pass, where the
    stack reaches the autograd engine first (a gradient op, a pin's
    backward), the line of the forward op whose gradient issues it, as
    anomaly mode recorded it; "unknown" when neither names a line of the
    port."""
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


def _storage_key(t: torch.Tensor) -> Optional[int]:
    """The identity of ``t``'s storage (shared by its views), None where
    it has none."""
    try:
        return t.untyped_storage()._cdata
    except (RuntimeError, NotImplementedError):
        return None


@dataclass(eq=False)
class _Alloc:
    """The bytes one counted storage holds, under ``key`` (source, pass,
    dtype), live while any of its holders (tensors on it, or standing for
    it) is: ``holders`` counts them by the storage they lie on."""
    n: int
    key: Tuple
    collective: bool
    vjp: Optional["_VJPPeak"]
    holders: Dict[Optional[int], int] = field(default_factory=dict)


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
    live_collective_bytes: int = 0   # of live_bytes: outputs of collectives
    _peak_collective: int = 0        # :attr:`peak_collective_bytes`
    products: Dict[Tuple[str, Tuple], float] = field(default_factory=dict)
    by_source: Dict[Tuple, List[float]] = field(default_factory=dict)
    live_by_source: Dict[Tuple, int] = field(default_factory=dict)
    peak_by_source: Dict[Tuple, int] = field(default_factory=dict)
    _at_peak: bool = False       # live bytes are at a new peak not yet kept
    # count live bytes alone, under this source (:meth:`plain_vjp`)
    _live_only: Optional[Tuple[str, str]] = None
    _vjp: Optional["_VJPPeak"] = None   # the plain VJP being measured
    # the counted storages' allocations, by storage (:func:`_storage_key`)
    _allocs: Dict[int, "_Alloc"] = field(default_factory=dict)

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
    def _track(self, t: torch.Tensor, source: Tuple[str, str],
               collective: bool = False) -> None:
        """Count ``t`` live until it is freed, under (``source``, its
        dtype); ``collective``: ``t`` is a collective's output.  A tensor
        on the storage of one already counted (``_unsafe_view``'s output
        on ``mm``'s) adds no bytes: it holds that storage live too
        (:meth:`_hold`)."""
        n = _nbytes(t)
        if not n:
            return
        sk = _storage_key(t)
        if sk in self._allocs:
            self._hold(t, self._allocs[sk], sk)
            return
        key = (*source, str(t.dtype).replace("torch.", ""))
        self.live_bytes += n
        self.live_collective_bytes += n if collective else 0
        self.live_by_source[key] = self.live_by_source.get(key, 0) + n
        if self.live_bytes > self.peak_bytes:
            self.peak_bytes = self.live_bytes
            self._at_peak = True
        if self._vjp is not None:
            self._vjp.add(n, key[2])
        self._hold(t, _Alloc(n, key, collective, self._vjp), sk)

    def _hold(self, t: torch.Tensor, alloc: "_Alloc",
              sk: Optional[int]) -> None:
        """``t`` holds ``alloc``'s bytes live (on storage ``sk``) until it
        is freed; the bytes are released when its last holder is."""
        alloc.holders[sk] = alloc.holders.get(sk, 0) + 1
        if sk is not None:
            self._allocs[sk] = alloc
        weakref.finalize(t, self._drop, alloc, sk)

    def _alias(self, out: torch.Tensor) -> bool:
        """Whether ``out`` lies on the storage of a counted tensor (a
        view, an in-place op's result), and then holds it."""
        sk = _storage_key(out)
        if sk not in self._allocs:
            return False
        self._hold(out, self._allocs[sk], sk)
        return True

    def _drop(self, alloc: "_Alloc", sk: Optional[int]) -> None:
        """A holder on storage ``sk`` is freed.  When it was that
        storage's last, the storage is freed and its key goes, even where
        the bytes live on through a holder on another storage (a
        collective's wrapper): a new storage at the same address is not
        this one."""
        alloc.holders[sk] -= 1
        if alloc.holders[sk]:
            return
        del alloc.holders[sk]
        if sk is not None and self._allocs.get(sk) is alloc:
            del self._allocs[sk]
        if not alloc.holders:
            self._release(alloc.n, alloc.key, alloc.collective, alloc.vjp)

    def _release(self, n: int, key: Tuple, collective: bool,
                 vjp: Optional["_VJPPeak"]) -> None:
        self._keep_peak()
        self.live_bytes -= n
        self.live_collective_bytes -= n if collective else 0
        self.live_by_source[key] -= n
        if vjp is not None:
            vjp.add(-n, key[2])

    def made_bytes(self, tensors) -> int:
        """The bytes of those of ``tensors`` (a step's outputs) that lie
        on storages the step allocated: among its live bytes already."""
        return sum(_nbytes(t) for t in tensors
                   if _storage_key(t) in self._allocs)

    @property
    def peak_collective_bytes(self) -> int:
        """Of :attr:`peak_bytes`, the bytes of collectives' outputs."""
        self._keep_peak()
        return self._peak_collective

    def _keep_peak(self) -> None:
        """Keep the live bytes by source (and the collectives' share) as
        they are, if this is the peak and the first release after it is
        about to leave it."""
        if self._at_peak:
            self.peak_by_source = {k: v for k, v in
                                   self.live_by_source.items() if v}
            self._peak_collective = self.live_collective_bytes
            self._at_peak = False

    @contextlib.contextmanager
    def _live_only_under(self, source: Tuple[str, str]):
        """Within it ops count their live bytes under ``source`` and
        nothing else (no forward stacks kept: their nodes are not the
        step's)."""
        was, self._live_only = self._live_only, source
        try:
            with torch.autograd.set_detect_anomaly(False):
                yield
        finally:
            self._live_only = was

    def plain_vjp(self, key, fn, ins, need, g) -> List:
        """The grads of ``fn(*ins)`` against ``g`` (for each input that
        ``need`` marks; None for the others) on meta, as a kernel's stand-in
        computes its backward: the temporaries of the plain VJP the card's
        backward runs count among the live bytes, under the stand-in's
        source; their work is the stand-in's own record.  The first call
        for ``key`` (the kernel, its arguments and its inputs' shapes) runs
        the VJP and keeps the peak of its live bytes by dtype; a later one
        holds that peak for a moment (every layer of a model runs the same
        shapes, and the VJP on meta costs seconds)."""
        with self._live_only_under(collective_source()):
            peak = _VJP_PEAKS.get(key)
            if peak is not None:
                held = [torch.empty(n // getattr(torch, d).itemsize,
                                    dtype=getattr(torch, d), device="meta")
                        for d, n in peak.items()]
                del held
                return [torch.zeros_like(t) if n else None
                        for t, n in zip(ins, need)]
            xs = [None if t is None else t.detach().requires_grad_(n)
                  for t, n in zip(ins, need)]
            self._vjp = measured = _VJPPeak()
            try:
                with torch.enable_grad():
                    out = fn(*xs)
                    got = iter(torch.autograd.grad(
                        out, [x for x in xs if x is not None
                              and x.requires_grad], g))
                grads = [next(got) if x is not None and x.requires_grad
                         else None for x in xs]
            finally:
                self._vjp = None
            _VJP_PEAKS[key] = measured.at_peak
            return grads

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
        if self._live_only is not None:
            views = any(r.alias_info is not None
                        for r in func._schema.returns)
            for t in _tensors(out):
                if views:
                    self._alias(t)
                else:
                    self._track(t, self._live_only)
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
            source = collective_source()
            self.add_collective(kind, _nbytes(t), n, t.shape, t.dtype,
                                source)
            if not name.endswith("_"):
                # a new tensor the step holds (no traffic of its own:
                # the wire bytes above are the collective's cost)
                for o in outs:
                    self._track(o, source, collective=True)
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
            # wait_tensor, recv, barrier; and the wrapper a collective's
            # output is handed back in (``_wrap_tensor_autograd``: on
            # meta a new tensor, on the card the same buffer), which holds
            # that output's bytes in its stead
            held = self._allocs.get(_storage_key(ins[0])) if ins else None
            for o in outs:
                if not self._alias(o) and held is not None:
                    self._hold(o, held, _storage_key(o))
            return out
        flop_fn = self._flop_registry.get(func._overloadpacket)
        if flop_fn is not None:
            f = flop_fn(*args, **kwargs, out_val=out)
            self.flops += f
            self._tally(name, tuple(tuple(t.shape) for t in ins), f)
        views = any(r.alias_info is not None for r in func._schema.returns)
        if name in _ALLOC:
            source = collective_source()
            for t in outs:
                self._track(t, source)
            return out
        if views:
            for t in outs:              # a view holds its base's storage
                self._alias(t)
            if name not in ("copy_", "fill_", "zero_"):
                return out                  # a view or in-place: no traffic
        nbytes = sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        self.hbm_bytes_raw += nbytes
        if name not in _MOVEMENT:
            self.hbm_bytes += nbytes
        if not views and outs:
            source = collective_source()
            for t in outs:
                self._track(t, source)
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

    def top_live(self, n: Optional[int] = None) -> List[Dict]:
        """The live bytes at this rank's peak by (source line, pass,
        dtype), the most first (all of them, or the first ``n``): each with
        its bytes and their share of the peak."""
        self._keep_peak()
        top = sorted(self.peak_by_source.items(), key=lambda kv: -kv[1])
        return [{"source": src, "pass": pas, "dtype": dtype, "bytes": b,
                 "share": b / self.peak_bytes if self.peak_bytes else 0.0}
                for (src, pas, dtype), b in top[:n]]

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


class _VJPPeak:
    """The live bytes by dtype at the peak of the tensors one plain VJP
    makes (:meth:`OpStats.plain_vjp`)."""

    def __init__(self):
        self.live: Dict[str, int] = {}
        self.total = 0
        self.peak = 0
        self.at_peak: Dict[str, int] = {}

    def add(self, n: int, dtype: str) -> None:
        self.live[dtype] = self.live.get(dtype, 0) + n
        self.total += n
        if self.total > self.peak:
            self.peak, self.at_peak = self.total, {
                d: v for d, v in self.live.items() if v}


# (kernel, its arguments, input shapes, dtypes, grads needed) -> the peak
# of its plain VJP's live bytes by dtype
_VJP_PEAKS: Dict[Tuple, Dict[str, int]] = {}


class _MetaKernel(torch.autograd.Function):
    """A kernel's stand-in on the meta device: the output's shape, the
    kernel's work recorded forward, and the backward's (the plain version's
    VJP: its products, 2.5x the forward's operations, and the inputs, the
    output's gradient and the inputs' gradients moved once).  It keeps its
    inputs for the backward, as the kernel's ``autograd.Function`` does,
    and with ``plain`` its backward recomputes ``plain(*inputs)`` and takes
    its VJP on meta, as the card's backward does, so that the VJP's
    temporaries count among the live bytes (:meth:`OpStats.plain_vjp`:
    their work is the one recorded above)."""

    @staticmethod
    def forward(ctx, name, shape, dtype, flops, nbytes, plain, *inputs):
        ctx.name, ctx.flops, ctx.nbytes, ctx.plain = name, flops, nbytes, plain
        ctx.shapes = tuple(tuple(t.shape) for t in inputs if t is not None)
        ctx.dtypes = tuple(t.dtype for t in inputs if t is not None)
        ctx.save_for_backward(*inputs)
        rec = active()
        if rec is not None:
            rec.add_kernel(name, flops, nbytes, ctx.shapes)
        return torch.empty(shape, dtype=dtype, device="meta")

    @staticmethod
    def backward(ctx, g):
        rec = active()
        ins = ctx.saved_tensors
        need = ctx.needs_input_grad[6:]
        if rec is not None:
            rec.add_kernel(ctx.name + ".vjp", 2.5 * ctx.flops,
                           2 * ctx.nbytes, ctx.shapes)
        if ctx.plain is None or rec is None:
            grads = [torch.zeros_like(t) if n else None
                     for t, n in zip(ins, need)]
        else:
            fn, args = ctx.plain
            grads = rec.plain_vjp((ctx.name, args, ctx.shapes, ctx.dtypes,
                                   need), fn, ins, need, g)
        return (None,) * 6 + tuple(grads)


def record_kernel(name: str, shape, dtype, flops: float, nbytes: float,
                  *inputs, plain=None) -> torch.Tensor:
    """An empty meta tensor of ``shape`` standing for kernel ``name``'s
    output, with its work recorded in the active :class:`OpStats` (none:
    nothing recorded) and a backward that records its VJP's.  ``plain`` is
    the plain version whose VJP the kernel's backward takes: (a function of
    ``inputs``, None allowed among them; the hashable arguments it closes
    over)."""
    return _MetaKernel.apply(name, tuple(shape), dtype, float(flops),
                             float(nbytes), plain, *inputs)
