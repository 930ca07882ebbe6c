"""Collectives for ranks that share one card: gloo, with CUDA tensors.

NCCL refuses two ranks on one GPU, so a run of several ranks on one card
(``chip_smoke.py``'s ``dist`` phase) uses gloo.  Gloo runs some
collectives on CUDA tensors itself and crashes on others; the caller names
those, and :func:`stage_through_host` makes each of them work: it
registers, for CUDA tensors, a kernel of that functional collective
(``torch.ops._c10d_functional.<name>``, which DTensor's redistributions
and this package's own exchanges call) that copies the input to host
memory, runs gloo's host collective there, and copies the result back to
the card.  Only the collective's payload crosses
to the host; every rank's compute stays on the card.  Each staged call is
counted in :data:`staged` and its bytes in :data:`staged_bytes`.  This
module is the one place the port moves a collective's data through the
host, and it does so only for the collectives named to it.

Point-to-point transfers (:func:`exchange`: the pipeline's and the int8
ring's hops) stage the same way when ``"send_recv"`` is staged.

The backend is the caller's choice: a real multi-GPU machine uses NCCL
and stages nothing.  Nothing here runs at import time.
"""

from __future__ import annotations

import datetime
from collections import Counter
from typing import Iterable, Optional

import torch
import torch.distributed as dist

#: collectives routed through host memory for CUDA tensors, by name
STAGED: set = set()
#: staged calls and bytes of this process, by collective
staged: Counter = Counter()
staged_bytes: Counter = Counter()

# the functional collectives this module can stage, with how each runs on
# host copies: fn(op, host input, *args) -> host result
FUNCTIONAL = ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor",
              "all_to_all_single", "broadcast")

_libs = []


def _count(name: str, t: torch.Tensor) -> None:
    staged[name] += 1
    staged_bytes[name] += t.numel() * t.element_size()


def _host_kernel(name: str):
    op = getattr(torch.ops._c10d_functional, name).default
    wait = torch.ops._c10d_functional.wait_tensor.default

    def kernel(x, *args):
        _count(name, x)
        return wait(op(x.cpu(), *args)).to(x.device)
    return kernel


def stage_through_host(names: Iterable[str]) -> None:
    """Route the named collectives of CUDA tensors through host memory
    (module docstring).  Names from :data:`FUNCTIONAL` and ``"send_recv"``;
    once per process."""
    names = set(names) - STAGED
    unknown = names - set(FUNCTIONAL) - {"send_recv"}
    if unknown:
        raise ValueError(f"cannot stage {sorted(unknown)}")
    fn = names & set(FUNCTIONAL)
    if fn:
        lib = torch.library.Library("_c10d_functional", "IMPL")
        for name in sorted(fn):
            lib.impl(name, _host_kernel(name), "CUDA")
        _libs.append(lib)
    STAGED.update(names)


def exchange(out: torch.Tensor, dst: Optional[int], into: torch.Tensor,
             src: Optional[int], group=None) -> torch.Tensor:
    """Send ``out`` to global rank ``dst`` while receiving ``into`` from
    global rank ``src`` (either may be None), both in flight at once so a
    ring or a chain of ranks cannot deadlock; staged through host memory
    when ``send_recv`` is staged and the tensors are on the card.  Returns
    ``into``."""
    stage = "send_recv" in STAGED and out.device.type == "cuda"
    host_out = out.cpu() if stage and dst is not None else out
    host_in = (torch.empty(into.shape, dtype=into.dtype) if stage
               else into)
    works = []
    if dst is not None:
        works.append(dist.isend(host_out.contiguous(), dst, group=group))
        if stage:
            _count("send_recv", out)
    if src is not None:
        works.append(dist.irecv(host_in, src, group=group))
    for w in works:
        w.wait()
    if stage and src is not None:
        into.copy_(host_in)
    return into


def init(backend: str, rank: int, world: int, init_method: str,
         timeout_s: float = 300.0) -> None:
    """``init_process_group`` for one rank of a local run (``gloo`` or
    ``nccl``) at ``init_method`` (``file://...`` or
    ``tcp://localhost:<port>``)."""
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))


def spawn_ranks(fn, world: int, args: tuple = (), timeout_s: float = 300.0,
                init_dir: Optional[str] = None) -> None:
    """Run ``fn(rank, world, init_method, *args)`` in ``world`` processes
    of their own (``spawn``), each to call :func:`init` with the
    ``file://`` address given; wait at most ``timeout_s``.  A rank that
    raises, dies or outlives the limit fails the call: the others are
    killed and the error raised here."""
    import tempfile
    import time
    import torch.multiprocessing as mp
    tmp = init_dir or tempfile.mkdtemp(prefix="ranks_")
    ctx = mp.start_processes(fn, args=(world, f"file://{tmp}/init") + args,
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=2):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world} ranks past {timeout_s} s")
    except BaseException:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
        for p in ctx.processes:
            p.join(10)
        raise


__all__ = ["FUNCTIONAL", "STAGED", "exchange", "init", "spawn_ranks",
           "stage_through_host", "staged", "staged_bytes"]
