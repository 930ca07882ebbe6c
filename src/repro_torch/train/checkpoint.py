"""Checkpoints with async writes and reservation-based buffer reuse -- the
training-side use of the paper's pattern, as in the reference's
``train/checkpoint.py``: the async writer *reserves* the snapshot buffers
(a ``threading.Event`` it holds while writing); the trainer is the
*reclaimer* that would reuse them, and pings (waits on the reservation,
:meth:`CheckpointManager.wait`, counted in ``async_waits``) only when it
needs them back -- before the next save, and at the end of a run.

The on-disk format is the reference's, so either package restores the
other's checkpoints: a directory ``step_{step:08d}`` holding
``leaves.npz`` (one array per leaf; bf16 widened to f32, since npz has no
bf16) and ``manifest.json`` (step, sorted keys, ``extra`` such as the
data pipeline's step, wall time).  Writes go to ``.tmp-{step}``, renamed
atomically; ``keep`` bounds how many stay.  Keys are the reference's
``jax.tree_util`` paths: dict keys joined by ``/``, and the fields of an
:class:`~repro_torch.optim.adamw.AdamWState` printed as the reference
prints a NamedTuple's (``opt/.step``, ``opt/.m/<path>``,
``opt/.v/<path>``).

The snapshot -- every tensor copied to host numpy -- is taken
synchronously in :meth:`CheckpointManager.save`, before the writer thread
starts, so the trainer may update its CUDA tensors in place right after.
Restore rounds each leaf to its template's dtype (f32 -> bf16 round to
nearest even, as numpy's ml_dtypes cast in the reference) and places it on
the template's device; the stored leaves are whole, so a restore does not
depend on where the saving run ran.

A sharded state (DTensor leaves on a ``DeviceMesh``) is saved whole, as
the reference's ``np.asarray`` gathers a sharded ``jax.Array``: each
DTensor leaf's ``full_tensor()`` -- a collective, so every rank of the
mesh enters :meth:`CheckpointManager.save` at the same step -- is taken
in the synchronous snapshot, never on the writer thread.  Rank 0 alone
writes the directory; every rank waits at a barrier (at the end of a
synchronous save, in :meth:`CheckpointManager.wait` after an async one)
before :meth:`CheckpointManager.latest_step` may look for it.  Restore is
elastic, as the reference's: ``shardings`` (placements per leaf, e.g.
``parallel.sharding.tree_shardings``) lays each whole leaf out on
``mesh``, whatever mesh saved it; without them a leaf lands as its
template leaf, a DTensor template leaf on its own mesh and placements.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.optim.adamw import AdamWState, tree_unflatten
from repro_torch.parallel.sharding import full, is_dtensor


def _to_numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = full(v.detach())            # a DTensor gathered whole
        if v.dtype == torch.bfloat16:   # npz has no bf16: widen to f32
            v = v.float()
        return v.cpu().numpy()
    a = np.asarray(v)
    if a.dtype.name == "bfloat16":
        a = a.astype(np.float32)
    return a


def flatten_with_paths(tree, prefix: Tuple[str, ...] = ()
                        ) -> List[Tuple[str, Any]]:
    """``[(key, leaf)]`` in the reference's flatten order: dict keys
    sorted, a NamedTuple's fields in order as ``.<field>``."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in flatten_with_paths(tree[k], prefix + (str(k),))]
    if isinstance(tree, AdamWState):
        return [kv for f in tree._fields
                for kv in flatten_with_paths(getattr(tree, f),
                                              prefix + (f".{f}",))]
    return [("/".join(prefix), tree)]


def _like(arr: np.ndarray, tmpl, mesh=None, placements=None):
    """``arr`` as the template leaf: its dtype and device, and for a
    DTensor template its mesh and placements -- or ``placements`` on
    ``mesh`` where given."""
    if isinstance(tmpl, torch.Tensor):
        t = torch.from_numpy(np.array(arr, order="C"))    # keeps 0-d
        t = t.to(device=tmpl.device, dtype=tmpl.dtype)
        if placements is None and is_dtensor(tmpl):
            mesh, placements = tmpl.device_mesh, tmpl.placements
        if placements is None:
            return t
        from torch.distributed.tensor import distribute_tensor
        return distribute_tensor(t, mesh, tuple(placements),
                                 src_data_rank=None)
    if hasattr(tmpl, "dtype"):
        return arr.astype(tmpl.dtype)
    return arr


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._writer: Optional[threading.Thread] = None
        self._reserved = threading.Event()   # writer holds the snapshot
        self._reserved.set()                 # vacuous: nothing reserved
        self._barrier = False                # a sharded save not yet seen
        self.async_waits = 0

    # ------------------------------------------------------------------

    def save(self, step: int, state: Dict[str, Any], *,
             extra: Optional[Dict] = None, async_: bool = False) -> None:
        """Snapshot (device -> host copy, DTensor leaves gathered whole)
        happens synchronously; serialisation happens on the writer thread
        when ``async_``.  With DTensor leaves every rank of the mesh must
        call this at the same step, and only rank 0 writes."""
        leaves = flatten_with_paths(state)
        sharded = any(is_dtensor(v) for _, v in leaves)
        snapshot = {k: _to_numpy(v) for k, v in leaves}
        meta = {"step": step, "keys": sorted(snapshot), "extra": extra or {},
                "time": time.time()}
        writes = not sharded or dist.get_rank() == 0

        if async_:
            self.wait()                       # one in-flight write at a time
            self._barrier = sharded
            if writes:
                self._reserved.clear()        # writer reserves the snapshot

                def _write():
                    try:
                        self._write_dir(step, snapshot, meta)
                    finally:
                        self._reserved.set()  # publish: buffers reusable

                self._writer = threading.Thread(target=_write, daemon=True)
                self._writer.start()
        else:
            if writes:
                self._write_dir(step, snapshot, meta)
            self._barrier = self._barrier or sharded
            self._sync_ranks()

    def wait(self) -> None:
        """Trainer-side 'ping': block until the writer releases its
        reservation (only called when the trainer needs the buffers).
        After a sharded save every rank waits here for rank 0's write."""
        self._join()
        self._sync_ranks()

    def _join(self) -> None:
        if not self._reserved.is_set():
            self.async_waits += 1
        self._reserved.wait()
        if self._writer:
            self._writer.join()
            self._writer = None

    def _sync_ranks(self) -> None:
        """The barrier after a sharded save, on the caller's thread (the
        writer thread runs no collective)."""
        if self._barrier:
            self._barrier = False
            dist.barrier()

    def _write_dir(self, step: int, snapshot: Dict[str, np.ndarray],
                   meta: Dict) -> None:
        tmp = self.dir / f".tmp-{step}"
        final = self.dir / f"step_{step:08d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        np.savez(tmp / "leaves.npz", **snapshot)
        (tmp / "manifest.json").write_text(json.dumps(meta))
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)
        self._gc()

    def _gc(self) -> None:
        ckpts = sorted(self.dir.glob("step_*"))
        for old in ckpts[: -self.keep]:
            shutil.rmtree(old, ignore_errors=True)

    # ------------------------------------------------------------------

    def latest_step(self) -> Optional[int]:
        ckpts = sorted(self.dir.glob("step_*"))
        if not ckpts:
            return None
        return int(ckpts[-1].name.split("_")[1])

    def restore(self, template: Dict[str, Any], step: Optional[int] = None,
                shardings=None, mesh=None):
        """``(state, manifest)``: the checkpoint in ``template``'s tree,
        each leaf in its template's dtype and on its device.  With
        ``shardings`` (a tree like ``template``'s of placements, e.g.
        ``parallel.sharding.tree_shardings``) each whole leaf is laid out
        on ``mesh`` -- elastic by construction."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        place: Dict[str, Any] = {}
        if shardings is not None:
            if mesh is None:
                raise ValueError("restore(shardings=) needs a mesh")
            place = dict(flatten_with_paths(shardings))
        d = self.dir / f"step_{step:08d}"
        meta = json.loads((d / "manifest.json").read_text())
        with np.load(d / "leaves.npz") as data:
            leaves = [_like(data[key], tmpl, mesh,
                            place[key] if place else None)
                      for key, tmpl in flatten_with_paths(template)]
        return tree_unflatten(template, iter(leaves)), meta

    def __del__(self):
        try:
            self._join()        # no barrier: the other ranks are not here
        except Exception:
            pass
