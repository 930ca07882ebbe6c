"""Multi-pod dry-run: run every (arch x shape x mesh) cell's step on the
production mesh with no devices and no data, and record its memory, FLOPs,
bytes and collectives per rank for the roofline.

Each cell runs in this process as one rank of a ``fake`` process group of
256 ranks (512 with ``--multi-pod``): parameters, optimizer state and
inputs are ``meta`` DTensors laid out by ``parallel/sharding.py``'s
``spec_for``, and the step -- train (loss, backward, AdamW), prefill or
decode -- runs under ``roofline/op_stats.py``'s counter, which sees the
local ops and collectives DTensor turns the step into.  The kernels count
their own work on ``meta`` (``kernels/ops.py``).  The roofline's peaks are
the H100's data-sheet figures (``roofline/analysis.py``): bounds, not
measurements.

Rank 0 and the rank at the last ``model`` position (data 0, pod 0) can
count different work: under causal context parallelism the later
sequence slice scores more pairs.  Where a cell has such a layer
(:func:`ranks_differ`), it runs as both ranks, and the roofline and the
memory take the larger of each count; the JSON keeps both ranks' counts
(``ranks``).  Elsewhere every ``model`` rank has the same shapes and rank
0 alone runs.  ``top_products`` are the busier rank's by FLOPs,
``top_collectives`` (the collectives by kind, payload, group and the
port's source line, each with its share of the rank's collective bytes)
the busier rank's by collective bytes, and ``top_live`` (the live bytes
at the peak by the port's source line, pass and dtype, each with its
share of the peak; the outputs of collectives are live bytes too) the
rank's with the larger peak; each rank's own is under ``ranks``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2_27b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes --out results/dryrun_torch

A CPU process group makes DTensor fall back from all-to-all to all-gather
plus a local chunk; the dry-run models a mesh of GPUs, whose process group
does all-to-all, so it keeps DTensor's all-to-all (``_alltoall_kept``) and
counts it as one.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist

from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import (ARCHS, cell_supported, get_config,
                                          input_specs)
from repro_torch.launch.mesh import (PRODUCTION, make_production_mesh,
                                     production_shape)
from repro_torch.models.attention import head_layout
from repro_torch.models.model import (abstract_params, cache_axes,
                                      params_logical_axes)
from repro_torch.optim.adamw import adamw_init, tree_leaves
from repro_torch.parallel import sharding as sh
from repro_torch.roofline import analysis as roof
from repro_torch.roofline.op_stats import OpStats
from repro_torch.train.train_step import (make_prefill_step, make_serve_step,
                                          make_train_step)


@contextlib.contextmanager
def fake_world(n: int, rank: int = 0):
    """This process as ``rank`` of a ``fake`` process group of ``n`` ranks
    (no other process, no communication)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()
        _forget_meshes()


def _forget_meshes() -> None:
    """Clear DTensor's caches of sharding decisions (the C++ dispatch's,
    where the build has one, and the propagator's).  They are keyed by
    the ops' specs, and a mesh's equality ignores the rank: the next
    world's ops would get back specs holding this world's mesh, whose
    process groups are gone."""
    from torch.distributed.tensor import DTensor
    native = getattr(torch._C, "_clear_DTensor_sharding_propagator_cache",
                     None)
    if native is not None:
        native()
    prop = DTensor._op_dispatcher.sharding_propagator
    for cached in (prop.propagate_op_sharding,
                   getattr(prop, "_propagate_tensor_meta_cached", None)):
        if hasattr(cached, "cache_clear"):
            cached.cache_clear()


@contextlib.contextmanager
def _alltoall_kept():
    """DTensor's shard-dim all-to-all as the op itself, never the CPU
    process group's all-gather + chunk fallback (module docstring)."""
    from torch.distributed.tensor import _collective_utils as cu
    from torch.distributed.tensor import placement_types as pt

    def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        return torch.ops._dtensor.shard_dim_alltoall(
            input, gather_dim, shard_dim,
            cu.funcol._resolve_group_name((mesh, mesh_dim)))

    was = pt.shard_dim_alltoall
    pt.shard_dim_alltoall = alltoall
    try:
        yield
    finally:
        pt.shard_dim_alltoall = was


def _local_bytes(tree) -> int:
    return sum(t.to_local().nbytes if sh.is_dtensor(t) else t.nbytes
               for t in tree_leaves(tree) if isinstance(t, torch.Tensor))


def _tree(x):
    """A step's output as a tree of dicts (tuples and NamedTuples too)."""
    if isinstance(x, dict):
        return {k: _tree(v) for k, v in x.items()}
    if isinstance(x, tuple):
        return {str(i): _tree(v) for i, v in enumerate(x)}
    return x


def run_step(cfg, shape, mesh):
    """One cell's step on ``mesh`` under :class:`OpStats`; returns
    (stats, argument bytes, output bytes, alias bytes, the bytes of the
    outputs but the aliased ones that the step allocated: counted among
    its live bytes too)."""
    p_dt = sh.tree_distribute(mesh, abstract_params(cfg),
                              params_logical_axes(cfg))
    specs = input_specs(cfg, shape)
    batch = {}
    for name in ("tokens", "targets", "frontend"):
        if name in specs:
            batch[name] = sh.distribute(
                specs[name], mesh, sh.spec_for(
                    mesh, ("batch",) + (None,) * (specs[name].dim() - 1),
                    tuple(specs[name].shape)))
    args = {"params": p_dt, "batch": batch}
    st = OpStats()
    if shape.kind == "train":
        opt = adamw_init(p_dt)
        args["opt"] = opt
        arg_bytes = _local_bytes(_tree(args))
        with st:
            p_dt, opt, metrics = make_train_step(cfg)(p_dt, opt, batch)
        alias = _local_bytes(p_dt) + _local_bytes(_tree(opt))
        out_bytes = alias + _local_bytes(metrics)
        out = metrics
    elif shape.kind == "prefill":
        arg_bytes = _local_bytes(args)
        with st:
            out = make_prefill_step(cfg)(p_dt, batch["tokens"],
                                         batch.get("frontend"))
        out_bytes, alias = _local_bytes(_tree(out)), 0
    else:
        cache = sh.tree_distribute(mesh, specs["cache"], cache_axes(cfg))
        args["cache"] = cache
        arg_bytes = _local_bytes(args)
        with st:
            tok, cache = make_serve_step(cfg)(p_dt, cache, batch["tokens"])
        alias = _local_bytes(cache)
        out_bytes = alias + _local_bytes(tok)
        out = tok
    made = st.made_bytes(t.to_local() if sh.is_dtensor(t) else t
                         for t in tree_leaves(_tree(out))
                         if isinstance(t, torch.Tensor))
    return st, arg_bytes, out_bytes, alias, made


def last_model_rank(multi_pod: bool = False) -> int:
    """The rank at the last ``model`` position of the production mesh
    (data 0, pod 0): its axes are row-major, ``model`` last."""
    return PRODUCTION[multi_pod][0][-1] - 1


def ranks_differ(cfg, shape, mesh) -> bool:
    """Whether the last ``model`` position counts other work than rank 0:
    only where a train or prefill step runs a causal self-attention whose
    heads ``model`` does not divide (the ``"seq"`` layout, context
    parallelism: each slice scores the pairs up to its own positions).
    Every other layout gives each ``model`` rank the same shapes, but for
    the exchanges of Mamba2's decode by heads, where rank 0 sends the
    most (``models/ssm.py::_mamba2_decode_sharded``)."""
    if shape.kind == "decode" or "model" not in sh.axis_names(mesh):
        return False
    causal = cfg.mtp and shape.kind == "train" or any(
        ls.shared_attn or (ls.mixer == "attn" and ls.attn_kind != "cross"
                           and ls.causal)
        for g in cfg.groups for ls in g.pattern)
    return bool(causal) and head_layout(
        mesh, cfg.n_heads, cfg.n_kv_heads) == "seq"


def _run_rank(cfg, shape, n_dev: int, multi_pod: bool, rank: int):
    with fake_world(n_dev, rank), _alltoall_kept():
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        sh.set_mesh(mesh)
        try:
            return run_step(cfg, shape, mesh)
        finally:
            sh.set_mesh(None)


def _write(meta, out_dir, arch, shape_name, multi_pod):
    if not out_dir:
        return
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    name = f"{arch}_{shape_name}{'_mp' if multi_pod else ''}.json"
    (out / name).write_text(json.dumps(meta, indent=1, default=str))


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             out_dir=None, remat=None):
    t0 = time.time()
    mesh_name = "multi" if multi_pod else "single"
    cfg = get_config(arch)
    if remat:
        cfg = cfg.scaled(remat=remat)
    shape = SHAPES[shape_name]
    skip = cell_supported(cfg, shape)
    if skip:
        meta = {"skip": skip, "status": "skipped", "arch": arch,
                "shape": shape_name, "multi_pod": multi_pod}
        print(f"[dryrun] {arch} x {shape_name} ({mesh_name}): SKIP ({skip})",
              flush=True)
        _write(meta, out_dir, arch, shape_name, multi_pod)
        return meta
    n_dev = 512 if multi_pod else 256
    meta = {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
            "n_devices": n_dev}
    try:
        ranks = [0]
        if ranks_differ(cfg, shape, production_shape(multi_pod)):
            ranks.append(last_model_rank(multi_pod))
        runs = {r: _run_rank(cfg, shape, n_dev, multi_pod, r) for r in ranks}
        counts = {r: {"flops": st.flops, "hbm_bytes": st.hbm_bytes,
                      "hbm_bytes_raw": st.hbm_bytes_raw,
                      "collective_bytes": st.coll.wire_bytes,
                      "argument_bytes": arg_b, "output_bytes": out_b,
                      "temp_bytes": st.peak_bytes, "alias_bytes": alias_b,
                      "output_made_bytes": made_b, "top_live": st.top_live()}
                  for r, (st, arg_b, out_b, alias_b, made_b)
                  in runs.items()}
        most = {k: max(c[k] for c in counts.values()) for k in counts[0]
                if k != "top_live"}
        by_flops = runs[max(ranks, key=lambda r: counts[r]["flops"])][0]
        by_coll = runs[max(ranks, key=lambda r:
                           counts[r]["collective_bytes"])][0]
        by_live = counts[max(ranks, key=lambda r: counts[r]["temp_bytes"])]
        meta["model_flops"] = roof.analytic_model_flops(cfg, shape, n_dev)
        rl = roof.Roofline(flops=most["flops"], hbm_bytes=most["hbm_bytes"],
                           coll=by_coll.coll, model_flops=meta["model_flops"],
                           hbm_bytes_raw=most["hbm_bytes_raw"])
        mem = {k: most[k] for k in ("argument_bytes", "output_bytes",
                                    "temp_bytes")}
        mem.update(code_bytes=0, alias_bytes=most["alias_bytes"],
                   output_made_bytes=most["output_made_bytes"])
        # the reference's sum (arguments, outputs, temporaries; its alias
        # bytes added and taken off again), less the outputs the step
        # made: XLA's temporaries leave the outputs' buffers out, the live
        # bytes count them where they are live
        total = (mem["argument_bytes"] + mem["output_bytes"]
                 + mem["temp_bytes"] - mem["output_made_bytes"])
        mem["per_device_total_gib"] = round(total / 2**30, 3)
        meta.update({"status": "ok", "step_s": round(time.time() - t0, 1),
                     "memory": mem, "roofline": rl.as_dict(),
                     "ranks": {str(r): c for r, c in counts.items()},
                     "kernels": runs[0][0].kernels,
                     "top_products": by_flops.top_products(),
                     "top_collectives": by_coll.top_collectives(),
                     "top_live": by_live["top_live"],
                     "ops": runs[0][0].n_ops})
        flops = "/".join(f"{counts[r]['flops']:.3e}" for r in ranks)
        print(f"[dryrun] {arch} x {shape_name} ({mesh_name}): OK "
              f"trace={time.time() - t0:.0f}s mem={total / 2**30:.2f}GiB "
              f"bottleneck={rl.bottleneck} "
              f"t_step>={rl.step_time_s * 1e3:.1f}ms "
              f"useful={rl.useful_flops_fraction:.2f} "
              f"flops[rank {'/'.join(map(str, ranks))}]={flops}", flush=True)
        print(f"[dryrun]   live at the peak: " + "; ".join(
            f"{t['source']} {t['pass']} {t['dtype']} "
            f"{t['bytes'] / 2**30:.2f}GiB ({t['share']:.2f})"
            for t in by_live["top_live"][:3]), flush=True)
    except Exception as e:  # noqa: BLE001 -- record failures as results
        meta.update({"status": "error", "error": f"{type(e).__name__}: {e}",
                     "trace": traceback.format_exc()[-2000:]})
        print(f"[dryrun] {arch} x {shape_name}: ERROR {e}", flush=True)
    meta["wall_s"] = round(time.time() - t0, 1)
    _write(meta, out_dir, arch, shape_name, multi_pod)
    return meta


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--remat", default=None)
    ap.add_argument("--out", default="results/dryrun_torch")
    args = ap.parse_args(argv)

    archs = ARCHS if (args.all or args.arch in (None, "all")) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape in (None, "all")) \
        else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    results = [run_cell(a, s, multi_pod=mp, out_dir=args.out,
                        remat=args.remat)
               for a in archs for s in shapes for mp in meshes]
    ok = sum(r.get("status") == "ok" for r in results)
    skip = sum(r.get("status") == "skipped" for r in results)
    err = sum(r.get("status") == "error" for r in results)
    print(f"[dryrun] done: {ok} ok, {skip} skipped, {err} errors", flush=True)
    return 1 if err else 0


if __name__ == "__main__":
    raise SystemExit(main())
