"""The port's checkpoints of a sharded state, 8 gloo ranks on the CPU:

* a DTensor state is saved whole (every rank gathers, rank 0 writes) and
  restores elastically: two f32 train steps of stablelm-smoke on mesh
  (data=2, model=4), a save, a restore onto (4, 2) with ``shardings``,
  and one more step give the loss and parameters of three unsharded
  steps;
* a sharded checkpoint restores into an unsharded template and an
  unsharded one into a sharded template, each leaf bit for bit;
* a checkpoint written by the reference's ``CheckpointManager`` restores
  onto the mesh (the cross-package round trip of
  ``tests/test_torch_train.py``, sharded);
* ``Trainer(mesh=, shardings=)`` restores onto its mesh, as the
  reference's ``trainer.py`` passes its shardings on."""

import copy
import os

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_config as j_smoke
from repro.models.model import init_params as j_init
from repro.optim import adamw as jadamw
from repro.train.checkpoint import CheckpointManager as JCheckpointManager
from repro_torch.bridge import tensor_to_numpy
from repro_torch.parallel.collectives import spawn_ranks
from repro_torch.train.checkpoint import CheckpointManager

WORLD = 8
ARCH = "stablelm_12b"
B, S = 8, 16
LOSS_REL = 1e-5
PARAM_REL = 1e-4


def _batches(vocab):
    rng = np.random.default_rng(11)
    out = []
    for _ in range(3):
        toks = rng.integers(0, vocab, (B, S + 1))
        out.append({"tokens": torch.from_numpy(toks[:, :-1]),
                    "targets": torch.from_numpy(toks[:, 1:])})
    return out


def _bits(t: torch.Tensor) -> np.ndarray:
    return tensor_to_numpy(t).reshape(-1).view(np.uint8)


def _ranks(rank, world, init, tmp):
    import torch.distributed as dist
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.model import init_params, params_logical_axes
    from repro_torch.optim.adamw import (adamw_init, cosine_schedule,
                                         opt_state_axes, tree_map)
    from repro_torch.parallel import collectives
    from repro_torch.parallel import sharding as sh
    from repro_torch.train.checkpoint import flatten_with_paths
    from repro_torch.train.train_step import make_train_step
    from repro_torch.train.trainer import Trainer, TrainerConfig
    torch.set_num_threads(1)
    collectives.init("gloo", rank, world, init)
    res = {}
    try:
        cfg = get_smoke_config(ARCH).scaled(dtype="float32")
        f32 = lambda tree: tree_map(lambda t: t.float(), tree)  # noqa: E731
        p0 = f32(init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu"))
        axes = params_logical_axes(cfg)
        state_axes = {"params": axes, "opt": opt_state_axes(axes)}
        step = make_train_step(cfg, lr=cosine_schedule(1e-2, warmup=1,
                                                       total=10))
        batches = _batches(cfg.vocab)

        # three unsharded steps
        pu = copy.deepcopy(p0)
        ou = adamw_init(pu)
        for b in batches:
            pu, ou, m = step(pu, ou, b)
        res["loss_u"] = float(m["loss"])
        for k, v in flatten_with_paths(pu):
            res[f"u/{k}"] = v.numpy()

        # two on (2, 4), saved (async) by every rank, written by rank 0
        mesh_a = make_host_mesh((2, 4), device_type="cpu")
        sh.set_mesh(mesh_a)
        dp = sh.tree_distribute(mesh_a, copy.deepcopy(p0), axes)
        do = adamw_init(dp)
        for b in batches[:2]:
            db = {k: sh.distribute(v, mesh_a, sh.batch_spec(mesh_a))
                  for k, v in b.items()}
            dp, do, _ = step(dp, do, db)
        mgr = CheckpointManager(os.path.join(tmp, "sharded"))
        mgr.save(2, {"params": dp, "opt": do}, extra={"data_step": 2},
                 async_=True)
        mgr.wait()
        res["latest_seen"] = mgr.latest_step()       # after the barrier
        whole_a = {k: sh.full(v) for k, v in
                   flatten_with_paths({"params": dp, "opt": do})}

        # restored onto (4, 2), one more step
        mesh_b = make_host_mesh((4, 2), device_type="cpu")
        sh.set_mesh(mesh_b)
        tp = f32(init_params(cfg, torch.Generator().manual_seed(1),
                             device="cpu"))          # other values
        tmpl = {"params": tp, "opt": adamw_init(tp)}
        shardings = sh.tree_shardings(mesh_b, state_axes, tmpl)
        state, meta = mgr.restore(tmpl, shardings=shardings, mesh=mesh_b)
        res["meta_step"] = meta["extra"]["data_step"]
        want = dict(flatten_with_paths(shardings))
        res["placed"] = all(
            tuple(v.placements) == tuple(want[k])
            and v.device_mesh == mesh_b
            for k, v in flatten_with_paths(state))
        res["restored_exact"] = all(
            torch.equal(sh.full(v), whole_a[k])
            for k, v in flatten_with_paths(state))
        db = {k: sh.distribute(v, mesh_b, sh.batch_spec(mesh_b))
              for k, v in batches[2].items()}
        ps, _, m = step(state["params"], state["opt"], db)
        res["loss_s"] = float(sh.full(m["loss"]))
        for k, v in flatten_with_paths(ps):
            res[f"s/{k}"] = sh.full(v).numpy()

        # the sharded checkpoint into an unsharded template
        sh.set_mesh(None)
        plain, _ = mgr.restore({"params": copy.deepcopy(p0),
                                "opt": adamw_init(p0)})
        res["into_plain_exact"] = all(
            not sh.is_dtensor(v) and torch.equal(v, whole_a[k])
            for k, v in flatten_with_paths(plain))

        # an unsharded checkpoint (rank 0's) into a sharded template
        plain_dir = os.path.join(tmp, "plain")
        if rank == 0:
            CheckpointManager(plain_dir).save(3, {"params": pu, "opt": ou})
        dist.barrier()
        dtmpl = {"params": sh.tree_distribute(mesh_b, copy.deepcopy(p0),
                                              axes)}
        dtmpl["opt"] = adamw_init(dtmpl["params"])
        got, _ = CheckpointManager(plain_dir).restore(dtmpl)
        src = dict(flatten_with_paths({"params": pu, "opt": ou}))
        tl = dict(flatten_with_paths(dtmpl))
        res["into_sharded_exact"] = all(
            (tuple(v.placements) == tuple(tl[k].placements)
             if sh.is_dtensor(tl[k]) else not sh.is_dtensor(v))
            and torch.equal(sh.full(v), src[k])
            for k, v in flatten_with_paths(got))

        # the reference's checkpoint onto (2, 4), in its bf16
        sh.set_mesh(mesh_a)
        rp = init_params(get_smoke_config(ARCH), device="cpu")
        rtmpl = {"params": rp, "opt": adamw_init(rp)}
        ref, meta = CheckpointManager(os.path.join(tmp, "ref")).restore(
            rtmpl, shardings=sh.tree_shardings(mesh_a, state_axes, rtmpl),
            mesh=mesh_a)
        res["ref_step"] = meta["step"]
        res["ref_sharded"] = sh.is_dtensor(ref["params"]["embed"])
        for k, v in flatten_with_paths(ref):
            res[f"r/{k}"] = _bits(sh.full(v))

        # the trainer: restore onto its mesh
        tr = Trainer(cfg, TrainerConfig(ckpt_dir=os.path.join(tmp, "sharded")),
                     mesh=mesh_b, shardings=shardings, device="cpu")
        tparams, _, start = tr.try_restore()
        res["trainer_start"] = start
        res["trainer_placed"] = tuple(tparams["embed"].placements) == \
            tuple(shardings["params"]["embed"])
        res["trainer_exact"] = torch.equal(
            sh.full(tparams["embed"]),
            whole_a["params/embed"].to(tparams["embed"].dtype))
        sh.set_mesh(None)
        if rank == 0:
            np.savez(os.path.join(tmp, "port.npz"), **res)
        dist.barrier()
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ckpt_sharded")
    jcfg = j_smoke(ARCH)
    jp = jax.device_get(j_init(jcfg, jax.random.PRNGKey(4)))
    jst = jax.device_get(jadamw.adamw_init(jp))
    JCheckpointManager(str(tmp / "ref")).save(
        7, {"params": jp, "opt": jst}, extra={"data_step": 7})
    spawn_ranks(_ranks, WORLD, (str(tmp),), timeout_s=240,
                init_dir=str(tmp))
    port = dict(np.load(tmp / "port.npz"))
    return port, {"params": jp, "opt": jst}


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_run_saved_on_one_mesh_continues_on_another(runs):
    port, _ = runs
    assert port["loss_s"] == pytest.approx(port["loss_u"], rel=LOSS_REL)
    keys = [k[2:] for k in port if k.startswith("u/")]
    assert keys
    worst = max((_rel(port[f"s/{k}"], port[f"u/{k}"]), k) for k in keys)
    assert worst[0] <= PARAM_REL, worst


def test_sharded_save_is_whole_and_seen_by_every_rank(runs):
    port, _ = runs
    assert int(port["latest_seen"]) == 2
    assert int(port["meta_step"]) == 2
    assert bool(port["restored_exact"])


def test_restore_lays_leaves_out_by_shardings(runs):
    port, _ = runs
    assert bool(port["placed"])


def test_sharded_checkpoint_into_unsharded_template(runs):
    port, _ = runs
    assert bool(port["into_plain_exact"])


def test_unsharded_checkpoint_into_sharded_template(runs):
    port, _ = runs
    assert bool(port["into_sharded_exact"])


def test_reference_checkpoint_restores_onto_mesh(runs):
    port, ref = runs
    assert int(port["ref_step"]) == 7 and bool(port["ref_sharded"])
    flat = {}

    def walk(tree, prefix):
        if isinstance(tree, dict):
            for k in sorted(tree):
                walk(tree[k], prefix + (k,))
        elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
            for f in tree._fields:
                walk(getattr(tree, f), prefix + (f".{f}",))
        else:
            flat["/".join(prefix)] = np.asarray(tree)
    walk(ref, ())
    got = {k[2:]: v for k, v in port.items() if k.startswith("r/")}
    assert sorted(got) == sorted(flat)
    for k, a in flat.items():
        np.testing.assert_array_equal(got[k], a.reshape(-1).view(np.uint8),
                                      err_msg=k)


def test_trainer_restores_onto_its_mesh(runs):
    port, _ = runs
    assert int(port["trainer_start"]) == 2
    assert bool(port["trainer_placed"]) and bool(port["trainer_exact"])


def test_restore_with_shardings_needs_a_mesh(tmp_path):
    from torch.distributed.tensor import Replicate
    t = torch.zeros(4)
    CheckpointManager(str(tmp_path)).save(1, {"w": t})
    with pytest.raises(ValueError, match="needs a mesh"):
        CheckpointManager(str(tmp_path)).restore(
            {"w": t}, shardings={"w": (Replicate(),)})
