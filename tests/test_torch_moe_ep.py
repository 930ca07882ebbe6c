"""The port's expert-parallel MoE (``apply_moe_ep``: each ``model`` rank
routes its sequence slice, an all-to-all over ``model`` each way) on 8
gloo ranks on the CPU, mesh (data=4, model=2), in the reference's EP
scenario (tests/test_moe_ep.py: 8 experts top-2, capacity factor 8.0, one
shared expert): against its own dense dispatch (the reference's 2e-2),
against the reference's EP output, aux and ``jax.grad`` (the reference in
a subprocess with 8 host devices and a mesh of ``Auto`` axes, under which
its EP path runs), weights in f32 in both."""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.parallel.collectives import spawn_ranks

ROOT = Path(__file__).resolve().parents[1]
WORLD = 8

REFERENCE = """
import sys, numpy as np, jax, jax.numpy as jnp
from jax.sharding import AxisType
from repro.configs.base import ArchConfig, MoEConfig
from repro.models.moe import apply_moe, moe_specs
from repro.models import layers as L
from repro.parallel import sharding as sh

cfg = ArchConfig(name="ep-test", d_model=64, n_heads=4, n_kv_heads=4, d_ff=64,
                 vocab=256, moe=MoEConfig(n_experts=8, top_k=2, d_ff=32,
                                          capacity_factor=8.0, n_shared=1))
params = L.materialize(moe_specs(cfg), jax.random.PRNGKey(0))
params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
x = jax.random.normal(jax.random.PRNGKey(1), (4, 16, 64), jnp.float32) * 0.5
sh.set_mesh(None)
dense, _ = apply_moe(params, x, cfg=cfg)
mesh = jax.make_mesh((4, 2), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
sh.set_mesh(mesh)
out, aux = jax.jit(lambda p, x: apply_moe(p, x, cfg=cfg))(params, x)
g = jax.grad(lambda p: apply_moe(p, x, cfg=cfg)[0].sum())(params)
flat = lambda t, pre: {pre + "/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
                       for path, v in jax.tree_util.tree_flatten_with_path(t)[0]}
np.savez(sys.argv[1], x=np.asarray(x), dense=np.asarray(dense), out=np.asarray(out),
         moe_aux=np.asarray(aux["moe_aux"]), moe_z=np.asarray(aux["moe_z"]),
         **flat(params, "p:"), **flat(g, "g:"))
"""


def _tree(d, prefix):
    out = {}
    for k, v in d.items():
        if k.startswith(prefix):
            node = out
            *path, leaf = k[len(prefix):].split("/")
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = torch.from_numpy(v)
    return out


def _cfg():
    from repro_torch.configs.base import ArchConfig, MoEConfig
    return ArchConfig(name="ep-test", d_model=64, n_heads=4, n_kv_heads=4,
                      d_ff=64, vocab=256, moe=MoEConfig(
                          n_experts=8, top_k=2, d_ff=32, capacity_factor=8.0,
                          n_shared=1))


def _ranks(rank, world, init, ref_path, out_dir):
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import layers as L
    from repro_torch.models.moe import apply_moe, moe_specs
    from repro_torch.optim.adamw import tree_map
    from repro_torch.parallel import collectives
    from repro_torch.parallel import sharding as sh
    from repro_torch.train.checkpoint import flatten_with_paths
    from repro_torch.train.train_step import grad_tree
    torch.set_num_threads(1)
    collectives.init("gloo", rank, world, init)
    try:
        cfg = _cfg()
        ref = dict(np.load(ref_path))
        params, x = _tree(ref, "p:"), torch.from_numpy(ref["x"])
        mesh = make_host_mesh((4, 2), device_type="cpu")
        sh.set_mesh(mesh)
        dp = sh.tree_distribute(mesh, params, L.axes_tree(moe_specs(cfg)))
        dx = sh.distribute(x, mesh, sh.batch_spec(mesh))
        out, aux = apply_moe(dp, dx, cfg=cfg)
        leaves = tree_map(lambda t: t.detach().requires_grad_(True), dp)

        @sh.under_mesh
        def grads():
            y = apply_moe(leaves, dx, cfg=cfg)[0].sum()
            return grad_tree(sh.backward_under_mesh(y), leaves)
        g = {k: sh.full(v).numpy() for k, v in flatten_with_paths(grads())}
        res = {"out": sh.full(out).detach().numpy(),
               "moe_aux": sh.full(aux["moe_aux"]).detach().numpy(),
               "moe_z": sh.full(aux["moe_z"]).detach().numpy(),
               **{"g:" + k: v for k, v in g.items()}}
        sh.set_mesh(None)
        if rank == 0:
            res["dense"] = apply_moe(params, x, cfg=cfg)[0].detach().numpy()
            np.savez(os.path.join(out_dir, "port.npz"), **res)
        dist.barrier()
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe_ep")
    env = {"XLA_FLAGS": "--xla_force_host_platform_device_count=8",
           "PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
           "JAX_PLATFORMS": "cpu"}
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(REFERENCE),
                        str(tmp / "ref.npz")], env=env, capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    spawn_ranks(_ranks, WORLD, (str(tmp / "ref.npz"), str(tmp)),
                timeout_s=240)
    return dict(np.load(tmp / "port.npz")), dict(np.load(tmp / "ref.npz"))


def test_ep_matches_dense_dispatch(runs):
    port, _ = runs
    assert float(np.abs(port["out"] - port["dense"]).max()) < 2e-2


def test_ep_matches_reference_ep(runs):
    port, ref = runs
    np.testing.assert_allclose(port["out"], ref["out"], atol=1e-5)
    np.testing.assert_allclose(port["dense"], ref["dense"], atol=1e-5)


def test_ep_aux_matches_reference(runs):
    port, ref = runs
    for k in ("moe_aux", "moe_z"):
        np.testing.assert_allclose(port[k], ref[k], rtol=1e-5, atol=1e-7)


def test_ep_grads_match_reference(runs):
    """Gradients flow through the all-to-all exchanges: finite, and each
    leaf within 1e-4 of the reference's ``jax.grad``."""
    port, ref = runs
    keys = sorted(k for k in ref if k.startswith("g:"))
    assert keys == sorted(k for k in port if k.startswith("g:"))
    for k in keys:
        assert np.isfinite(port[k]).all(), k
        np.testing.assert_allclose(port[k], ref[k], atol=1e-4, rtol=1e-4,
                                   err_msg=k)
