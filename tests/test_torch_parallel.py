"""The port's GPipe pipeline and int8 compressed all-reduce, 8 gloo ranks
on the CPU (processes of their own), against the sequential run, the exact
sum and the reference's outputs on the same numpy inputs (the reference in
a subprocess with 8 host devices and a mesh of ``Auto`` axes, as
tests/test_parallel.py's scenarios, whose own mesh no longer gets them
under this JAX)."""

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
D, N_MICRO, MB, N_STAGES = 32, 8, 4, 4


def _inputs():
    rng = np.random.default_rng(0)
    s = 1.0 / np.sqrt(D)
    return {
        "w1": (rng.standard_normal((N_STAGES, D, D)) * s).astype(np.float32),
        "w2": (rng.standard_normal((N_STAGES, D, D)) * s).astype(np.float32),
        "x": rng.standard_normal((N_MICRO, MB, D)).astype(np.float32),
        "g": (rng.standard_normal(4096) * 0.01).astype(np.float32),
    }


def _ranks(rank, world, init, out_dir):
    """Every rank: the pipeline on (replica=2, stage=4), compressed_psum of
    the same input and 4 rounds of compress_with_feedback on (data=8)."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel import collectives
    from repro_torch.parallel.compression import (compress_with_feedback,
                                                  compressed_psum)
    from repro_torch.parallel.pipeline import make_mlp_stage, pipeline_forward
    torch.set_num_threads(1)
    collectives.init("gloo", rank, world, init)
    try:
        a = {k: torch.from_numpy(v) for k, v in _inputs().items()}
        stage_fn, _ = make_mlp_stage(D)
        mesh = make_host_mesh((2, N_STAGES), ("replica", "stage"),
                              device_type="cpu")
        y = pipeline_forward(stage_fn, {"w1": a["w1"], "w2": a["w2"]},
                             a["x"], mesh=mesh)
        mesh = make_host_mesh((world,), ("data",), device_type="cpu")
        psum = compressed_psum(a["g"], mesh, "data")
        grads, residual = {"w": a["g"]}, {"w": torch.zeros_like(a["g"])}
        means = []
        for _ in range(4):
            mean, residual = compress_with_feedback(grads, residual, mesh,
                                                    "data")
            means.append(mean["w"])
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), pipe=y.numpy(),
                 psum=psum.numpy(), means=torch.stack(means).numpy())
        dist.barrier()
    finally:
        dist.destroy_process_group()


REFERENCE = """
import sys, numpy as np, jax, jax.numpy as jnp
from jax.sharding import AxisType
from repro.parallel.pipeline import pipeline_forward, make_mlp_stage
from repro.parallel.compression import compressed_psum, compress_with_feedback
a = dict(np.load(sys.argv[1]))
mesh = jax.make_mesh((4,), ("stage",), axis_types=(AxisType.Auto,))
stage_fn, _ = make_mlp_stage(a["x"].shape[-1])
y = pipeline_forward(stage_fn, {"w1": a["w1"], "w2": a["w2"]},
                     jnp.asarray(a["x"]), mesh=mesh)
mesh = jax.make_mesh((8,), ("data",), axis_types=(AxisType.Auto,))
g = jnp.asarray(a["g"])
psum = compressed_psum(g, mesh, "data")
grads, residual = {"w": g}, {"w": jnp.zeros_like(g)}
means = []
for _ in range(4):
    mean, residual = compress_with_feedback(grads, residual, mesh, "data")
    means.append(mean["w"])
np.savez(sys.argv[2], pipe=np.asarray(y), psum=np.asarray(psum),
         means=np.stack([np.asarray(m) for m in means]))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel")
    np.savez(tmp / "inputs.npz", **_inputs())
    env = {"XLA_FLAGS": "--xla_force_host_platform_device_count=8",
           "PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
           "JAX_PLATFORMS": "cpu"}
    ref = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(REFERENCE),
         str(tmp / "inputs.npz"), str(tmp / "ref.npz")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    spawn_ranks(_ranks, WORLD, (str(tmp),), timeout_s=240)
    _, err = ref.communicate(timeout=300)
    assert ref.returncode == 0, err[-3000:]
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(WORLD)]
    return ranks, dict(np.load(tmp / "ref.npz"))


def test_pipeline_matches_sequential(runs):
    ranks, _ = runs
    a = _inputs()
    ref = torch.from_numpy(a["x"])
    from repro_torch.parallel.pipeline import make_mlp_stage
    stage_fn, _ = make_mlp_stage(D)
    for s in range(N_STAGES):
        ref = stage_fn({"w1": torch.from_numpy(a["w1"][s]),
                        "w2": torch.from_numpy(a["w2"][s])}, ref)
    for r in ranks:                     # every rank of both replicas
        np.testing.assert_allclose(r["pipe"], ref.numpy(), atol=1e-4)


def test_pipeline_matches_reference(runs):
    ranks, ref = runs
    np.testing.assert_allclose(ranks[0]["pipe"], ref["pipe"], atol=1e-4)


def test_int8_compressed_allreduce_close_to_exact(runs):
    ranks, _ = runs
    exact = _inputs()["g"] * 8.0            # replicated input: psum = 8x
    for r in ranks:
        rel = np.linalg.norm(r["psum"] - exact) / np.linalg.norm(exact)
        assert rel < 0.02, rel


def test_int8_compressed_allreduce_matches_reference(runs):
    """Rank 0's result against the reference's replicated output (its
    device 0's copy): each rank keeps the chunk it reduced unquantized,
    so the ranks' results differ in that chunk, in both packages."""
    ranks, ref = runs
    np.testing.assert_allclose(ranks[0]["psum"], ref["psum"], atol=1e-6)


def test_error_feedback_converges(runs):
    ranks, ref = runs
    g = _inputs()["g"]
    for r in ranks:
        assert float(np.abs(r["means"][-1] - g).max()) < 0.005
    np.testing.assert_allclose(ranks[0]["means"], ref["means"], atol=1e-6)
