"""The embedding lookup of train and prefill under a mesh, 8 gloo ranks on
the CPU: each rank gathers its vocab slice of the table over the axes that
shard the embed dim (the FSDP axes) and looks up its own batch's tokens
there, the rows summed over the vocab's ranks (``layers.embed_lookup``).
On (data=2, model=4) and on a mesh laid out as the multi-pod mesh's axes,
(pod=2, data=2, model=2): the rows bit-equal to ``F.embedding`` on the
unsharded table, the table's gradient within 1e-6 (f32) of the
unsharded one (in bf16 within 1e-2, a row's repeats summed as the
unsharded lookup sums them), and no collective of the lookup, forward or backward,
moving the whole table (``OpStats.top_collectives`` of the same call)."""

import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.parallel.collectives import spawn_ranks

WORLD = 8
MESHES = {"2x4": ((2, 4), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
V, D, B, S = 64, 16, 4, 6
GRAD_REL = 1e-6
# bf16: a few tokens repeated over a long batch, each rank's repeats summed
# and rounded before the sum over ranks (6e-3 to 7e-3 from the unsharded
# gradient here)
BF16 = {"tokens": (0, 5, 17, 33, 50, V - 1), "seq": 64}
BF16_GRAD_REL = 1e-2


def _inputs(dtype="float32"):
    rng = np.random.default_rng(26)
    table = rng.normal(size=(V, D)).astype(np.float32)
    if dtype == "float32":
        toks = rng.integers(0, V, (B, S))
        toks[0, :3] = [0, V - 1, V // 2]   # the first and last rows, a seam
    else:
        toks = rng.choice(BF16["tokens"], (B, BF16["seq"]))
    return {"table": table, "tokens": toks,
            "cot": rng.normal(size=toks.shape + (D,)).astype(np.float32)}


def _lookup(name, sh, res, dtype="float32"):
    """The lookup and the table's gradient through a loss on the stream's
    layout, counted; rank 0 keeps the gathered results."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import layers as L
    from repro_torch.roofline.op_stats import OpStats
    shape, names = MESHES[name]
    mesh = make_host_mesh(shape, names, device_type="cpu")
    dt = getattr(torch, dtype)
    a = {k: torch.from_numpy(v) for k, v in _inputs(dtype).items()}
    sh.set_mesh(mesh)
    try:
        table = sh.distribute(a["table"].to(dt), mesh, sh.spec_for(
            mesh, ("vocab", "embed"), (V, D))).requires_grad_()
        toks = sh.distribute(a["tokens"], mesh, sh.spec_for(
            mesh, ("batch", None), tuple(a["tokens"].shape)))
        cot = sh.distribute(a["cot"].to(dt), mesh, sh.spec_for(
            mesh, ("batch", None, None), tuple(a["cot"].shape)))
        if dtype != "float32":
            rows = L.embed_lookup(table, toks)
            x = sh.constrain(rows, ("batch", None, None))
            (x * cot).sum().backward()
            res[f"{name}/{dtype}/grad"] = \
                table.grad.full_tensor().float().numpy()
            return
        st = OpStats()
        with st:
            rows = L.embed_lookup(table, toks)
            x = sh.constrain(rows, ("batch", None, None))
            (x * cot).sum().backward()
        res[f"{name}/placements"] = np.array(
            [str(p) for p in table.placements])
        res[f"{name}/rows"] = x.full_tensor().detach().numpy()
        res[f"{name}/grad"] = table.grad.full_tensor().numpy()
        res[f"{name}/grad_placements"] = np.array(
            [str(p) for p in table.grad.placements])
        lookup = [c for c in st.top_collectives()
                  if c["source"].startswith("repro_torch/models/layers.py")]
        res[f"{name}/sizes"] = np.array(
            [int(np.prod(c["shape"])) for c in lookup], dtype=np.int64)
        res[f"{name}/kinds"] = np.array([f"{c['kind']}/{c['pass']}"
                                         for c in lookup])
    finally:
        sh.set_mesh(None)


def _ranks(rank, world, init, out_dir):
    import torch.distributed as dist
    from repro_torch.parallel import collectives
    from repro_torch.parallel import sharding as sh
    torch.set_num_threads(1)
    collectives.init("gloo", rank, world, init)
    try:
        res = {}
        for name in MESHES:
            _lookup(name, sh, res)
            _lookup(name, sh, res, "bfloat16")
        if rank == 0:
            np.savez(os.path.join(out_dir, "embed.npz"), **res)
        dist.barrier()
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("embed_sharded")
    spawn_ranks(_ranks, WORLD, (str(tmp),), timeout_s=240)
    return dict(np.load(tmp / "embed.npz"))


def _unsharded(dtype="float32"):
    a = _inputs(dtype)
    dt = getattr(torch, dtype)
    table = torch.from_numpy(a["table"]).to(dt).requires_grad_()
    rows = F.embedding(torch.from_numpy(a["tokens"]), table)
    (rows * torch.from_numpy(a["cot"]).to(dt)).sum().backward()
    return rows.detach().float().numpy(), table.grad.float().numpy()


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_table_sharded_over_vocab_and_embed(runs, mesh):
    """The case the lookup is for: the table's vocab over ``model``, its
    embed dim over the FSDP axes (one or two of them)."""
    want = ["S(1)"] * (len(MESHES[mesh][0]) - 1) + ["S(0)"]
    assert list(runs[f"{mesh}/placements"]) == want
    assert list(runs[f"{mesh}/grad_placements"]) == want


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_rows_bit_equal_to_unsharded(runs, mesh):
    rows, _ = _unsharded()
    got = runs[f"{mesh}/rows"]
    assert got.shape == rows.shape
    assert np.array_equal(got, rows)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_table_grad_matches_unsharded(runs, mesh):
    _, grad = _unsharded()
    got = runs[f"{mesh}/grad"]
    rel = np.abs(got - grad).max() / np.abs(grad).max()
    assert rel <= GRAD_REL, rel


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_bf16_table_grad_sums_repeats_as_unsharded(runs, mesh):
    """bf16, a few tokens repeated: each rank sums a row's repeats by
    F.embedding's backward, as the unsharded lookup does, and the table's
    gradient differs from the unsharded one by the rounding of the ranks'
    partial sums.  (On the H100 an ``index_select``'s backward, bf16
    atomic adds of each repeat, put the embedding's gradient 9.1e-02 from
    the unsharded one in olmoe's bf16 EP case; the CPU's adds do not show
    that, so the card's ``dist olmoe EP`` check holds it.)"""
    _, grad = _unsharded("bfloat16")
    got = runs[f"{mesh}/bfloat16/grad"]
    rel = np.linalg.norm(got - grad) / np.linalg.norm(grad)
    assert rel <= BF16_GRAD_REL, rel


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_no_collective_moves_the_whole_table(runs, mesh):
    """The forward gathers the rank's vocab slice over the FSDP axes, the
    backward reduce-scatters its gradient over them: each payload at most
    the vocab slice, V / model rows, never the whole table (V x D), and no
    all-reduce of the table's gradient."""
    model = MESHES[mesh][0][-1]
    sizes, kinds = runs[f"{mesh}/sizes"], list(runs[f"{mesh}/kinds"])
    assert "all-gather/forward" in kinds
    assert "reduce-scatter/backward" in kinds
    assert not any(k.startswith("all-reduce") for k in kinds), kinds
    assert sizes.max() <= V // model * D < V * D, (sizes, kinds)
