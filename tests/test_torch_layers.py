"""The port's rms_norm without a gradient, a row chunk at a time, and the
residual sum written in place (``models/layers.py``,
``parallel/sharding.py::add_in_place``).  The chunk is forced small so
that small inputs run several chunks: the chunked norm is bit-equal to
one pass, in bf16 and f32, at the shapes its callers give it (the stream's
(B, S, D), the q/k norms' (B, S, H, D)); it matches the reference's
``repro.models.layers.rms_norm`` within ``tests/test_kernels.py``'s
tolerances; with a gradient its path and result are unchanged.  Under a
mesh (a ``fake`` process group on the CPU) a DTensor whose last dim is
whole is normed on its local rows, in its own placements, with no
collective, and the residual sum issues the one all-reduce DTensor's sum
does; on 4 gloo ranks a norm over a sharded last dim and the in-place
residual sum of a ``Partial`` output give the whole input's values."""

import os

import numpy as np
import pytest
import torch

from repro_torch.models import layers as L

RNG = np.random.default_rng(24)
CHUNK = 7
SHAPES = [(45, 32), (3, 17, 32), (2, 11, 3, 16)]   # rows 45, 51, 66
DTYPES = [torch.bfloat16, torch.float32]


def _data(shape, dtype):
    x = RNG.normal(size=shape).astype(np.float32)
    s = (0.1 * RNG.normal(size=shape[-1:])).astype(np.float32)
    return (x, s, torch.from_numpy(x).to(dtype),
            torch.from_numpy(s).to(dtype))


def _norm(x, s, chunk, monkeypatch):
    monkeypatch.setattr(L, "NORM_CHUNK_ROWS", chunk)
    with torch.no_grad():
        return L.rms_norm(x, s, 1e-6)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{len(s)}d")
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_chunked_norm_bit_equal_to_one_pass(shape, dtype, monkeypatch):
    _, _, x, s = _data(shape, dtype)
    rows = x.numel() // shape[-1]
    assert rows > 2 * CHUNK and rows % CHUNK
    x0 = x.clone()
    one = _norm(x, s, rows, monkeypatch)                # one pass
    chunked = _norm(x, s, CHUNK, monkeypatch)
    assert chunked.dtype == dtype and chunked.shape == x.shape
    assert torch.equal(chunked, one)
    assert torch.equal(x, x0)                           # input left as it is


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{len(s)}d")
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_chunked_norm_matches_reference(shape, dtype, monkeypatch):
    import jax.numpy as jnp
    from repro.models.layers import rms_norm as ref_norm
    xn, sn, x, s = _data(shape, dtype)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = ref_norm(jnp.asarray(xn).astype(jdt), jnp.asarray(sn).astype(jdt))
    got = _norm(x, s, CHUNK, monkeypatch)
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def test_chunked_norm_of_a_strided_view(monkeypatch):
    """MLA's ``kv_norm`` takes a slice of the last dim: its rows view the
    input, and the chunks read them in place."""
    _, _, x, s = _data((2, 13, 40), torch.bfloat16)
    v = x[..., :32]
    assert not v.is_contiguous()
    one = _norm(v.contiguous(), s[:32], 10 ** 6, monkeypatch)
    assert torch.equal(_norm(v, s[:32], CHUNK, monkeypatch), one)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_norm_with_a_gradient_unchanged(dtype, monkeypatch):
    """With a gradient the norm is the one autograd expression, never the
    chunked pass: its output and its grads are those of the formula."""
    monkeypatch.setattr(L, "NORM_CHUNK_ROWS", CHUNK)
    xn, sn, _, _ = _data((3, 17, 32), dtype)
    x = torch.from_numpy(xn).to(dtype).requires_grad_()
    s = torch.from_numpy(sn).to(dtype).requires_grad_()
    x2 = x.detach().clone().requires_grad_()
    s2 = s.detach().clone().requires_grad_()
    g = torch.from_numpy(RNG.normal(size=(3, 17, 32)).astype(np.float32)) \
        .to(dtype)
    with torch.enable_grad():
        got = L.rms_norm(x, s, 1e-6)
        x32 = x2.float()
        var = torch.mean(x32 * x32, dim=-1, keepdim=True)
        want = (x32 * torch.rsqrt(var + 1e-6) * (1.0 + s2.float())).to(dtype)
        assert got.grad_fn is not None
        assert torch.equal(got, want)
        got.backward(g)
        want.backward(g)
    assert torch.equal(x.grad, x2.grad) and torch.equal(s.grad, s2.grad)


@pytest.mark.parametrize("rows,passes", [(8 * 32, 1), (8192, 1),
                                         (8193, 2), (4 * 8192, 4)])
def test_passes_per_call(rows, passes, monkeypatch):
    """At the module's chunk of 8192 rows, serving's decode steps and
    32-token chunks keep one pass (their launches unchanged); a prefill
    of B=1, S=32768 runs 4."""
    calls = []
    one = L._norm_pass
    monkeypatch.setattr(L, "_norm_pass", lambda *a: calls.append(1) or one(*a))
    assert L.NORM_CHUNK_ROWS == 8192
    x = torch.empty(rows, 8, dtype=torch.bfloat16, device="meta")
    with torch.no_grad():
        L.rms_norm(x, torch.empty(8, dtype=torch.bfloat16, device="meta"))
    assert len(calls) == passes


def test_chunked_norm_holds_one_chunk_of_f32(monkeypatch):
    """The f32 temporaries live at the norm's peak are one chunk's, not
    the whole input's (the meta device, as the dry-run counts)."""
    from repro_torch.roofline.op_stats import OpStats
    monkeypatch.setattr(L, "NORM_CHUNK_ROWS", 1024)
    x = torch.empty(2, 8192, 512, dtype=torch.bfloat16, device="meta")
    s = torch.empty(512, dtype=torch.bfloat16, device="meta")
    st = OpStats()
    with torch.no_grad(), st:
        out = L.rms_norm(x, s)
    f32 = sum(t["bytes"] for t in st.top_live() if t["dtype"] == "float32")
    assert out.shape == x.shape and out.dtype == torch.bfloat16
    rows_f32 = 4 * 1024 * 4              # a chunk's means and rsqrts
    assert f32 <= 2 * 1024 * 512 * 4 + rows_f32
    # the output, and the f32 copy and its square of one chunk
    assert st.peak_bytes <= x.numel() * 2 + 2 * 1024 * 512 * 4 + rows_f32


# ----------------------------------------------------------------------------
# under a mesh: a ``fake`` process group of 4 ranks on the CPU
# ----------------------------------------------------------------------------


@pytest.fixture
def mesh():
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.launch.dryrun import fake_world
    with fake_world(4):
        yield init_device_mesh("cpu", (2, 2), mesh_dim_names=("data",
                                                              "model"))


def test_dtensor_norm_on_local_rows(mesh, monkeypatch):
    """Rows over ``data``, whole over ``model``, the global shape uneven:
    each rank norms its local rows (chunked) into its own placements, and
    no collective runs."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.roofline.op_stats import OpStats
    monkeypatch.setattr(L, "NORM_CHUNK_ROWS", CHUNK)
    _, _, local, s = _data((3, 17, 32), torch.bfloat16)
    x = DTensor.from_local(local, mesh, [Shard(0), Replicate()],
                           run_check=False, shape=torch.Size((5, 17, 32)),
                           stride=(17 * 32, 32, 1))
    sd = DTensor.from_local(s, mesh, [Replicate(), Replicate()],
                            run_check=False)
    st = OpStats()
    with torch.no_grad(), st:
        out = L.rms_norm(x, sd)
    assert st.collectives == []
    assert tuple(out.placements) == tuple(x.placements)
    assert out.shape == x.shape and out.stride() == x.stride()
    want = _norm(local, s, 10 ** 6, monkeypatch)
    assert torch.equal(out.to_local(), want)


def _ranks(rank, world, init, out_dir):
    """One of 4 gloo ranks on a (data=2, model=2) mesh: the norm of an
    input whose last dim is sharded over ``model`` (chunk forced to 2
    rows), and a ``Partial`` sum over ``model`` added to the stream in
    place; rank 0 writes the gathered results."""
    import torch.distributed as dist
    from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                          distribute_tensor)
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel import collectives
    from repro_torch.parallel.sharding import add_in_place
    torch.set_num_threads(1)
    collectives.init("gloo", rank, world, init)
    try:
        a = {k: torch.from_numpy(v) for k, v in _mesh_inputs().items()}
        mesh = make_host_mesh((2, 2), ("data", "model"), device_type="cpu")
        L.NORM_CHUNK_ROWS = 2
        x = distribute_tensor(a["x"], mesh, [Replicate(), Shard(1)])
        s = distribute_tensor(a["s"], mesh, [Replicate(), Replicate()])
        stream = distribute_tensor(a["stream"], mesh,
                                   [Replicate(), Replicate()])
        o = DTensor.from_local(a["parts"][mesh.get_local_rank("model")],
                               mesh, [Replicate(), Partial()],
                               run_check=False)
        with torch.no_grad():
            out = L.rms_norm(x, s)
            summed = add_in_place(stream, o)
        norm, total = out.full_tensor(), summed.full_tensor()
        if rank == 0:
            np.savez(os.path.join(out_dir, "mesh.npz"), norm=norm.numpy(),
                     total=total.numpy(),
                     replicated=np.array(out.placements[0].is_replicate()),
                     same=np.array(summed is stream))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _mesh_inputs():
    rng = np.random.default_rng(241)
    return {"x": rng.normal(size=(6, 8)).astype(np.float32),
            "s": (0.1 * rng.normal(size=8)).astype(np.float32),
            "stream": rng.normal(size=(2, 5, 8)).astype(np.float32),
            "parts": rng.normal(size=(2, 2, 5, 8)).astype(np.float32)}


@pytest.fixture(scope="module")
def gloo_mesh(tmp_path_factory):
    from repro_torch.parallel.collectives import spawn_ranks
    tmp = tmp_path_factory.mktemp("layers_mesh")
    spawn_ranks(_ranks, 4, (str(tmp),), timeout_s=120)
    return dict(np.load(tmp / "mesh.npz"))


def test_dtensor_norm_over_a_sharded_last_dim_unchanged(gloo_mesh,
                                                        monkeypatch):
    """A last dim sharded over ``model`` (Mamba2's gate norm) is normed
    by DTensor's own ops in one pass (its mean needs the whole row), as
    before, whatever its row count: on 4 gloo ranks, its gathered value
    is the one-pass norm of the whole input (f32; the mean's sum is split
    over the ranks, so within 1e-6, not bit-equal)."""
    a = _mesh_inputs()
    want = _norm(torch.from_numpy(a["x"]), torch.from_numpy(a["s"]), 10 ** 6,
                 monkeypatch)
    assert bool(gloo_mesh["replicated"])
    assert gloo_mesh["norm"].shape == a["x"].shape
    np.testing.assert_allclose(gloo_mesh["norm"], want.numpy(), atol=1e-6,
                               rtol=1e-6)


def test_add_in_place_sums_a_partial_over_ranks(gloo_mesh):
    """The residual sum in place on 4 gloo ranks: the stream's buffer holds
    the stream plus the ``model`` ranks' partial outputs."""
    a = _mesh_inputs()
    assert bool(gloo_mesh["same"])
    np.testing.assert_allclose(gloo_mesh["total"],
                               a["stream"] + a["parts"].sum(0), atol=1e-6,
                               rtol=1e-6)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_add_in_place_plain_bit_equal(dtype):
    from repro_torch.parallel.sharding import add_in_place
    xn, _, x, _ = _data((3, 9, 16), dtype)
    o = torch.from_numpy(RNG.normal(size=(3, 9, 16)).astype(np.float32)) \
        .to(dtype)
    want = x + o
    got = add_in_place(x, o)
    assert got is x and torch.equal(got, want)
    assert add_in_place(x, o[:, :1]) is None         # no broadcast
    assert add_in_place(x, o.double()) is None       # no promotion


def test_add_in_place_reduces_a_partial_sum_once(mesh):
    """A row-parallel output (``Partial`` over ``model``) added to the
    stream (whole over ``model``): the one all-reduce DTensor's ``x + o``
    issues, of the same payload over the same group, in place on o's
    local tensor; the sum lands in x's buffer and no tensor of the
    stream's size is allocated."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from repro_torch.parallel.sharding import add_in_place
    from repro_torch.roofline.op_stats import OpStats

    def pair():
        x = DTensor.from_local(torch.empty(2, 64, 32, device="meta",
                                           dtype=torch.bfloat16),
                               mesh, [Shard(0), Replicate()],
                               run_check=False)
        o = DTensor.from_local(torch.empty(2, 64, 32, device="meta",
                                           dtype=torch.bfloat16),
                               mesh, [Shard(0), Partial()], run_check=False)
        return x, o

    x, o = pair()
    ref = OpStats()
    with torch.no_grad(), ref:
        want = (x + o).redistribute(mesh, [Shard(0), Replicate()])
    x, o = pair()
    st = OpStats()
    with torch.no_grad(), st:
        got = add_in_place(x, o)
    assert got is x and tuple(got.placements) == tuple(want.placements)
    assert st.collectives == ref.collectives == [
        ("all-reduce", 2 * 64 * 32 * 2, 2)]
    assert st.peak_bytes == 0 < ref.peak_bytes
    x, o = pair()
    assert add_in_place(o, x) is None    # a Partial stream: DTensor adds
