"""The port's dry-run: tests/test_dryrun.py's three cells through
``python -m repro_torch.launch.dryrun`` (a ``fake`` process group of 256 /
512 ranks and the meta device, in a subprocess), and the op counter's
counterparts of tests/test_roofline.py: exact FLOPs of a loop-free product
chain (and the exact shares of its per-product tally), loops counted per
trip, the ring formulas on recorded collectives, pure data movement out of
the semantic bytes, and DTensor's all-to-all counted as one on a CPU
mesh."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.roofline.analysis import collective_bytes, ring_bytes
from repro_torch.roofline.op_stats import OpStats, record_kernel

ROOT = Path(__file__).resolve().parents[1]


def _dryrun(args):
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun"]
                       + args, capture_output=True, text=True, timeout=600,
                       env=env, cwd=ROOT)
    assert r.returncode == 0, r.stdout + r.stderr[-2000:]
    return r.stdout


@pytest.fixture(scope="module")
def rwkv6_decode(tmp_path_factory):
    """rwkv6 decode_32k through the CLI: (its output, its JSON)."""
    tmp = tmp_path_factory.mktemp("rwkv6_decode")
    out = _dryrun(["--arch", "rwkv6_1p6b", "--shape", "decode_32k",
                   "--out", str(tmp)])
    return out, json.loads((tmp / "rwkv6_1p6b_decode_32k.json").read_text())


def test_single_pod_cell_runs(rwkv6_decode):
    out, d = rwkv6_decode
    assert "OK" in out
    assert d["status"] == "ok"
    assert d["n_devices"] == 256
    r = d["roofline"]
    assert r["flops_per_device"] > 0
    assert r["bottleneck"] in ("compute", "memory", "collective")
    assert d["memory"]["argument_bytes"] > 0
    assert d["memory"]["per_device_total_gib"] > 0
    top = d["top_products"]
    assert 0 < len(top) <= 10
    assert sum(t["flops"] for t in top) <= r["flops_per_device"]
    assert all(t["share"] == t["flops"] / r["flops_per_device"] for t in top)


def test_top_collectives_name_port_lines(rwkv6_decode):
    """Every collective of a cell is in its tally, each entry named by a
    line of the port's models / train / parallel code that exists."""
    _, d = rwkv6_decode
    top, total = d["top_collectives"], d["roofline"][
        "collective_bytes_per_device"]
    assert top and sum(t["share"] for t in top) == pytest.approx(1.0,
                                                                 abs=1e-12)
    assert all(t["share"] == t["bytes"] / total for t in top)
    assert sum(t["count"] for t in top) == d["roofline"]["collective_count"]
    assert [t["bytes"] for t in top] == sorted(
        (t["bytes"] for t in top), reverse=True)
    for t in top:
        path, line = t["source"].rsplit(":", 1)
        assert path.split("/")[:2] in (["repro_torch", "models"],
                                       ["repro_torch", "train"],
                                       ["repro_torch", "parallel"]), t
        assert not path.endswith("sharding.py"), t
        lines = (ROOT / "src" / path).read_text().splitlines()
        assert 1 <= int(line) <= len(lines), t
        assert t["pass"] == "forward", t        # decode: no backward


@pytest.mark.parametrize("grad", [False, True], ids=["no_grad", "grad"])
def test_top_collectives_shares_exact(grad):
    """The per-collective tally on a loop-free chain: wire bytes by (kind,
    payload shape and dtype, group, source line, pass), a repeated
    collective summed, its shares exact; a pin's collective named by its
    caller's line (``models/model.py``'s residual sum, not
    ``parallel/sharding.py``), one outside the port "unknown".  The
    residual's all-reduce is issued in place where no gradient is taken
    (``add_in_place(``) and by DTensor's ``x + o`` on the gradient path
    every train cell runs (``constrain(x + o``): the same bytes and group
    at either line."""
    mark = "constrain(x + o" if grad else "add_in_place("
    code = f"GRAD, MARK = {grad!r}, {mark!r}" + """
import inspect, json, torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from repro_torch.launch.dryrun import fake_world
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import model
from repro_torch.parallel import sharding as sh
from repro_torch.roofline.op_stats import OpStats
lines, first = inspect.getsourcelines(model._residual)
at = first + next(i for i, ln in enumerate(lines) if MARK in ln)
with fake_world(4):
    mesh = make_host_mesh((4,), ("model",), device_type="cpu")
    sh.set_mesh(mesh)
    def dt(shape, pl, grad=False):
        return DTensor.from_local(torch.empty(shape, device="meta",
                                              requires_grad=grad),
                                  mesh, [pl], run_check=False)
    x, o, a = dt((2, 8, 16), Replicate(), GRAD), \
        dt((2, 8, 16), Partial(), GRAD), dt((8, 32), Shard(0))
    with OpStats() as st:
        model._residual(x, o)
        a.redistribute(mesh, [Replicate()])
        a.redistribute(mesh, [Replicate()])
    sh.set_mesh(None)
print(json.dumps({"at": at, "top": st.top_collectives(),
                  "total": st.coll.wire_bytes}))
"""
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, env=env, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-2000:]
    got = json.loads(r.stdout.strip().splitlines()[-1])
    gather = ring_bytes("all-gather", 32 * 32 * 4, 4) * 2
    reduce = ring_bytes("all-reduce", 2 * 8 * 16 * 4, 4)
    assert got["total"] == gather + reduce
    assert got["top"] == [
        {"kind": "all-gather", "shape": [32, 32], "dtype": "float32",
         "group": 4, "source": "unknown", "pass": "forward", "count": 2,
         "bytes": gather, "share": gather / (gather + reduce)},
        {"kind": "all-reduce", "shape": [2, 8, 16], "dtype": "float32",
         "group": 4, "source": f"repro_torch/models/model.py:{got['at']}",
         "pass": "forward", "count": 1, "bytes": reduce,
         "share": reduce / (gather + reduce)}]
    assert sum(t["share"] for t in got["top"]) == 1.0


def test_train_cell_argument_bytes_count_the_optimizer_state():
    """A train cell's arguments are the parameters, the batch and AdamW's
    state (its step, m and v): the bytes the step reads and aliases, on a
    small cell (olmoe-smoke, B=4 x S=16 on data=2 x model=4)."""
    code = """
import dataclasses
from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import get_smoke_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.parallel import sharding as sh
cfg = get_smoke_config("olmoe_1b_7b")
shape = dataclasses.replace(SHAPES["train_4k"], seq_len=16, global_batch=4)
with dryrun.fake_world(8), dryrun._alltoall_kept():
    mesh = make_host_mesh((2, 4), device_type="cpu")
    sh.set_mesh(mesh)
    st, arg_b, out_b, alias_b, _ = dryrun.run_step(cfg, shape, mesh)
    sh.set_mesh(None)
    params = dryrun._local_bytes(sh.tree_distribute(
        mesh, dryrun.abstract_params(cfg), dryrun.params_logical_axes(cfg)))
print(arg_b, alias_b, params)
"""
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, env=env, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-2000:]
    arg_b, alias_b, params = map(int, r.stdout.split()[-3:])
    batch = 2 * (4 // 2) * 16 * 4          # tokens, targets: int32, data=2
    assert alias_b > 2 * params             # m and v beside the parameters
    assert arg_b == alias_b + batch


def test_mesh_never_falls_back_to_the_cpu(monkeypatch):
    """With no ``device_type`` a mesh is CUDA's; without a card it raises
    rather than picking the CPU (the dry-run and the tests pass "cpu")."""
    from repro_torch.launch import mesh
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.make_production_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.make_host_mesh((2, 4))


def test_multi_pod_cell_runs(tmp_path):
    out = _dryrun(["--arch", "whisper_small", "--shape", "prefill_32k",
                   "--multi-pod", "--out", str(tmp_path)])
    assert "OK" in out
    d = json.loads((tmp_path / "whisper_small_prefill_32k_mp.json")
                   .read_text())
    assert d["status"] == "ok"
    assert d["n_devices"] == 512
    # whisper's 12 heads do not divide 16: every flash call is a CP shard
    assert d["kernels"]["flash_attention"] > 0


def test_carveout_cell_skips(tmp_path):
    out = _dryrun(["--arch", "gemma2_27b", "--shape", "long_500k",
                   "--out", str(tmp_path)])
    assert "SKIP" in out


def _meta(*shape):
    return torch.empty(shape, device="meta")


def test_loop_free_product_flops_exact():
    with OpStats() as st:
        (_meta(512, 256) @ _meta(256, 1024)) @ _meta(1024, 128)
    assert st.flops == 2 * 512 * 256 * 1024 + 2 * 512 * 1024 * 128


def test_top_products_shares_exact():
    """The per-product tally: FLOPs by (op, input shapes), a repeated
    product summed, its shares exact on a loop-free chain."""
    a, b, c = _meta(512, 256), _meta(256, 1024), _meta(1024, 128)
    with OpStats() as st:
        ab = a @ b
        ab @ c
        ab @ c
    f1, f2 = 2 * 512 * 256 * 1024, 2 * 2 * 512 * 1024 * 128
    assert st.flops == f1 + f2
    top = st.top_products()
    assert [(t["op"], t["shapes"], t["flops"]) for t in top] == [
        ("mm", [[512, 256], [256, 1024]], f1),
        ("mm", [[512, 1024], [1024, 128]], f2)]
    assert [t["share"] for t in top] == [f1 / (f1 + f2), f2 / (f1 + f2)]
    assert sum(t["share"] for t in top) == 1.0
    assert len(st.top_products(1)) == 1


def test_loop_counts_per_trip():
    ws = _meta(10, 128, 128)
    with OpStats() as st:
        x = _meta(128, 128)
        for i in range(10):
            x = x @ ws[i]
    assert st.flops == 10 * 2 * 128 ** 3


def test_nested_loops_compose():
    ws = _meta(5, 64, 64)
    with OpStats() as st:
        x = _meta(64, 64)
        for i in range(5):
            for _ in range(3):
                x = x @ ws[i]
    assert st.flops == 5 * 3 * 2 * 64 ** 3


def test_collective_ring_formulas():
    st = collective_bytes([("all-reduce", 4096, 4)])
    # ring AR: 2 * size * (n-1)/n
    assert abs(st.wire_bytes - 2 * 4096 * 3 / 4) < 1e-6
    st = collective_bytes([("all-gather", 4096, 8), ("all-to-all", 800, 4),
                           ("collective-permute", 100, 2)])
    assert st.wire_bytes == pytest.approx(4096 * 7 / 8 + 800 * 3 / 4 + 100)
    assert st.count == 3 and set(st.by_kind) == {
        "all-gather", "all-to-all", "collective-permute"}
    assert ring_bytes("reduce-scatter", 1000, 1) == 500.0   # n floored at 2


def test_semantic_excludes_pure_movement():
    a = torch.empty(256, 512, device="meta")
    with OpStats() as st:
        a.t().contiguous().to(torch.bfloat16)
    assert st.hbm_bytes == 0 < st.hbm_bytes_raw
    with OpStats() as st:
        torch.exp(a)
    assert st.hbm_bytes == st.hbm_bytes_raw == 2 * 256 * 512 * 4


def test_kernel_stand_in_records_forward_and_vjp():
    q = torch.empty(2, 8, 4, 16, device="meta", requires_grad=True)
    with OpStats() as st:
        y = record_kernel("flash_attention", (2, 8, 4, 16), torch.float32,
                          1000.0, 64.0, q)
        y.sum().backward()
    assert st.kernels == {"flash_attention": 1, "flash_attention.vjp": 1}
    assert st.flops == 1000.0 + 2500.0
    assert {(t["op"], t["flops"]) for t in st.top_products()} == {
        ("flash_attention", 1000.0), ("flash_attention.vjp", 2500.0)}
    assert q.grad.shape == q.shape


def test_dtensor_all_to_all_counted_as_one():
    """On a CPU mesh DTensor falls back from all-to-all to all-gather; the
    dry-run keeps the all-to-all (a GPU mesh's), and the counter sees one
    all-to-all of the local shard."""
    code = """
import torch, torch.distributed as dist
from torch.distributed.tensor import DTensor, Shard
from repro_torch.launch.dryrun import _alltoall_kept, fake_world
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.roofline.op_stats import OpStats
with fake_world(4), _alltoall_kept():
    mesh = make_host_mesh((4,), ("model",), device_type="cpu")
    x = DTensor.from_local(torch.empty(8, 32, device="meta"), mesh,
                           [Shard(0)], run_check=False)
    with OpStats() as st:
        x.redistribute(mesh, [Shard(1)])
    print(st.collectives)
"""
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, env=env, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().splitlines()[-1] == \
        "[('all-to-all', 1024.0, 4)]", r.stdout


# ----------------------------------------------------------------------------
# live bytes by storage: what the card's allocator holds
# ----------------------------------------------------------------------------


def test_product_output_counted_once():
    """``x @ w`` of a 3-D x is ``mm`` and ``_unsafe_view`` of its output:
    one buffer, counted once (it was counted twice for a moment, the peak
    of a prefill's row-parallel products)."""
    with OpStats() as st:
        a = torch.empty(4, 128, 64, device="meta", dtype=torch.bfloat16)
        w = torch.empty(64, 32, device="meta", dtype=torch.bfloat16)
        y = a @ w
    assert st.peak_bytes == (4 * 128 * 64 + 64 * 32 + 4 * 128 * 32) * 2
    del a, w
    assert st.live_bytes == y.numel() * 2


def test_view_holds_its_base():
    """A view outliving its base holds the base's bytes live (a prefill's
    last position sliced from the stream), released with the view."""
    with OpStats() as st:
        y = torch.empty(2, 1024, 64, device="meta")
        v = y[:, -1:]
        del y
        assert st.live_bytes == 2 * 1024 * 64 * 4
        del v
        assert st.live_bytes == 0


def test_collective_output_live_while_held():
    """A collective's output is live while the DTensor that holds it is:
    it reaches that DTensor through ``_wrap_tensor_autograd`` (a new
    tensor on meta, the same buffer on the card), which held it
    uncounted."""
    code = """
import torch
from torch.distributed.tensor import DTensor, Partial, Replicate
from repro_torch.launch.dryrun import fake_world
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.roofline.op_stats import OpStats
with fake_world(4):
    mesh = make_host_mesh((4,), ("model",), device_type="cpu")
    p = DTensor.from_local(torch.empty(256, 64, device="meta"), mesh,
                           [Partial()], run_check=False)
    with OpStats() as st:
        r = p.redistribute(mesh, [Replicate()])
        held = st.live_bytes
        del r
    print(held, st.live_bytes, st.peak_bytes)
"""
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, env=env, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-2000:]
    held, after, peak = map(int, r.stdout.split()[-3:])
    assert (held, after, peak) == (256 * 64 * 4, 0, 256 * 64 * 4)


def test_freed_storage_not_taken_for_a_live_one():
    """The storage of a collective's output is freed with that output
    while the wrapper holding its bytes lives on: its key goes with it, so
    a tensor made after on a new storage at the same address is counted in
    full (the key was left behind, and such a tensor taken for an alias of
    the collective: 0 bytes, the collective's kept live as long)."""
    code = """
import torch
from torch.distributed.tensor import DTensor, Partial, Replicate
from repro_torch.launch.dryrun import fake_world
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.roofline.op_stats import OpStats, _storage_key
with fake_world(4):
    mesh = make_host_mesh((4,), ("model",), device_type="cpu")
    p = DTensor.from_local(torch.empty(256, 64, device="meta"), mesh,
                           [Partial()], run_check=False)
    base = torch.empty(256, 64, device="meta")
    with OpStats() as st:
        rs = [p.redistribute(mesh, [Replicate()]) for _ in range(8)]
        held = st.live_bytes
        keys = set(st._allocs) == {_storage_key(r.to_local()) for r in rs}
        made = [base + i for i in range(64)]
        live = st.live_bytes
        del rs
        after = st.live_bytes
        del made
    print(keys, held, live, after, st.live_bytes)
"""
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, env=env, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-2000:]
    keys, *counts = r.stdout.split()[-5:]
    n = 256 * 64 * 4
    assert keys == "True"           # no key of a freed storage is left
    assert list(map(int, counts)) == [8 * n, 72 * n, 64 * n, 0]


def test_outputs_made_counted_once(rwkv6_decode):
    """A cell's bytes a device are the reference's sum (arguments, outputs,
    temporaries) with the outputs the step made taken once: they are among
    its live bytes already, where XLA's temporaries leave the outputs'
    buffers out.  A decode step's cache, written in place, is not made."""
    _, d = rwkv6_decode
    m = d["memory"]
    assert 0 < m["output_made_bytes"] <= m["output_bytes"] - m["alias_bytes"]
    total = (m["argument_bytes"] + m["output_bytes"] + m["temp_bytes"]
             - m["output_made_bytes"])
    assert m["per_device_total_gib"] == round(total / 2**30, 3)
