"""The port's dry-run against the reference's on the multi-pod mesh
(pod=2, data=16, model=16), every prefill_32k cell of the single pod's
grid (``test_torch_dryrun_parity.CELLS``): one rank of the port's
sharded prefill does the work of one device of the reference's
partitioned program in about its bytes.  Both packages run as the
single pod's parity test runs them, by its wrappers and under its
limits: FLOPs and collective bytes a device, a prefill's output bytes
and its bytes a device, each within the reference's, and ``top_live``
splitting the port's peak.

What it holds: the embedding's lookup gathered the whole table onto
every rank (2.36 GB of bf16 in gemma2, the whole peak of a device,
through two all-gathers over the FSDP axes); each rank now gathers its
vocab slice only and looks up its own batch's tokens there
(``layers.embed_lookup``)."""

import json
import subprocess
import sys
import textwrap

import pytest

from test_torch_dryrun_parity import (CELLS, FLOPS_LIMIT, GATHERED_LIMIT,
                                      MEMORY_LIMIT, OUTPUT_LIMIT, PORT,
                                      REFERENCE, ROOT)

PREFILL = [c for c in CELLS if c[1] == "prefill_32k"]


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    """Each cell's multi-pod dry-run JSON: (the reference's, the
    port's)."""
    tmp = tmp_path_factory.mktemp("dryrun_multipod")
    cells = [":".join(c + ("multi",)) for c in PREFILL]
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
           "JAX_PLATFORMS": "cpu"}
    runs = [("ref", REFERENCE, cells), ("port", PORT, cells[0::2]),
            ("port", PORT, cells[1::2])]
    procs = {(name, i): subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(code), str(tmp / name)]
        + part, env=env, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
        for i, (name, code, part) in enumerate(runs)}
    for name, p in procs.items():
        out, _ = p.communicate(timeout=900)
        assert p.returncode == 0, f"{name}: {out[-3000:]}"

    def load(name, arch, shape):
        d = json.loads((tmp / name / f"{arch}_{shape}_mp.json").read_text())
        assert d["status"] == "ok", (name, arch, shape, d.get("error"))
        assert d["multi_pod"] and d["n_devices"] == 512, (name, arch)
        return d
    return {cell: (load("ref", *cell), load("port", *cell))
            for cell in PREFILL}


def _ratio(cells, cell, part, key):
    ref, port = cells[cell]
    return port[part][key] / ref[part][key]


@pytest.mark.parametrize("cell", PREFILL, ids=lambda c: c[0])
def test_multi_pod_prefill_memory_within_reference(cells, cell):
    """No more bytes a device than the reference's: the lookup holds the
    rank's vocab slice, not the whole table."""
    ratio = _ratio(cells, cell, "memory", "per_device_total_gib")
    assert ratio <= MEMORY_LIMIT, (cell, ratio, cells[cell][1]["top_live"][:3])


@pytest.mark.parametrize("cell", PREFILL, ids=lambda c: c[0])
def test_multi_pod_prefill_flops_within_reference(cells, cell):
    ratio = _ratio(cells, cell, "roofline", "flops_per_device")
    assert ratio <= FLOPS_LIMIT, (cell, ratio)


@pytest.mark.parametrize("cell", PREFILL, ids=lambda c: c[0])
def test_multi_pod_prefill_outputs_within_reference(cells, cell):
    ratio = _ratio(cells, cell, "memory", "output_bytes")
    assert ratio <= OUTPUT_LIMIT, (cell, ratio)


@pytest.mark.parametrize("cell", PREFILL, ids=lambda c: c[0])
def test_multi_pod_prefill_collective_bytes_within_reference(cells, cell):
    ratio = _ratio(cells, cell, "roofline", "collective_bytes_per_device")
    assert ratio <= GATHERED_LIMIT, (cell, ratio)


@pytest.mark.parametrize("cell", PREFILL, ids=lambda c: c[0])
def test_multi_pod_top_live_splits_the_peak(cells, cell):
    _, port = cells[cell]
    live = port["top_live"]
    assert live and abs(sum(t["share"] for t in live) - 1) < 1e-9
    assert all(set(t) == {"source", "pass", "dtype", "bytes", "share"}
               for t in live)
    assert all(r["top_live"] for r in port["ranks"].values())


def _lookup_lines():
    """The source lines of the embedding's lookup and of its gather."""
    import inspect
    from repro_torch.models import layers as L
    from repro_torch.parallel import sharding as sh
    lines = set()
    for fn in (L.embed_lookup, sh._Gather, sh.gather_chunks):
        src, first = inspect.getsourcelines(fn)
        path = inspect.getsourcefile(fn).split("src/")[-1]
        lines.update(f"{path}:{n}" for n in range(first, first + len(src)))
    return lines


@pytest.mark.parametrize("cell", PREFILL, ids=lambda c: c[0])
def test_lookup_holds_the_vocab_slice_not_the_table(cells, cell):
    """What the lookup's lines hold at the peak is at most the rank's
    vocab slice (the vocab over ``model``'s 16 ranks, where it divides)
    and its output rows (the rank's batch of 32768 tokens); gemma2's whole
    table is 2359296000 bytes, 16x its slice."""
    from repro_torch.configs.base import SHAPES
    from repro_torch.configs.registry import get_config
    cfg, shape = get_config(cell[0]), SHAPES[cell[1]]
    _, port = cells[cell]
    size = {"bfloat16": 2, "float32": 4}
    rows = cfg.vocab // 16 if cfg.vocab % 16 == 0 else cfg.vocab
    lines = _lookup_lines()
    held = [t for t in port["top_live"] if t["source"] in lines]
    for t in held:
        limit = (rows + shape.global_batch // 32 * shape.seq_len) * cfg.d_model \
            * size[t["dtype"]]
        assert t["bytes"] <= limit, (cell, t, limit)
