"""The port's dry-run against the reference's, cell by cell on the single
pod (16 x 16): one rank of the port's sharded step does the work of one
device of the reference's partitioned program.  FLOPs and collective
bytes per device are counts of work, not of a chip, so the two packages'
figures compare (their step-time bounds do not: the reference's are TPU
peaks, and none is quoted here).

The reference's dry-run runs in a subprocess with ``jax.make_mesh``
defaulting to ``AxisType.Auto`` axes (JAX 0.9's default, ``Explicit``,
is not what the reference was written for); the wrapper below sets that
default before the module runs, so no reference file changes.  The port's
runs in a second subprocess.  One cell per cause of the extra work the
port did before its layout was repaired, and a control:

* MoE without expert parallelism ran every expert on every rank:
  olmoe and deepseek decode_32k (their collective bytes too);
* decode at batch 1 gathered each layer's weights: rwkv6 long_500k;
* heads that do not divide ``model`` made the q/o projections full
  width on every ``model`` rank: starcoder2 train_4k and prefill_32k,
  stablelm decode_32k, whisper train_4k;
* a gradient left ``Partial`` over ``model`` made the backward redo a
  product at full width: gemma2 train_4k;
* codeqwen decode_32k, at the reference's count before the repair.

And the repairs of the sharded step's collectives and outputs:

* Mamba2's in_proj output was gathered whole on every ``model`` rank,
  and each slice of its conv output again: zamba2 prefill_32k and
  train_4k's collective bytes;
* the "groups" layout gathered its K/V whole: stablelm prefill_32k's;
* a prefill's cache came out whole over ``model``, not in the layout
  decode reads: every prefill cell's output bytes (whisper prefill_32k
  too);
* rank 0 alone was counted, the causal context-parallel rank that scores
  the fewest pairs: starcoder2 and whisper prefill_32k's busiest rank.

And a device's memory (``per_device_total_gib``, the outputs of
collectives counted among the live bytes):

* the loss gathered the whole batch's f32 logits onto every rank (and
  deepseek's MTP head all-reduced vocab-wide logits): every train_4k
  cell, olmoe's and deepseek's added for it, within the reference's
  bytes a device, and the loss's own collectives a sliver of the cell's;
* a prefill held its cache twice (each layer's tensors and their stacked
  copy), rms_norm two f32 temporaries of its whole input, and the
  residual sum four tensors of the stream's size, beside the callers'
  stale references to earlier ones: every prefill cell within the
  reference's bytes a device (codeqwen, gemma2 and olmoe added for it);
* the count itself: a product's output counted twice (``mm`` and the
  ``_unsafe_view`` of it), a collective's output released while the
  DTensor that holds it lives, and a step's outputs added to live bytes
  that held them already (XLA's temporaries leave the outputs out).

And the collectives of a decode step at batch 1 (long_500k), on the
single pod and on the multi-pod mesh (2 x 16 x 16, cells ``arch:shape:
multi``):

* Mamba2's decode gathered in_proj's output whole on every ``model``
  rank and each slice of its conv output again, every FSDP-sharded
  vector was gathered at use though its product took the rank's slice of
  it, a row-parallel output was gathered over the FSDP axes before its
  sum over ``model`` and the greedy token's logits were gathered whole:
  zamba2 and rwkv6 long_500k's collective bytes (and their FLOPs and
  memory a device)."""

import json
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
CELLS = [("olmoe_1b_7b", "decode_32k"), ("deepseek_v3_671b", "decode_32k"),
         ("rwkv6_1p6b", "long_500k"), ("starcoder2_7b", "train_4k"),
         ("starcoder2_7b", "prefill_32k"), ("stablelm_12b", "decode_32k"),
         ("whisper_small", "train_4k"), ("gemma2_27b", "train_4k"),
         ("codeqwen15_7b", "decode_32k"), ("zamba2_2p7b", "prefill_32k"),
         ("zamba2_2p7b", "train_4k"), ("stablelm_12b", "prefill_32k"),
         ("whisper_small", "prefill_32k"), ("olmoe_1b_7b", "train_4k"),
         ("deepseek_v3_671b", "train_4k"), ("codeqwen15_7b", "prefill_32k"),
         ("gemma2_27b", "prefill_32k"), ("olmoe_1b_7b", "prefill_32k"),
         ("zamba2_2p7b", "long_500k")]
# batch-1 decode on both meshes (the multi-pod cells run besides CELLS)
LONG_DECODE = [("zamba2_2p7b", "long_500k"), ("rwkv6_1p6b", "long_500k")]
MULTI = [c + ("multi",) for c in LONG_DECODE]
MOE_DECODE = [("olmoe_1b_7b", "decode_32k"),
              ("deepseek_v3_671b", "decode_32k")]
GATHERED = [("zamba2_2p7b", "prefill_32k"), ("zamba2_2p7b", "train_4k"),
            ("stablelm_12b", "prefill_32k")]
PREFILL = [c for c in CELLS if c[1] == "prefill_32k"]
CONTEXT_PARALLEL = [("starcoder2_7b", "prefill_32k"),
                    ("whisper_small", "prefill_32k")]
TRAIN = [c for c in CELLS if c[1] == "train_4k"]
FLOPS_LIMIT = 1.10          # the port's FLOPs per device over the reference's
COLLECTIVE_LIMIT = 2.0      # its collective bytes, the MoE decode cells
GATHERED_LIMIT = 1.10       # its collective bytes, the cells that gathered
OUTPUT_LIMIT = 1.05         # a prefill's output bytes (logits and cache)
MEMORY_LIMIT = 1.10         # a train or prefill cell's bytes a device
CARD_GIB = 74.5             # an H100's 80 GB, in GiB
LOSS_SHARE = 0.01           # the loss's share of a train cell's collectives
DECODE_MEMORY_LIMIT = 1.0   # a batch-1 decode cell's bytes a device

REFERENCE = """
import os, sys
# the reference module's own device count, set before jax starts
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=512")
import jax
from jax.sharding import AxisType
_make_mesh = jax.make_mesh

def make_mesh(shape, axes, *args, **kwargs):
    kwargs.setdefault("axis_types", (AxisType.Auto,) * len(shape))
    return _make_mesh(shape, axes, *args, **kwargs)

jax.make_mesh = make_mesh
from repro.launch import dryrun
out = sys.argv[1]
for cell in sys.argv[2:]:
    arch, shape, *mesh = cell.split(":")
    dryrun.run_cell(arch, shape, out_dir=out, multi_pod=mesh == ["multi"])
"""

PORT = """
import sys
from repro_torch.launch import dryrun
out = sys.argv[1]
for cell in sys.argv[2:]:
    arch, shape, *mesh = cell.split(":")
    dryrun.run_cell(arch, shape, out_dir=out, multi_pod=mesh == ["multi"])
"""


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    """Each cell's dry-run JSON: (the reference's, the port's)."""
    tmp = tmp_path_factory.mktemp("dryrun_parity")
    cells = [":".join(c) for c in CELLS + MULTI]
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
           "JAX_PLATFORMS": "cpu"}
    # the port's cells in two processes, beside the reference's one
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

    def load(name, arch, shape, *mesh):
        mp = "_mp" if mesh else ""
        d = json.loads((tmp / name / f"{arch}_{shape}{mp}.json").read_text())
        assert d["status"] == "ok", (name, arch, shape, mesh, d.get("error"))
        return d
    return {cell: (load("ref", *cell), load("port", *cell))
            for cell in CELLS + MULTI}


@pytest.fixture(scope="module")
def grids(cells):
    """Each cell's rooflines: (the reference's, the port's)."""
    return {cell: (ref["roofline"], port["roofline"])
            for cell, (ref, port) in cells.items()}


@pytest.mark.parametrize("cell", CELLS, ids=lambda c: f"{c[0]}-{c[1]}")
def test_flops_per_device_within_reference(grids, cell):
    ref, port = grids[cell]
    ratio = port["flops_per_device"] / ref["flops_per_device"]
    assert ratio <= FLOPS_LIMIT, (cell, ratio)


@pytest.mark.parametrize("cell", MOE_DECODE, ids=lambda c: c[0])
def test_moe_decode_collective_bytes_within_reference(grids, cell):
    ref, port = grids[cell]
    ratio = (port["collective_bytes_per_device"]
             / ref["collective_bytes_per_device"])
    assert ratio <= COLLECTIVE_LIMIT, (cell, ratio)


@pytest.mark.parametrize("cell", GATHERED, ids=lambda c: f"{c[0]}-{c[1]}")
def test_collective_bytes_within_reference(grids, cell):
    ref, port = grids[cell]
    ratio = (port["collective_bytes_per_device"]
             / ref["collective_bytes_per_device"])
    assert ratio <= GATHERED_LIMIT, (cell, ratio)


@pytest.mark.parametrize("cell", LONG_DECODE + MULTI, ids="-".join)
def test_long_decode_collective_bytes_within_reference(grids, cell):
    """A decode step at batch 1 moves the token, not the weights, and
    each collective only what a rank lacks: in_proj's column shards and
    the conv's channel shards realigned to Mamba2's heads, every
    FSDP-sharded vector used where it lies, a row-parallel output summed
    on its shard before it is gathered, the greedy token's argmax taken
    on each vocab shard."""
    ref, port = grids[cell]
    ratio = (port["collective_bytes_per_device"]
             / ref["collective_bytes_per_device"])
    assert ratio <= GATHERED_LIMIT, (cell, ratio)


@pytest.mark.parametrize("cell", MULTI, ids="-".join)
def test_multi_pod_decode_flops_within_reference(grids, cell):
    ref, port = grids[cell]
    ratio = port["flops_per_device"] / ref["flops_per_device"]
    assert ratio <= FLOPS_LIMIT, (cell, ratio)


@pytest.mark.parametrize("cell", LONG_DECODE + MULTI, ids="-".join)
def test_long_decode_memory_within_reference(cells, cell):
    ratio = _memory_ratio(cells, cell)
    assert ratio <= DECODE_MEMORY_LIMIT, (cell, ratio)


@pytest.mark.parametrize("cell", PREFILL, ids=lambda c: c[0])
def test_prefill_outputs_in_the_decode_layout(cells, cell):
    """The prefill's cache and last logits come out laid out as decode
    reads them, as the reference pins them: no more bytes a device."""
    ref, port = cells[cell]
    ratio = port["memory"]["output_bytes"] / ref["memory"]["output_bytes"]
    assert ratio <= OUTPUT_LIMIT, (cell, ratio)


@pytest.mark.parametrize("cell", CONTEXT_PARALLEL, ids=lambda c: c[0])
def test_busiest_rank_counted(cells, cell):
    """Causal context parallelism: the last ``model`` position scores more
    pairs than rank 0, and the cell's FLOPs are its count, within the
    reference's per-device count."""
    ref, port = cells[cell]
    ranks = {int(r): c["flops"] for r, c in port["ranks"].items()}
    assert set(ranks) == {0, 15}
    assert ranks[15] > ranks[0]
    assert port["roofline"]["flops_per_device"] == ranks[15]
    ratio = ranks[15] / ref["roofline"]["flops_per_device"]
    assert ratio <= FLOPS_LIMIT, (cell, ratio)


def _memory_ratio(cells, cell) -> float:
    ref, port = cells[cell]
    return (port["memory"]["per_device_total_gib"]
            / ref["memory"]["per_device_total_gib"])


@pytest.mark.parametrize("cell", TRAIN, ids=lambda c: c[0])
def test_train_memory_within_reference(cells, cell):
    """A train step holds no more bytes a device than the reference's
    (the loss no longer gathers the batch's f32 logits), and fits the card
    where the reference's does."""
    ratio = _memory_ratio(cells, cell)
    assert ratio <= MEMORY_LIMIT, (cell, ratio)
    ref, port = cells[cell]
    if ref["memory"]["per_device_total_gib"] <= CARD_GIB:
        assert port["memory"]["per_device_total_gib"] <= CARD_GIB, cell


def _loss_lines():
    """The source lines of the loss: ``cross_entropy`` and what it calls
    under a mesh, and the MTP head's logits and loss."""
    import inspect
    from repro_torch.train import train_step as ts
    lines = set()
    for fn in (ts.cross_entropy, ts._cross_entropy_sharded,
               ts._VocabParallelCE, ts._mtp_head_loss):
        src, first = inspect.getsourcelines(fn)
        lines.update(range(first, first + len(src)))
    return {f"repro_torch/train/train_step.py:{n}" for n in lines}


@pytest.mark.parametrize("cell", TRAIN, ids=lambda c: c[0])
def test_loss_moves_rows_only(cells, cell):
    """The loss's collectives carry (B_local, S) rows, not vocab-wide or
    batch-wide logits: a sliver of the cell's collective bytes."""
    _, port = cells[cell]
    lines = _loss_lines()
    share = sum(t["share"] for t in port["top_collectives"]
                if t["source"] in lines)
    assert share < LOSS_SHARE, (cell, share, [
        t for t in port["top_collectives"] if t["source"] in lines][:5])


@pytest.mark.parametrize("cell", PREFILL, ids=lambda c: c[0])
def test_prefill_memory_within_reference(cells, cell):
    """A prefill holds its stacked cache once, one row chunk of f32 in its
    norms and the residual stream once (summed in place): no more bytes a
    device than the reference's."""
    ratio = _memory_ratio(cells, cell)
    assert ratio <= MEMORY_LIMIT, (cell, ratio)


@pytest.mark.parametrize("cell", CELLS, ids=lambda c: f"{c[0]}-{c[1]}")
def test_top_live_splits_the_peak(cells, cell):
    """Each cell's ``top_live`` splits its peak of live bytes by source
    line, pass and dtype: the shares sum to one, and each rank has its
    own."""
    _, port = cells[cell]
    live = port["top_live"]
    assert live and abs(sum(t["share"] for t in live) - 1) < 1e-9
    assert all(set(t) == {"source", "pass", "dtype", "bytes", "share"}
               for t in live)
    assert all(r["top_live"] for r in port["ranks"].values())


def _grid_table(ref_dir: Path, port_dir: Path, before=None) -> str:
    """A markdown table, an architecture a row and a shape a column: each
    cell's FLOPs (F), collective bytes (C, beside the reference's in GB),
    output bytes (O) and memory (M, ``per_device_total_gib``, beside the
    reference's in GiB and followed by the port's first ``top_live``
    entry: source line, pass, dtype, GiB) a device, the port's over the
    reference's (``before -> now`` with an earlier port grid); ``SKIP``
    where the reference skips the cell, ``n/a`` where a port grid lacks
    it."""
    from repro_torch.configs.base import SHAPES
    from repro_torch.configs.registry import ARCHS

    def load(d, name):
        f = Path(d) / name
        return json.loads(f.read_text()) if f.exists() else None

    rows = ["| arch | " + " | ".join(SHAPES) + " |",
            "|---|" + "---|" * len(SHAPES)]
    for arch in ARCHS:
        cols = []
        for shape in SHAPES:
            name = f"{arch}_{shape}.json"
            ref = load(ref_dir, name)
            ports = [load(d, name) for d in ([before] if before else [])
                     + [port_dir]]
            if ref is None or ref.get("status") != "ok":
                cols.append("SKIP")
                continue
            if any(p is None or p.get("status") != "ok" for p in ports):
                cols.append("n/a")
                continue
            cell = []
            for tag, key, part in (
                    ("F", "flops_per_device", "roofline"),
                    ("C", "collective_bytes_per_device", "roofline"),
                    ("O", "output_bytes", "memory"),
                    ("M", "per_device_total_gib", "memory")):
                want = ref[part][key]
                got = " -> ".join(f"{p[part][key] / want:.2f}" for p in ports)
                if tag == "C":
                    cell.append(f"C {want / 1e9:.4g} GB {got}")
                elif tag == "M":
                    top = ports[-1]["top_live"][0]
                    cell.append(
                        f"M {want:.2f} GiB {got} "
                        f"(`{top['source'].split('repro_torch/')[-1]}` "
                        f"{top['pass'][0]} {top['dtype']} "
                        f"{top['bytes'] / 2**30:.2f})")
                else:
                    cell.append(f"{tag} {got}")
            cols.append("; ".join(cell))
        rows.append(f"| {arch} | " + " | ".join(cols) + " |")
    return "\n".join(rows)


def main(argv=None) -> int:
    """Both packages' single-pod dry-run grids, and the table of the
    port's counts over the reference's::

        PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_dryrun_parity.py OUT [--before DIR]

    runs the reference's grid into OUT/ref and the port's into OUT/port
    (``--all``, each in a subprocess as the tests run them) unless a grid
    is there already; with ``--before``, a port grid of an earlier commit
    (its ``repro_torch.launch.dryrun --all --out DIR``) is shown beside."""
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("out")
    ap.add_argument("--before", default=None)
    args = ap.parse_args(argv)
    out = Path(args.out)
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
           "JAX_PLATFORMS": "cpu"}
    from repro_torch.configs.base import SHAPES
    from repro_torch.configs.registry import ARCHS
    cells = [f"{a}:{s}" for a in ARCHS for s in SHAPES]
    for name, code in (("ref", REFERENCE), ("port", PORT)):
        if not (out / name).exists():
            subprocess.run([sys.executable, "-c", textwrap.dedent(code),
                            str(out / name)] + cells, env=env, cwd=ROOT,
                           check=True)
    print(_grid_table(out / "ref", out / "port",
                      Path(args.before) if args.before else None))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
