"""The port stands alone: importing every module of ``repro_torch`` and
everything ``chip_smoke.py`` imports loads neither JAX nor the reference
package, and no source line of the port, of ``chip_smoke.py`` or of the
port's examples (``examples/*_torch.py``: ``train_tiny_lm_torch.py``,
``serve_paged_torch.py``, ``smr_demo_torch.py``, ``quickstart_torch.py``)
imports them.  The walk covers the distribution modules (``parallel/``,
``launch/mesh.py``, ``launch/dryrun.py``, ``roofline/``) by name too, and
imports each example twin as well."""

import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

PROBE = """
import importlib, pkgutil, sys
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
import chip_smoke
import importlib.util, pathlib
for path in sorted(pathlib.Path("examples").glob("*_torch.py")):
    spec = importlib.util.spec_from_file_location(path.stem, path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
want = ["repro_torch.parallel.sharding", "repro_torch.parallel.pipeline",
        "repro_torch.parallel.compression", "repro_torch.parallel.collectives",
        "repro_torch.launch.mesh", "repro_torch.launch.dryrun",
        "repro_torch.roofline.analysis", "repro_torch.roofline.op_stats"]
missing = [n for n in want if n not in sys.modules]
print("missing:", missing)
if missing:
    sys.exit(1)
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in ("jax", "jaxlib", "repro"))
print("loaded:", bad)
sys.exit(1 if bad else 0)
"""


def test_port_and_chip_smoke_import_no_jax_and_no_reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_port_sources_do_not_import_jax_or_reference():
    pat = re.compile(r"^\s*(import\s+(jax|jaxlib|repro)\b"
                     r"|from\s+(jax|jaxlib|repro)(\.|\s))", re.M)
    examples = sorted((ROOT / "examples").glob("*_torch.py"))
    assert {f.name for f in examples} >= {
        "train_tiny_lm_torch.py", "serve_paged_torch.py",
        "smr_demo_torch.py", "quickstart_torch.py"}
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"] + examples
    assert len(files) > 15
    hits = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
            for f in files for m in pat.finditer(f.read_text())]
    assert not hits, hits
