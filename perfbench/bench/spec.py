"""Find every piece of a cell by its name.

``BENCHMARK.json`` names the cells and metrics; each configuration is
``configs/<name>.json``, each cell ``workloads/<name>.json``, each
end-to-end metric ``e2e/<name>.py`` and each per-layer metric
``metrics/<name>.py`` (a module with ``read(run) -> float | None``).  A
later change adds a configuration, a cell or a metric by adding files and
entries, never by editing one that is there.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional

ROOT = Path(__file__).resolve().parents[1]          # perfbench/
CHECKOUT = ROOT.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(CHECKOUT / "BENCHMARK.json")


def config(name: str) -> dict:
    return load_json(ROOT / "configs" / f"{name}.json")


def workload(name: str) -> dict:
    return load_json(ROOT / "workloads" / f"{name}.json")


def _module(path: Path):
    if not path.exists():
        raise FileNotFoundError(f"no reader at {path}")
    spec = importlib.util.spec_from_file_location(
        f"perfbench_reader_{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(kind: str, name: str) -> Callable:
    """``read`` of ``perfbench/<kind>/<name>.py`` (kind: e2e | metrics)."""
    return _module(ROOT / kind / f"{name}.py").read


def metrics_for(bench: dict, section: str, cell: str) -> List[dict]:
    """The metrics of ``section`` (end_to_end | per_layer) that ``cell``
    reports: those without a ``workloads`` key, and those that list it."""
    return [m for m in bench[section]
            if "workloads" not in m or cell in m["workloads"]]


def cell_entry(bench: dict, name: str) -> Optional[Dict]:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    return None
