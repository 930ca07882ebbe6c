"""Build the CUDA kernels of ``csrc/`` at first use and load them.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for ``sm_90a`` into its own shared library, which :func:`load` opens with
ctypes.  Libraries go to ``build/repro_torch_kernels/`` at the root of the
checkout (listed in ``.gitignore``), named after a hash of the source and
the flags, so an edited source is rebuilt and an unchanged one is reused.
:func:`build_all` starts one ``nvcc`` per source, all at once.

Nothing here runs at import time, and nothing falls back: a missing
``nvcc`` or a failed compile raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
KERNELS = ("paged_attention", "paged_scatter")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: Dict[str, ctypes.PyDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                           "source on the machine with the card")
    return path


def _lib_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _compile(names: Iterable[str]) -> None:
    """Run one nvcc per missing library, all started together."""
    todo = [(n, _lib_path(n)) for n in names if not _lib_path(n).exists()]
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name, out in todo:
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, out, tmp, p in procs:
        log, _ = p.communicate()
        if p.returncode != 0:
            failed.append(f"{name}: nvcc exited {p.returncode}\n{log}")
        else:
            os.replace(tmp, out)        # atomic: a reader never sees half
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))


def build_all() -> float:
    """Compile every kernel that is not built yet; returns the seconds it
    took (compile included, load excluded)."""
    t0 = time.monotonic()
    with _lock:
        _compile(KERNELS)
    return time.monotonic() - t0


def load(name: str) -> ctypes.PyDLL:
    """The loaded library of kernel ``name``, built first if needed.

    Loaded as a ``PyDLL``: its calls keep the GIL.  A launch takes a few
    microseconds, while a ``CDLL`` call releases the GIL and must win it
    back from the other serving threads -- up to a switch interval (5 ms)
    per launch, two launches per layer."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _compile([name])
            lib = ctypes.PyDLL(str(_lib_path(name)))
            _libs[name] = lib
        return lib
