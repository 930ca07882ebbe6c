"""Run one cell of the port's serving benchmark.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the numbers compared by the output check on standard error, last,
and as its last line of standard output one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``.  Exits non-zero, printing no result,
without a CUDA device, with fewer than the cell asks for, or when JAX or
the JAX package (``repro``) was loaded.
"""

from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parents[1]


def _paths() -> None:
    for p in (CHECKOUT / "src", CHECKOUT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))


def main(argv=None, *, device: str = "cuda", workload: dict = None,
         config: dict = None) -> int:
    """``device``, ``workload`` and ``config`` are for the CPU tests only:
    the command line runs on CUDA with the cell's own files."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0,
                    help="the fp8 control in the program's place: its "
                    "tokens are compared instead of the served ones")
    args = ap.parse_args(argv)
    _paths()
    import torch

    from perfbench.bench import cell, spec

    bench = spec.benchmark()
    entry = spec.cell_entry(bench, args.workload)
    wl = workload or spec.workload(args.workload)
    chips = entry["chips"] if entry else wl.get("chips", 1)
    if device == "cuda" and (not torch.cuda.is_available()
                             or torch.cuda.device_count() < chips):
        print(f"perfbench: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " available", file=sys.stderr)
        return 2
    cfg_spec = config or spec.config(wl["config"])
    result, checks = cell.run_cell(
        args.workload, wl, cfg_spec, bench, seed=args.seed,
        seconds=args.seconds, trace=bool(args.trace), device=device,
        t_start=T_START, control=bool(args.control))
    bad = cell.forbidden_modules()
    if bad:
        print(f"perfbench: JAX or the JAX package was loaded: {bad}",
              file=sys.stderr)
        return 3
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    for n, v, lim in checks:
        print(f"check {n}: {v!r} (limit {lim!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
