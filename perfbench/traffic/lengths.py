"""Length distributions: the port's ``serve/loadgen.py::sample_length``,
kept here so that the yardstick does not move when the program does.

A spec is a plain dict: ``{"kind": "fixed", "value": v}``;
``{"kind": "lognormal", "median": m, "sigma": s, "lo": a, "hi": b}``
(``mu`` may stand for ``log(median)``), a draw clipped into ``[lo, hi]``;
``{"kind": "zipf", "alpha": a, "lo": a, "hi": b}``.
"""

from __future__ import annotations

import math
import random
from typing import Dict


def sample_length(dist: Dict, rng: random.Random) -> int:
    kind = dist.get("kind", "fixed")
    if kind == "fixed":
        return int(dist["value"])
    if kind == "lognormal":
        mu = float(dist["mu"]) if "mu" in dist else math.log(dist["median"])
        v = rng.lognormvariate(mu, float(dist["sigma"]))
        return int(min(max(round(v), dist["lo"]), dist["hi"]))
    if kind == "zipf":
        lo, hi, alpha = int(dist["lo"]), int(dist["hi"]), float(dist["alpha"])
        weights = [1.0 / (k ** alpha) for k in range(1, hi - lo + 2)]
        u = rng.random() * sum(weights)
        acc = 0.0
        for i, w in enumerate(weights):
            acc += w
            if u <= acc:
                return lo + i
        return hi
    raise ValueError(f"unknown length distribution {kind!r}")
