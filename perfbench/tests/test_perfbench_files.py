"""Every configuration, cell and metric that BENCHMARK.json names loads by
name, and the files agree with it."""

import json
import re

import pytest

from perfbench.bench import spec
from perfbench.traffic.mix import Mix

BENCH = spec.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
CONFIGS = [c["name"] for c in BENCH["configs"]]


@pytest.mark.parametrize("name", CONFIGS)
def test_config_loads(name):
    c = spec.config(name)
    entry = next(e for e in BENCH["configs"] if e["name"] == name)
    assert c["name"] == name and c["source"] == entry["source"]
    assert c["reduced"] == entry["reduced"] == []
    assert entry["file"] == f"perfbench/configs/{name}.json"
    m = c["model"]
    assert m["d_model"] == m["n_heads"] * m["head_dim"]
    lim = c["check"]
    assert lim["mean_logit_gap"] > 0
    assert lim["min_tokens"] > 0 and lim["sample"] >= 1


@pytest.mark.parametrize("name", CELLS)
def test_cell_loads(name):
    w = spec.workload(name)
    entry = spec.cell_entry(BENCH, name)
    for k in ("name", "config", "traffic", "chips", "why"):
        assert w[k] == entry[k], k
    cfg = spec.config(w["config"])
    mix = Mix(w["mix"], cfg["model"]["vocab"], seed=2 ** 31 + 11)
    # no request passes the configuration's positions
    assert mix.longest() <= cfg["max_positions"]
    p, n = mix.request(0, 0)
    assert len(p) >= 1 and n >= 1 and max(p) < cfg["model"]["vocab"]


@pytest.mark.parametrize("section,kind", [("end_to_end", "e2e"),
                                          ("per_layer", "metrics")])
def test_metric_readers_load(section, kind):
    for m in BENCH[section]:
        if m["name"] == "setup_s":
            continue
        assert callable(spec.reader(kind, m["name"]))
        assert not (spec.ROOT / ("metrics" if kind == "e2e" else "e2e")
                    / f"{m['name']}.py").exists()


def test_benchmark_shape():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    assert {"out_tok_s", "tpot_p50_s", "setup_s", "ttft_p50_s"} <= set(names)
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    assert all(w["chips"] == 1 for w in BENCH["workloads"])
    assert len(json.dumps(BENCH)) < 64 * 1024


NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
KEYS = {
    "configs": ({"name", "source", "file", "reduced", "why"}, set()),
    "workloads": ({"name", "config", "traffic", "chips", "why"}, set()),
    "end_to_end": ({"name", "unit", "better", "bound", "source"},
                   {"workloads"}),
    "per_layer": ({"name", "unit", "better", "source", "layer", "moves"},
                  {"workloads"}),
}


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and not set(s) & set("\n\r\t")


def test_benchmark_form():
    """Every entry has exactly the keys the benchmark's file format allows,
    and every name, unit and line keeps to its limits."""
    assert set(BENCH) == {"command", "paths", "run_seconds", *KEYS}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert 1 <= len(BENCH["command"]) <= 32 and all(map(_line, BENCH["command"]))
    for section, (needed, optional) in KEYS.items():
        for e in BENCH[section]:
            assert needed <= set(e) <= needed | optional, (section, e["name"])
            assert NAME.fullmatch(e["name"]), e["name"]
            for k in ("why", "layer", "source"):
                if k in e:
                    assert _line(e[k]), (e["name"], k)
            if "unit" in e:
                assert UNIT.fullmatch(e["unit"]), e["name"]
                assert e["better"] in ("lower", "higher")
    for c in BENCH["configs"]:
        assert all(NAME.fullmatch(k) for k in c["reduced"])
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])
    for w in BENCH["workloads"]:
        assert NAME.fullmatch(w["config"]) and NAME.fullmatch(w["traffic"])
