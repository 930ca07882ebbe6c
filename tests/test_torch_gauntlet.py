"""The port's robustness gauntlet (``core/gauntlet.py``) against the
reference package's.

A gauntlet row is a pure function of (scheme, backend, fault mode,
parameters, seed), so the two packages must give equal rows, key by key,
for every registered scheme (``HP-broken`` included) on both simulator
backends of the quick grid, and equal ``summarize`` headlines.  A
``Tracer`` handed to both records the same simulated-clock spans.

Then the scenarios of ``tests/test_gauntlet.py`` on the port: row
determinism, EBR's unbounded garbage under a stall against the robust
schemes, ping stall growing with signal delay, and crash recovery per
scheme.
"""

import functools

import pytest

import repro.core.gauntlet as j_gauntlet
import repro.obs as j_obs
from repro.core.smr.registry import SCHEMES as J_SCHEMES
from repro_torch.core.gauntlet import (FAULT_MODES, gauntlet_cell,
                                       run_gauntlet, summarize)
from repro_torch.core.smr.registry import SCHEMES
from repro_torch.obs import PID_SIM, Tracer

BACKENDS = ["gen", "vec"]
ALL = list(J_SCHEMES)
QUICK = dict(nthreads=4, duration=150_000.0)


@functools.lru_cache(maxsize=None)
def _grid(backend):
    """The quick grid over every scheme, in both packages."""
    want = j_gauntlet.run_gauntlet(schemes=ALL, backends=(backend,),
                                   quick=True)
    got = run_gauntlet(schemes=ALL, backends=(backend,), quick=True)
    return got, want


def test_the_port_holds_the_same_registry_and_modes():
    assert list(SCHEMES) == ALL and len(ALL) == 13 and "HP-broken" in ALL
    assert FAULT_MODES == j_gauntlet.FAULT_MODES


@pytest.mark.parametrize("scheme", ALL)
@pytest.mark.parametrize("backend", BACKENDS)
def test_gauntlet_rows_equal_reference(backend, scheme):
    got, want = _grid(backend)
    got = [r for r in got if r["scheme"] == scheme]
    want = [r for r in want if r["scheme"] == scheme]
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        assert g == w, {k: (g[k], w[k]) for k in g if g[k] != w[k]}


@pytest.mark.parametrize("backend", BACKENDS)
def test_summarize_equals_reference(backend):
    got, want = _grid(backend)
    assert len(got) == 52
    assert summarize(got) == j_gauntlet.summarize(want)
    # HP-broken trips on gen in every fault mode and is the only scheme to
    # trip; on vec none of its rows does (a property of the reference)
    uaf = sorted({r["scheme"] for r in got if r["uaf"]})
    assert uaf == (["HP-broken"] if backend == "gen" else [])
    if backend == "gen":
        assert all(r["uaf"] for r in got if r["scheme"] == "HP-broken")


@pytest.mark.parametrize("backend", BACKENDS)
def test_tracer_records_the_reference_sim_clock_spans(backend):
    def sim_events(tr):
        return [e for e in tr.to_dict()["traceEvents"]
                if e.get("pid") == PID_SIM]

    j_tr, t_tr = j_obs.Tracer(), Tracer()
    for fault, param in (("signal-delay", 20_000.0),
                         ("reader-crash", 45_000.0)):
        j_gauntlet.gauntlet_cell("HazardPtrPOP", backend, fault, param,
                                 tracer=j_tr, **QUICK)
        gauntlet_cell("HazardPtrPOP", backend, fault, param, tracer=t_tr,
                      **QUICK)
    got, want = sim_events(t_tr), sim_events(j_tr)
    assert sum(e["name"] == "ping_pass" for e in got) > 0
    assert got == want


@pytest.mark.parametrize("backend", BACKENDS)
def test_gauntlet_rows_deterministic(backend):
    schemes = ["EBR", "HazardPtrPOP", "Hyaline", "DEBRA+", "HP-broken"]
    a = run_gauntlet(schemes=schemes, backends=(backend,), quick=True)
    b = run_gauntlet(schemes=schemes, backends=(backend,), quick=True)
    assert a == b
    assert {r["fault_mode"] for r in a} == set(FAULT_MODES)


@pytest.mark.parametrize("backend", BACKENDS)
def test_ebr_unbounded_vs_robust_bounded_under_stall(backend):
    stall = QUICK["duration"] * 0.5
    ebr = gauntlet_cell("EBR", backend, "desched-stall", stall, **QUICK)
    assert ebr["garbage_peak"] > 500, "stall should pin EBR's epoch"
    for scheme in ("HP", "HazardPtrPOP", "EpochPOP", "Hyaline", "DEBRA+"):
        row = gauntlet_cell(scheme, backend, "desched-stall", stall, **QUICK)
        assert not row["uaf"]
        assert row["garbage_peak"] < 0.2 * ebr["garbage_peak"], \
            f"{scheme} peak {row['garbage_peak']} vs EBR {ebr['garbage_peak']}"


@pytest.mark.parametrize("backend", BACKENDS)
def test_ping_stall_grows_with_signal_delay(backend):
    base = gauntlet_cell("HazardPtrPOP", backend, "signal-delay", 0.0,
                         **QUICK)
    slow = gauntlet_cell("HazardPtrPOP", backend, "signal-delay", 20_000.0,
                         **QUICK)
    assert base["max_ping_stall_s"] > 0, "POP reclaims must ping"
    # the injected delay (20k cycles = 20us at 1 GHz) lands in the stall
    assert slow["max_ping_stall_s"] >= base["max_ping_stall_s"] + 15e-6


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("scheme,recovers", [
    ("EBR", False),            # dead announcement pins the epoch forever
    ("NR", False),             # never reclaims anything by definition
    ("HazardPtrPOP", True),    # ping returns ESRCH -> scan proceeds
    ("DEBRA+", True),          # same, via the neutralizing fallback
    ("Hyaline", True),         # era skip stops feeding the dead slot
])
def test_crash_recovery_semantics(scheme, recovers, backend):
    crash_at = QUICK["duration"] * 0.3
    row = gauntlet_cell(scheme, backend, "reader-crash", crash_at, **QUICK)
    assert not row["uaf"]
    if recovers:
        assert row["recovery_s"] is not None, f"{scheme} never recovered"
        assert row["recovery_s"] < 1e-3
    else:
        assert row["recovery_s"] is None
