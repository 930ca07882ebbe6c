"""Whole runs of ``run.py`` on the CPU at the smoke sizes (the command
line itself refuses to run without CUDA), the import check, and runs with
the timed path broken underneath, each of which must read ``correct``
false."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from perfbench.bench import cell
from perfbench.bench.spec import CHECKOUT

DATA = Path(__file__).with_name("data")
SEED = 2 ** 31 + 17


def _main(workload, config, trace, seed=SEED):
    from perfbench import run
    wl = json.loads((DATA / f"{workload}.json").read_text())
    cfg = json.loads((DATA / f"{config}.json").read_text())
    return run.main(["--workload", "starcoder2-7b.long-prompt", "--seed",
                     str(seed), "--seconds", "1.5", "--trace", str(trace)],
                    device="cpu", workload=wl, config=cfg)


def _last_line(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("workload,config,trace", [
    ("smoke.long-prompt", "starcoder2-smoke", 0),
    ("smoke.long-prompt", "stablelm-smoke", 1),
    ("smoke.repo-qa", "starcoder2-smoke", 1),
])
def test_a_whole_run_prints_the_contracts_last_line(capsys, workload,
                                                    config, trace):
    assert _main(workload, config, trace) == 0
    out = _last_line(capsys)
    assert list(out)[-1] == "checks"
    for k in ("correct", "attempted", "failed", "metrics", "device"):
        assert k in out
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] > 0
    names = set(out["metrics"])
    if trace:
        assert {"decode_step_ms", "decode_batch_mean", "queue_wait_mean_s",
                "reclaim_ms_per_s", "prefill_chunk_ms", "ttft_p50_s"} <= names
        # no device: no device metric
        assert not {"device_idle_share", "mfu.prefill"} & names
        if workload == "smoke.repo-qa":
            assert out["metrics"]["prefix_hit_share"]["value"] > 50
    else:
        assert names == {"out_tok_s", "tpot_p50_s", "setup_s"}
        assert all(m["value"] > 0 for m in out["metrics"].values())
    assert out["checks"]["mean_logit_gap"]["value"] <= \
        out["checks"]["mean_logit_gap"]["limit"]


def _token_altered(monkeypatch):
    import repro_torch.serve.paged_model as pm
    orig = pm.paged_decode_step

    def step(*a, **kw):
        return torch.roll(orig(*a, **kw), 1, dims=-1)
    monkeypatch.setattr(pm, "paged_decode_step", step)


def _state_unchanged(monkeypatch):
    # the layer's new K/V rows never reach the pages
    import repro_torch.kernels.ops as kops
    orig = kops.paged_attention

    def attend(*a, write=None, **kw):
        if write is not None:
            index, k, v, lo, base = write
            write = (index, torch.zeros_like(k), torch.zeros_like(v), lo, base)
        return orig(*a, write=write, **kw)
    monkeypatch.setattr(kops, "paged_attention", attend)


def _half_batch(monkeypatch):
    # a decode step computes the first half of its rows and hands the
    # rest the mean of those
    import repro_torch.serve.paged_model as pm
    orig = pm.paged_decode_step

    def step(params, cfg, store, blocks, lens, last, **kw):
        n = len(lens)
        if n < 2:
            return orig(params, cfg, store, blocks, lens, last, **kw)
        h = n // 2
        top = orig(params, cfg, store, blocks[:h], lens[:h], last[:h], **kw)
        return torch.cat([top, top.mean(0, keepdim=True).expand(n - h, -1)])
    monkeypatch.setattr(pm, "paged_decode_step", step)


@pytest.mark.parametrize("fault", [_token_altered, _state_unchanged,
                                   _half_batch])
def test_a_broken_timed_path_reads_not_correct(capsys, monkeypatch, fault):
    fault(monkeypatch)
    assert _main("smoke.long-prompt", "starcoder2-smoke", 0) == 0
    assert _last_line(capsys)["correct"] is False


def test_forbidden_modules_compare_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_x", sys)
    assert "repro_torch_x" not in cell.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.models", sys)
    assert "repro.models" in cell.forbidden_modules()


def test_no_jax_in_a_run_and_no_result_without_cuda():
    """In a fresh interpreter: a CPU run loads neither JAX nor the JAX
    package; the command line without a card exits non-zero, printing no
    result."""
    code = (
        "import sys, json\n"
        f"sys.path[:0] = [{str(CHECKOUT / 'src')!r}, {str(CHECKOUT)!r}]\n"
        "from perfbench import run\n"
        "from perfbench.bench.cell import forbidden_modules\n"
        f"d = {str(DATA)!r}\n"
        "wl = json.load(open(d + '/smoke.long-prompt.json'))\n"
        "cfg = json.load(open(d + '/starcoder2-smoke.json'))\n"
        "rc = run.main(['--workload', 'x', '--seed', '5', '--seconds', '1',"
        " '--trace', '0'], device='cpu', workload=wl, config=cfg)\n"
        "assert rc == 0 and not forbidden_modules(), forbidden_modules()\n"
        "print('IMPORTS-OK', sorted(m for m in sys.modules"
        " if m.split('.')[0] in ('jax', 'repro')))\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=CHECKOUT)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "IMPORTS-OK []" in r.stdout
    if torch.cuda.is_available():
        return
    r = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        "starcoder2-7b.long-prompt", "--seed", "1",
                        "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, timeout=300,
                       cwd=CHECKOUT)
    assert r.returncode != 0 and r.stdout.strip() == ""
