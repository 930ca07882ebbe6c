"""On the card: the fp8 control, put in the program's place at a cell's
own size (``--control 1``), reads above the limit that the program's runs
stay under, so the run reads ``correct`` false."""

import json
import subprocess
import sys

import pytest
import torch

from perfbench.bench.spec import CHECKOUT


@pytest.mark.cuda
@pytest.mark.parametrize("cell,seed", [("starcoder2-7b.long-prompt", 7001),
                                       ("starcoder2-7b.long-prompt", 7002),
                                       ("starcoder2-7b.long-prompt", 7003)])
def test_the_fp8_control_fails_the_limit_on_the_card(cell, seed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    r = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        cell, "--seed", str(seed), "--seconds", "10",
                        "--trace", "0", "--control", "1"],
                       capture_output=True, text=True, timeout=900,
                       cwd=CHECKOUT)
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    print(cell, seed, json.dumps(out["checks"]))
    gap = out["checks"]["mean_logit_gap"]
    assert gap["value"] > gap["limit"]
    assert out["correct"] is False
