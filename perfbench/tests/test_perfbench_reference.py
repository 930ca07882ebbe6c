"""The plain reference against the port's own plain path (``apply_model``
in float32 on the CPU) at the smoke sizes, on the benchmark's weights; and
the fp8 control departing from it."""

import json
from pathlib import Path

import pytest
import torch

from perfbench.bench import check
from perfbench.bench.cell import port_config
from perfbench.bench.weights import make_params, same_layout
from perfbench.reference.model import Reference

DATA = Path(__file__).with_name("data")


def _setup(name):
    cfg_spec = json.loads((DATA / f"{name}.json").read_text())
    from repro_torch.models.model import abstract_params
    cfg = port_config(cfg_spec)
    params = make_params(cfg_spec["model"], seed=2 ** 32 + 3, device="cpu")
    same_layout(params, abstract_params(cfg))
    return cfg_spec["model"], cfg, params


@pytest.mark.parametrize("name", ["starcoder2-smoke", "stablelm-smoke"])
def test_reference_matches_the_ports_plain_forward(name):
    from repro_torch.models.model import apply_model
    model, cfg, params = _setup(name)
    toks = torch.randint(0, model["vocab"], (1, 40),
                         generator=torch.Generator().manual_seed(5))
    port, _, _ = apply_model(params, toks, cfg=cfg.scaled(dtype="float32"),
                             mode="train")
    ref = Reference(model, params).logits([toks[0].tolist()], [0])[0]
    torch.testing.assert_close(ref, port[0].float()[:, :model["vocab"]],
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", ["starcoder2-smoke", "stablelm-smoke"])
def test_the_fp8_control_departs_further_than_bf16(name):
    from repro_torch.models.model import apply_model
    model, cfg, params = _setup(name)
    toks = torch.randint(0, model["vocab"], (1, 64),
                         generator=torch.Generator().manual_seed(7))
    ref = Reference(model, params).logits([toks[0].tolist()], [0])[0]
    ctl = Reference(model, params, "fp8").logits([toks[0].tolist()], [0])[0]
    bf16, _, _ = apply_model(params, toks, cfg=cfg, mode="train")
    err_bf16 = (bf16[0].float()[:, :model["vocab"]] - ref).abs().max()
    err_fp8 = (ctl - ref).abs().max()
    assert err_fp8 > 3 * err_bf16


def test_served_sequence_feeds_the_last_prompt_token_again():
    seq, start = check.served_sequence([5, 6, 7], [1, 2, 3])
    assert seq == [5, 6, 7, 7, 1, 2] and start == 3


def test_gaps_and_sample():
    lg = torch.tensor([[0.0, 2.0, 1.0], [3.0, 0.5, 0.0]])
    assert check.gaps(lg, [1, 1]).tolist() == [0.0, 2.5]
    fin = [([1] * n, [2] * 3) for n in (4, 9, 2, 5)]
    s = check.sample(fin, 2, seed=2 ** 40)
    assert len(s) == 2 and len(s[0][0]) == 9
