"""The port's MoE layer (``models/moe.py``, dense dispatch) against the
reference's ``apply_moe``, on the CPU.

Same numpy-seeded activations, the reference's weights bridged 1:1, on
the olmoe smoke config (E=8, top-2) and variants of it: capacity factors
4.0 (nothing dropped), 1.0 and 0.5 (over-full experts drop tokens), the
decode shapes T=1 and T=8 (C = T: every expert sees every token), one
shared expert, and GELU experts.

Tolerances (max |diff| over every element):

* f32: 1e-4 on the layer's output, 1e-5 on ``moe_aux`` and ``moe_z``;
* bf16: max(5e-2, 2 e), e the reference's own bf16-vs-f32 distance on the
  same weights and inputs (the repo's rule for bf16, ``PERF.md`` §6).

Which (expert, token) pairs an over-full expert keeps, and so which it
drops, must be the reference's exactly: both select with ties broken
toward the lower index.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_config as j_smoke
from repro.models import layers as jL
from repro.models import moe as jmoe
from repro_torch.bridge import params_from_jax
from repro_torch.configs.registry import get_smoke_config
from repro_torch.models import layers as L
from repro_torch.models import moe

F32_TOL = 1e-4
AUX_TOL = 1e-5
BF16_TOL = 5e-2

#: (name, (B, S), MoE overrides, act)
CASES = [
    ("cf4", (2, 12), dict(capacity_factor=4.0), "silu"),
    ("cf1", (2, 12), dict(capacity_factor=1.0), "silu"),
    ("cf0.5", (4, 16), dict(capacity_factor=0.5), "silu"),
    ("decode-T1", (1, 1), {}, "silu"),
    ("decode-T8", (8, 1), {}, "silu"),
    ("shared", (2, 12), dict(n_shared=1, capacity_factor=1.0), "silu"),
    ("gelu", (2, 12), dict(capacity_factor=1.0), "gelu"),
    ("gelu-shared", (2, 12), dict(n_shared=1), "gelu"),
]


def _cfgs(overrides, act, dtype):
    out = []
    for base in (j_smoke("olmoe_1b_7b"), get_smoke_config("olmoe_1b_7b")):
        m = dataclasses.replace(base.moe, **overrides)
        out.append(dataclasses.replace(base, moe=m, act=act, dtype=dtype))
    return out


def _setup(case, dtype):
    _, shape, overrides, act = case
    jcfg, tcfg = _cfgs(overrides, act, dtype)
    jp = jL.materialize(jmoe.moe_specs(jcfg), jax.random.PRNGKey(3))
    tp = params_from_jax(jax.device_get(jp))
    x = np.random.default_rng(7).standard_normal(
        shape + (jcfg.d_model,)).astype(np.float32)
    return jcfg, tcfg, jp, tp, x


def _jax_moe(jcfg, jp, x, dtype):
    out, aux = jmoe.apply_moe(jp, jnp.asarray(x, dtype), cfg=jcfg)
    return (np.asarray(out, np.float32),
            {k: float(v) for k, v in aux.items()})


def _port_moe(tcfg, tp, x, dtype):
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    out, aux = moe.apply_moe(tp, torch.from_numpy(x).to(dt), cfg=tcfg)
    return out.float().numpy(), {k: float(v) for k, v in aux.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_apply_moe_matches_reference(case, dtype):
    jcfg, tcfg, jp, tp, x = _setup(case, dtype)
    want, jaux = _jax_moe(jcfg, jp, x, dtype)
    got, taux = _port_moe(tcfg, tp, x, dtype)
    assert got.shape == want.shape == x.shape
    err = float(np.abs(got - want).max())
    if dtype == "float32":
        tol = F32_TOL
        for k in ("moe_aux", "moe_z"):
            assert abs(taux[k] - jaux[k]) <= AUX_TOL, (k, taux[k], jaux[k])
    else:
        ref32, _ = _jax_moe(jcfg, jp, x, "float32")
        tol = max(BF16_TOL, 2 * float(np.abs(want - ref32).max()))
    assert err <= tol, f"{case[0]} {dtype}: {err} > {tol}"


def _pairs(top_i, cw, ci):
    routed = {(int(e), t) for t, row in enumerate(top_i) for e in row}
    kept = {(e, int(ci[e, c])) for e in range(cw.shape[0])
            for c in range(cw.shape[1]) if cw[e, c] > 0}
    return routed, kept


@pytest.mark.parametrize("case", [c for c in CASES if c[0] != "decode-T1"],
                         ids=[c[0] for c in CASES if c[0] != "decode-T1"])
def test_kept_and_dropped_pairs_match_reference(case):
    """f32: the routed (expert, token) pairs, the capacity, and the pairs
    each expert keeps are the reference's; at capacity 0.5 some pairs are
    dropped, and the same ones."""
    jcfg, tcfg, jp, tp, x = _setup(case, "float32")
    xt = x.reshape(-1, x.shape[-1])
    T, D = xt.shape
    jcw, jci, jC, _ = jmoe._moe_local(jp, jnp.asarray(xt), jcfg, T, D)
    top_i, cw, ci, _ = moe.route(tp, torch.from_numpy(xt), tcfg)
    assert ci.shape == (jcfg.moe.n_experts, jC)
    assert moe.capacity(tcfg, T) == jC
    gates = jax.nn.softmax(jnp.asarray(xt) @ jp["router"], axis=-1)
    j_top_i = np.asarray(jax.lax.top_k(gates, jcfg.moe.top_k)[1])
    np.testing.assert_array_equal(top_i.numpy(), j_top_i)
    j_routed, j_kept = _pairs(j_top_i, np.asarray(jcw), np.asarray(jci))
    routed, kept = _pairs(top_i.numpy(), cw.numpy(), ci.numpy())
    assert routed == j_routed and kept == j_kept
    assert kept <= routed
    if case[0] == "cf0.5":
        assert routed - kept, "capacity 0.5 should drop tokens"


def test_ties_break_toward_the_lower_index():
    """top_k=1: every kept weight is exactly 1.0, so an over-full expert
    chooses among equal scores -- by token index, as jax.lax.top_k."""
    jcfg, tcfg = _cfgs(dict(top_k=1, capacity_factor=0.5), "silu", "float32")
    jp = jL.materialize(jmoe.moe_specs(jcfg), jax.random.PRNGKey(4))
    tp = params_from_jax(jax.device_get(jp))
    xt = np.random.default_rng(8).standard_normal(
        (40, jcfg.d_model)).astype(np.float32)
    _, jci, _, _ = jmoe._moe_local(jp, jnp.asarray(xt), jcfg, 40,
                                   jcfg.d_model)
    _, cw, ci, _ = moe.route(tp, torch.from_numpy(xt), tcfg)
    assert set(cw.unique().tolist()) <= {0.0, 1.0}
    np.testing.assert_array_equal(ci.numpy(), np.asarray(jci))
    got, _ = _port_moe(tcfg, tp, xt[None], "float32")
    want, _ = _jax_moe(jcfg, jp, xt[None], "float32")
    assert float(np.abs(got - want).max()) <= F32_TOL


def test_specs_and_dtypes_follow_the_reference():
    """The router is f32 and the experts (E, D, F) / (E, F, D) bf16, with
    the reference's stacked-spec init rule (fan_in = E); the bridge keeps
    both dtypes."""
    cfg = get_smoke_config("olmoe_1b_7b")
    specs = moe.moe_specs(cfg)
    E, D, F = cfg.moe.n_experts, cfg.d_model, cfg.moe.d_ff
    assert specs["router"].dtype == "float32"
    assert specs["wi_gate"].shape == specs["wi_up"].shape == (E, D, F)
    assert specs["wo"].shape == (E, F, D)
    jp = jL.materialize(jmoe.moe_specs(j_smoke("olmoe_1b_7b")),
                        jax.random.PRNGKey(5))
    tp = params_from_jax(jax.device_get(jp))
    assert tp["router"].dtype == torch.float32
    assert tp["wi_gate"].dtype == torch.bfloat16
    p = L.materialize(specs, torch.Generator().manual_seed(0), "cpu")
    assert abs(float(p["wi_gate"].float().std()) - E ** -0.5) < 0.01
    assert abs(float(p["router"].std()) - D ** -0.5) < 0.01
