"""The port's dense model path against the reference's, on the CPU.

``apply_model`` in its three modes -- train-mode logits, prefill logits
and cache leaves, and decode logits after the prefill cache is grafted
into a fixed-size decode cache (the rule of tests/test_models_smoke.py) --
on the zamba2, rwkv6, gemma2, starcoder2, olmoe (MoE, qk-norm), stablelm
(25% partial rotary, qk-norm), codeqwen (MHA, ``rope_theta`` 1e6),
deepseek-v3 (MLA with its absorbed decode, MoE with a shared expert, the
MTP head's parameters), llama-3.2-vision (cross attention over image
tokens, qk-norm) and whisper (an encoder over audio frames, cross
attention, tied embeddings) smoke configs, with the reference's weights
bridged 1:1 and the same numpy-seeded tokens; the two frontend configs
get the same numpy-seeded frontend embeddings in both packages.  The
reference runs its XLA path (``impl="xla"``: ``flash_attention_ref`` and
``linear_scan_ref``), which is what the port's CPU path must match; one
test holds the port against the reference's Pallas kernels in interpret
mode instead.  In train mode the MoE losses ``moe_aux``/``moe_z``, summed
over every layer, are compared too (1e-5 in f32).

Tolerances (max |diff| over every element):

* f32 compute: 1e-4.  The two packages run the same operations in the
  same precision; only summation orders differ (measured <= 2e-5).
* bf16 compute: max(5e-2, 2 e), where e is the reference's own bf16 error
  against its f32 result on the same weights and tokens.  Two bf16
  evaluations of one f32 function that round at different places (XLA
  fuses elementwise chains, PyTorch rounds every op) each sit about e
  from the f32 value, so they lie within 2 e of each other.  The attention
  configs hold 5e-2; the Mamba2 / RWKV-6 configs, whose recurrent states
  carry bf16 noise through every step, reach ~0.2 (e ~0.15).
* bf16 MoE (olmoe, deepseek): the reference runs op by op
  (``jax.disable_jit``), rounding where the port does.  Routing is
  discontinuous: under ``jit`` XLA keeps the router's input in f32
  through a fusion, which flips a near-tie between two experts at one
  token of the smoke batch, and the reference's jitted logits then
  differ from its own op-by-op logits by far more than the rule above
  allows.  Olmoe's routing then agrees, and its tolerance is the rule
  above.
* bf16 deepseek: op by op, the two packages still round the router's
  input at different places (the MLA layers' elementwise chains), its
  gates differ by up to ~1e-2, and one token whose second and third
  gates lie 6.1e-4 apart in the reference picks the other expert in the
  port.  So deepseek's bf16 runs replay the reference's routing in the
  port -- each token's experts and each expert's kept tokens and
  weights, recorded from the reference's own ``jax.lax.top_k`` calls --
  and hold the port's own routing to it: the same experts at every token
  whose k-th and (k+1)-th reference gates lie ``NEAR_TIE`` or more
  apart, and at those tokens the same kept (expert, token) pairs with
  weights within ``ROUTE_W_TOL`` (measured 7.8e-3).  The logits'
  tolerance is the rule above.
"""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_config as j_smoke
from repro.kernels import ops as jops
from repro.models.model import apply_model as j_apply
from repro.models.model import init_cache as j_init_cache
from repro.models.model import init_params as j_init
from repro_torch.bridge import params_from_jax
from repro_torch.configs.registry import get_smoke_config
from repro_torch.models import moe as moe_mod
from repro_torch.models.model import apply_model, init_cache
from repro_torch.train.train_step import make_prefill_step, make_serve_step

ARCHS = ["zamba2_2p7b", "rwkv6_1p6b", "gemma2_27b", "starcoder2_7b",
         "olmoe_1b_7b", "stablelm_12b", "codeqwen15_7b", "deepseek_v3_671b",
         "llama32_vision_90b", "whisper_small"]
B, S, SPLIT = 2, 12, 8           # prefill SPLIT tokens, decode the rest
F32_TOL = 1e-4
AUX_TOL = 1e-5
BF16_TOL = 5e-2
STATE_LEAVES = ("ssm", "state", "tm_shift", "cm_shift", "conv")
ROUTED = ("olmoe_1b_7b", "deepseek_v3_671b")   # bf16 reference op by op
REPLAYED = ("deepseek_v3_671b",)  # bf16 routing replayed (module docstring)
NEAR_TIE = 1e-3                  # observed flip: gates 6.1e-4 apart
ROUTE_W_TOL = 1e-2


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, torch.Tensor):
        yield prefix, tree.float().numpy()
    else:
        yield prefix, np.asarray(tree, np.float32)


def _tokens(vocab):
    return np.random.default_rng(1).integers(0, vocab, (B, S)).astype(
        np.int32)


def _frontend(cfg):
    """(B, T, D) frontend embeddings for the configs that take them, else
    None."""
    if not (cfg.encoder_groups or cfg.family == "vlm"):
        return None
    return np.random.default_rng(2).standard_normal(
        (B, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)


@contextlib.contextmanager
def _recording_top_k(rec):
    """Record every ``jax.lax.top_k`` call of the reference (op by op):
    its operand, values and indices.  Each MoE layer makes two, the
    router's top-k over the gates and the capacity's top-C over the
    (expert, token) scores."""
    real = jax.lax.top_k

    def top_k(x, k):
        v, i = real(x, k)
        rec.append(tuple(np.array(a) for a in (x, v, i)))
        return v, i

    jax.lax.top_k = top_k
    try:
        yield
    finally:
        jax.lax.top_k = real


def _kept(cw, ci, T):
    """(E, T) weight of each kept (expert, token) pair, 0 elsewhere."""
    w = np.zeros((cw.shape[0], T), np.float32)
    np.put_along_axis(w, np.asarray(ci, np.int64), cw, 1)
    return w


@contextlib.contextmanager
def _replaying_routes(rec):
    """The port's MoE calls take the reference's recorded routing, in call
    order, after its own routing is held to it (module docstring)."""
    real, calls = moe_mod.route, iter(zip(rec[::2], rec[1::2]))

    def route(p, xt, cfg):
        top_i, cw, ci, aux = real(p, xt, cfg)
        (gates, _, want_i), (_, want_cw, want_ci) = next(calls)
        k, T = cfg.moe.top_k, xt.shape[0]
        g = -np.sort(-gates, -1)
        tie = g[:, k - 1] - g[:, k] < NEAR_TIE
        moved = (np.sort(top_i.numpy(), -1) != np.sort(want_i, -1)).any(-1)
        assert not (moved & ~tie).any(), (
            f"the port moves tokens {np.nonzero(moved & ~tie)[0]} that are "
            "no near-tie")
        own, want = _kept(cw.numpy(), ci.numpy(), T), _kept(want_cw, want_ci, T)
        assert ((own > 0) == (want > 0))[:, ~tie].all()
        assert np.abs(own - want)[:, ~tie].max() <= ROUTE_W_TOL
        return (torch.from_numpy(want_i).long(), torch.from_numpy(want_cw),
                torch.from_numpy(want_ci).long(), aux)

    moe_mod.route = route
    try:
        yield
    finally:
        moe_mod.route = real
    assert next(calls, None) is None, "recorded MoE calls left over"


def _j_graft(cfg, pcache):
    cache = j_init_cache(cfg, B, S, cfg.dtype)
    cache["pos"] = pcache["pos"]
    for gk, gv in pcache["groups"].items():
        for pk, pv in gv.items():
            for name, arr in pv.items():
                tgt = cache["groups"][gk][pk][name]
                if name in STATE_LEAVES:
                    cache["groups"][gk][pk][name] = arr.astype(tgt.dtype)
                else:
                    pad = [(0, t - s) for s, t in zip(arr.shape, tgt.shape)]
                    cache["groups"][gk][pk][name] = jnp.pad(arr, pad).astype(
                        tgt.dtype)
    return cache


def _graft(cfg, pcache):
    """The prefill cache written into a zero decode cache of S positions."""
    cache = init_cache(cfg, B, S, cfg.dtype, device="cpu")
    cache["pos"] = pcache["pos"]
    for gk, gv in pcache["groups"].items():
        for pk, pv in gv.items():
            for name, arr in pv.items():
                tgt = cache["groups"][gk][pk][name]
                tgt[tuple(slice(0, n) for n in arr.shape)] = arr.to(tgt.dtype)
    return cache


@functools.lru_cache(maxsize=None)
def _weights(arch):
    jp = j_init(j_smoke(arch), jax.random.PRNGKey(1))
    return jp, params_from_jax(jax.device_get(jp))


@functools.lru_cache(maxsize=None)
def _jax_run(arch, dtype):
    """The reference's three modes, each jitted as its serve engine and
    dry-run run them."""
    cfg = j_smoke(arch).scaled(dtype=dtype)
    jp, _ = _weights(arch)
    toks = jnp.asarray(_tokens(cfg.vocab))
    fe = _frontend(cfg)
    fe = None if fe is None else jnp.asarray(fe)
    if dtype == "bfloat16" and arch in REPLAYED:
        routes = []
        with jax.disable_jit(), _recording_top_k(routes):
            out = _jax_modes(cfg, jp, toks, fe, lambda f: f)
        return {**out, "routes": routes}
    if dtype == "bfloat16" and arch in ROUTED:
        with jax.disable_jit():
            return _jax_modes(cfg, jp, toks, fe, lambda f: f)
    return _jax_modes(cfg, jp, toks, fe, jax.jit)


def _jax_modes(cfg, jp, toks, fe, wrap):
    def run(mode):
        return wrap(lambda p, t, c=None, f=None: j_apply(
            p, t, cfg=cfg, mode=mode, cache=c, frontend=f))

    train, _, aux = run("train")(jp, toks, None, fe)
    pre, pcache, _ = run("prefill")(jp, toks[:, :SPLIT], None, fe)
    cache = _j_graft(cfg, pcache)
    decode = run("decode")
    dec = []
    for t in range(SPLIT, S):
        lg, cache, _ = decode(jp, toks[:, t:t + 1], cache)
        dec.append(lg)
    return {"train": np.asarray(train, np.float32),
            "aux": {k: np.asarray(v, np.float32) for k, v in aux.items()
                    if k != "mtp_hidden"},
            "prefill": np.asarray(pre, np.float32),
            "cache": dict(_leaves(jax.device_get(pcache))),
            "decode": np.asarray(jnp.concatenate(dec, 1), np.float32)}


@functools.lru_cache(maxsize=None)
def _port_run(arch, dtype):
    if dtype == "bfloat16" and arch in REPLAYED:
        with _replaying_routes(_jax_run(arch, dtype)["routes"]):
            return _port_modes(arch, dtype)
    return _port_modes(arch, dtype)


def _port_modes(arch, dtype):
    cfg = get_smoke_config(arch).scaled(dtype=dtype)
    _, tp = _weights(arch)
    toks = torch.from_numpy(_tokens(cfg.vocab))
    fe = _frontend(cfg)
    fe = None if fe is None else torch.from_numpy(fe)
    train, _, aux = apply_model(tp, toks, cfg=cfg, mode="train", frontend=fe)
    pre, pcache, _ = apply_model(tp, toks[:, :SPLIT], cfg=cfg, mode="prefill",
                                 frontend=fe)
    cache = _graft(cfg, pcache)
    dec = []
    for t in range(SPLIT, S):
        lg, cache, _ = apply_model(tp, toks[:, t:t + 1], cfg=cfg,
                                   mode="decode", cache=cache)
        dec.append(lg)
    return {"train": train.float().numpy(),
            "aux": {k: v.numpy() for k, v in aux.items()
                    if k != "mtp_hidden"},
            "prefill": pre.float().numpy(),
            "cache": dict(_leaves(pcache)),
            "decode": torch.cat(dec, 1).float().numpy()}


def _max_err(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        return max(_max_err(a[k], b[k]) for k in a)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("what", ["train", "prefill", "cache", "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_apply_model_matches_reference(arch, what, dtype):
    got, want = _port_run(arch, dtype)[what], _jax_run(arch, dtype)[what]
    err = _max_err(got, want)
    if dtype == "float32":
        tol = F32_TOL
    else:
        own = _max_err(want, _jax_run(arch, "float32")[what])
        tol = max(BF16_TOL, 2 * own)
    assert err <= tol, f"{arch} {what} {dtype}: {err} > {tol}"


def test_moe_aux_sums_match_reference():
    """Train mode, f32: the MoE losses summed over olmoe's layers; the
    non-MoE configs return exact zeros, as the reference does."""
    got, want = _port_run("olmoe_1b_7b", "float32")["aux"], \
        _jax_run("olmoe_1b_7b", "float32")["aux"]
    assert got.keys() == want.keys() == {"moe_aux", "moe_z"}
    assert all(float(want[k]) > 0 for k in want)
    assert _max_err(got, want) <= AUX_TOL
    for arch in ("zamba2_2p7b", "starcoder2_7b"):
        aux = _port_run(arch, "float32")["aux"]
        assert all(float(v) == 0.0 and v.dtype == np.float32
                   for v in aux.values())


def test_prefill_then_serve_steps_follow_the_forward():
    """make_prefill_step, then make_serve_step fed the true next tokens:
    each step's greedy token is the forward's argmax at that position
    (f32, where the two paths agree to ~1e-5)."""
    cfg = get_smoke_config("zamba2_2p7b").scaled(dtype="float32")
    _, tp = _weights("zamba2_2p7b")
    toks = torch.from_numpy(_tokens(cfg.vocab))
    full, _, _ = apply_model(tp, toks, cfg=cfg, mode="train")
    last, pcache = make_prefill_step(cfg)(tp, toks[:, :SPLIT])
    assert torch.allclose(last, full[:, SPLIT - 1], atol=F32_TOL)
    cache, step = _graft(cfg, pcache), make_serve_step(cfg)
    for t in range(SPLIT, S):
        nxt, cache = step(tp, cache, toks[:, t:t + 1])
        assert torch.equal(nxt, full[:, t].argmax(-1).to(torch.int32))
    assert torch.equal(cache["pos"], torch.full((B,), S, dtype=torch.int32))


@pytest.mark.parametrize("arch", ["zamba2_2p7b", "rwkv6_1p6b"])
def test_train_logits_match_reference_pallas_kernels(arch):
    """The reference with its Pallas flash and scan kernels in interpret
    mode (the TPU kernels' bodies) against the port's CPU path, f32."""
    cfg = j_smoke(arch).scaled(dtype="float32")
    jp, tp = _weights(arch)
    toks = _tokens(cfg.vocab)
    jops.set_default_impl("interpret")
    try:
        want, _, _ = j_apply(jp, jnp.asarray(toks), cfg=cfg, mode="train")
    finally:
        jops.set_default_impl("xla")
    got, _, _ = apply_model(tp, torch.from_numpy(toks),
                            cfg=get_smoke_config(arch).scaled(
                                dtype="float32"), mode="train")
    assert _max_err(got.numpy(), np.asarray(want, np.float32)) <= F32_TOL


def test_decode_writes_the_cache_in_place():
    """Decode writes the stacked cache tensors it was given (the port's
    one departure from the reference's value semantics)."""
    cfg = get_smoke_config("zamba2_2p7b").scaled(dtype="float32")
    _, tp = _weights("zamba2_2p7b")
    cache = init_cache(cfg, B, S, cfg.dtype, device="cpu")
    before = cache["groups"]["g0"]["p2"]["shared_k"].clone()
    tok = torch.from_numpy(_tokens(cfg.vocab)[:, :1])
    _, out, _ = apply_model(tp, tok, cfg=cfg, mode="decode", cache=cache)
    assert out["groups"]["g0"]["p2"]["shared_k"] is \
        cache["groups"]["g0"]["p2"]["shared_k"]
    assert not torch.equal(cache["groups"]["g0"]["p2"]["shared_k"], before)
    assert torch.equal(out["pos"], cache["pos"] + 1)
