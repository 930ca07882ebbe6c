"""The port's dense model path against the reference's, on the CPU.

``apply_model`` in its three modes -- train-mode logits, prefill logits
and cache leaves, and decode logits after the prefill cache is grafted
into a fixed-size decode cache (the rule of tests/test_models_smoke.py) --
on the zamba2, rwkv6, gemma2 and starcoder2 smoke configs, with the
reference's weights bridged 1:1 and the same numpy-seeded tokens.  The
reference runs its XLA path (``impl="xla"``: ``flash_attention_ref`` and
``linear_scan_ref``), which is what the port's CPU path must match; one
test holds the port against the reference's Pallas kernels in interpret
mode instead.

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
"""

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
from repro_torch.models.model import apply_model, init_cache
from repro_torch.train.train_step import make_prefill_step, make_serve_step

ARCHS = ["zamba2_2p7b", "rwkv6_1p6b", "gemma2_27b", "starcoder2_7b"]
B, S, SPLIT = 2, 12, 8           # prefill SPLIT tokens, decode the rest
F32_TOL = 1e-4
BF16_TOL = 5e-2
STATE_LEAVES = ("ssm", "state", "tm_shift", "cm_shift", "conv")


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

    def run(mode):
        return jax.jit(lambda p, t, c=None: j_apply(p, t, cfg=cfg, mode=mode,
                                                      cache=c))

    train, _, _ = run("train")(jp, toks)
    pre, pcache, _ = run("prefill")(jp, toks[:, :SPLIT])
    cache = _j_graft(cfg, pcache)
    decode = run("decode")
    dec = []
    for t in range(SPLIT, S):
        lg, cache, _ = decode(jp, toks[:, t:t + 1], cache)
        dec.append(lg)
    return {"train": np.asarray(train, np.float32),
            "prefill": np.asarray(pre, np.float32),
            "cache": dict(_leaves(jax.device_get(pcache))),
            "decode": np.asarray(jnp.concatenate(dec, 1), np.float32)}


@functools.lru_cache(maxsize=None)
def _port_run(arch, dtype):
    cfg = get_smoke_config(arch).scaled(dtype=dtype)
    _, tp = _weights(arch)
    toks = torch.from_numpy(_tokens(cfg.vocab))
    train, _, _ = apply_model(tp, toks, cfg=cfg, mode="train")
    pre, pcache, _ = apply_model(tp, toks[:, :SPLIT], cfg=cfg, mode="prefill")
    cache = _graft(cfg, pcache)
    dec = []
    for t in range(SPLIT, S):
        lg, cache, _ = apply_model(tp, toks[:, t:t + 1], cfg=cfg,
                                   mode="decode", cache=cache)
        dec.append(lg)
    return {"train": train.float().numpy(), "prefill": pre.float().numpy(),
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
