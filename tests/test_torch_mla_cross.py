"""MLA, cross attention, the encoder and the MTP head's parameters: the
port against the reference, on the CPU.

* ``apply_attn`` with ``kind="mla"`` (deepseek smoke): prefill output and
  compressed cache (``ckv``, ``k_rope``), then the ABSORBED decode of the
  remaining tokens against the grafted cache; and, in the port alone, the
  absorbed decode against the explicit train-mode form at the same
  positions (the algebra the absorption rests on).
* ``apply_attn`` with ``kind="cross"`` (llama-vision smoke, with and
  without qk-norm): prefill over ``kv_source`` (Sq != Sk, bidirectional)
  and its K/V cache, then decode against that cache.
* ``encode`` (whisper smoke): the encoder's output, the cross layers'
  ``kv_source``.
* ``aux["mtp_hidden"]`` (deepseek smoke, train mode).
* ``build_specs`` and ``cache_shapes`` of every FULL config of the
  registry: the same key paths, shapes, dtypes and init fields as the
  reference's, nothing materialised (deepseek's MTP head, whisper's
  encoder and the cross caches over the frontend's tokens included).

Weights are the reference's ``init_params`` bridged 1:1; inputs come from
numpy seeds.  Tolerances are ``tests/test_torch_dense_model.py``'s: f32
1e-4, bf16 max(5e-2, 2 e) with e the reference's own bf16 distance from
its f32 result.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as j_config
from repro.configs.registry import get_smoke_config as j_smoke
from repro.models import attention as j_attn
from repro.models import layers as j_layers
from repro.models import model as j_model
from repro_torch.bridge import params_from_jax
from repro_torch.configs.registry import ARCHS, get_config, get_smoke_config
from repro_torch.models import attention as attn
from repro_torch.models.model import (apply_model, build_specs, cache_shapes,
                                      encode)

B, S, SPLIT = 2, 12, 8           # prefill SPLIT tokens, decode the rest
F32_TOL = 1e-4
BF16_TOL = 5e-2
DTYPES = ["float32", "bfloat16"]


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _err(a, b):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max())


def _tol(dtype, want, want_f32):
    if dtype == "float32":
        return F32_TOL
    return max(BF16_TOL, 2 * _err(want, want_f32))


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@functools.lru_cache(maxsize=None)
def _layer_weights(arch, kind, qk_norm=None):
    """One attention layer's weights: the reference's, then bridged."""
    cfg = j_smoke(arch)
    if qk_norm is not None:
        cfg = cfg.scaled(qk_norm=qk_norm)
    jp = j_layers.materialize(j_attn.attn_specs(cfg, kind),
                              jax.random.PRNGKey(3))
    return jp, params_from_jax(jax.device_get(jp))


def _both(x, dtype):
    return (jnp.asarray(x).astype(jnp.dtype(dtype)),
            torch.from_numpy(x).to(getattr(torch, dtype)))


# ----------------------------------------------------------------------------
# MLA
# ----------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _mla_runs(dtype):
    """Prefill of SPLIT tokens, then decode of the rest, in both packages:
    {"ref"|"port": (prefill out, prefill cache, decode outs, final cache)}
    and the port's train-mode output over all S tokens."""
    arch = "deepseek_v3_671b"
    jcfg = j_smoke(arch).scaled(dtype=dtype)
    tcfg = get_smoke_config(arch).scaled(dtype=dtype)
    jp, tp = _layer_weights(arch, "mla")
    jx, tx = _both(_rand(4, B, S, jcfg.d_model), dtype)
    m = jcfg.mla

    jo, jc = j_attn.apply_attn(jp, jx[:, :SPLIT], cfg=jcfg, kind="mla",
                               mode="prefill")
    to, tc = attn.apply_attn(tp, tx[:, :SPLIT], cfg=tcfg, kind="mla",
                             mode="prefill")
    jcache = {k: jnp.zeros((B, S) + v.shape[2:], v.dtype).at[:, :SPLIT].set(v)
              for k, v in jc.items()}
    tcache = {}
    for k, v in tc.items():
        tcache[k] = torch.zeros((B, S) + v.shape[2:], dtype=v.dtype)
        tcache[k][:, :SPLIT] = v
    jdec, tdec = [], []
    for t in range(SPLIT, S):
        jpos = jnp.full((B,), t, jnp.int32)
        tpos = torch.full((B,), t, dtype=torch.int32)
        o, jcache = j_attn.apply_attn(jp, jx[:, t:t + 1], cfg=jcfg,
                                      kind="mla", mode="decode", cache=jcache,
                                      pos=jpos)
        jdec.append(o)
        o, tcache = attn.apply_attn(tp, tx[:, t:t + 1], cfg=tcfg, kind="mla",
                                    mode="decode", cache=tcache, pos=tpos)
        tdec.append(o)
    train, none = attn.apply_attn(tp, tx, cfg=tcfg, kind="mla", mode="train")
    assert none is None
    assert tuple(tc["ckv"].shape) == (B, SPLIT, m.kv_lora_rank)
    assert tuple(tc["k_rope"].shape) == (B, SPLIT, m.qk_rope_head_dim)
    return {"ref": (jo, jc, jnp.concatenate(jdec, 1), jcache),
            "port": (to, tc, torch.cat(tdec, 1), tcache),
            "train": train}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("what", ["prefill", "prefill cache", "decode",
                                  "decode cache"])
def test_mla_matches_reference(what, dtype):
    i = ["prefill", "prefill cache", "decode", "decode cache"].index(what)
    got, want = _mla_runs(dtype)["port"][i], _mla_runs(dtype)["ref"][i]
    want32 = _mla_runs("float32")["ref"][i]
    if isinstance(got, dict):
        assert got.keys() == want.keys() == {"ckv", "k_rope"}
        err = max(_err(got[k], want[k]) for k in got)
        tol = max(_tol(dtype, want[k], want32[k]) for k in got)
    else:
        err, tol = _err(got, want), _tol(dtype, want, want32)
    assert err <= tol, f"mla {what} {dtype}: {err} > {tol}"


def test_mla_absorbed_decode_equals_the_explicit_form():
    """f32: decoding token t against the compressed cache gives the
    explicit (decompressed, flash) form's output at position t."""
    runs = _mla_runs("float32")
    err = _err(runs["port"][2], runs["train"][:, SPLIT:])
    assert err <= F32_TOL, err


# ----------------------------------------------------------------------------
# cross attention
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("qk_norm", [True, False])
def test_cross_attention_matches_reference(qk_norm, dtype):
    """Prefill over T frontend tokens (bidirectional, Sq != Sk) and its
    K/V cache; then decode steps against that cache, which they leave as
    it was."""
    arch = "llama32_vision_90b"
    runs = {}
    for dt in {"float32", dtype}:
        jcfg = j_smoke(arch).scaled(dtype=dt, qk_norm=qk_norm)
        tcfg = get_smoke_config(arch).scaled(dtype=dt, qk_norm=qk_norm)
        T = jcfg.n_frontend_tokens
        jp, tp = _layer_weights(arch, "cross", qk_norm)
        assert ("q_scale" in tp) == qk_norm
        jx, tx = _both(_rand(5, B, S, jcfg.d_model), dt)
        jkv, tkv = _both(_rand(6, B, T, jcfg.d_model), dt)
        jo, jc = j_attn.apply_attn(jp, jx, cfg=jcfg, kind="cross",
                                   mode="prefill", kv_source=jkv)
        to, tc = attn.apply_attn(tp, tx, cfg=tcfg, kind="cross",
                                 mode="prefill", kv_source=tkv)
        assert tuple(tc["k"].shape) == (B, T, tcfg.n_kv_heads,
                                        tcfg.head_dim_)
        kept = {k: v.clone() for k, v in tc.items()}
        jdec, tdec = [], []
        for t in range(SPLIT, S):
            o, _ = j_attn.apply_attn(jp, jx[:, t:t + 1], cfg=jcfg,
                                     kind="cross", mode="decode", cache=jc,
                                     pos=jnp.full((B,), t, jnp.int32))
            jdec.append(o)
            o, _ = attn.apply_attn(tp, tx[:, t:t + 1], cfg=tcfg, kind="cross",
                                   mode="decode", cache=tc,
                                   pos=torch.full((B,), t, dtype=torch.int32))
            tdec.append(o)
        assert all(torch.equal(tc[k], kept[k]) for k in tc)
        runs[dt] = {"prefill": (jo, to), "k": (jc["k"], tc["k"]),
                    "v": (jc["v"], tc["v"]),
                    "decode": (jnp.concatenate(jdec, 1), torch.cat(tdec, 1))}
    for what, (want, got) in runs[dtype].items():
        err = _err(got, want)
        tol = _tol(dtype, want, runs["float32"][what][0])
        assert err <= tol, f"cross {what} qk_norm={qk_norm} {dtype}: {err}"


# ----------------------------------------------------------------------------
# encoder and MTP hidden state
# ----------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _model_weights(arch):
    jp = j_model.init_params(j_smoke(arch), jax.random.PRNGKey(1))
    return jp, params_from_jax(jax.device_get(jp))


@pytest.mark.parametrize("dtype", DTYPES)
def test_encoder_output_matches_reference(dtype):
    """whisper: the encoder groups over the frontend + pos_embed, then
    encoder/final_norm -- what the reference's apply_model computes as the
    cross layers' kv_source."""
    arch = "whisper_small"
    jp, tp = _model_weights(arch)
    fe = _rand(7, B, j_smoke(arch).n_frontend_tokens, j_smoke(arch).d_model)
    want = {}
    for dt in {"float32", dtype}:
        cfg = j_smoke(arch).scaled(dtype=dt)
        d = jnp.dtype(dt)
        h = jnp.asarray(fe).astype(d) + jp["encoder"]["pos_embed"][None] \
            .astype(d)
        h, _, _ = j_model._run_groups(
            jp["encoder"]["groups"], cfg.encoder_groups, h, cfg=cfg,
            mode="train", cache=None, pos=None, kv_source=None,
            shared_params=None)
        want[dt] = j_layers.rms_norm(h, jp["encoder"]["final_norm"],
                                     cfg.norm_eps)
    got = encode(tp, torch.from_numpy(fe),
                 cfg=get_smoke_config(arch).scaled(dtype=dtype))
    assert got.dtype == getattr(torch, dtype)
    err = _err(got, want[dtype])
    assert err <= _tol(dtype, want[dtype], want["float32"]), err


def test_mtp_hidden_matches_reference():
    """deepseek, train mode, f32: aux["mtp_hidden"] is the final-normed
    hidden state (the MTP head's input), and the logits are its product
    with the head."""
    arch = "deepseek_v3_671b"
    jp, tp = _model_weights(arch)
    toks = np.random.default_rng(8).integers(0, 256, (B, S)).astype(np.int32)
    _, _, jaux = j_model.apply_model(
        jp, jnp.asarray(toks), cfg=j_smoke(arch).scaled(dtype="float32"),
        mode="train")
    logits, _, aux = apply_model(
        tp, torch.from_numpy(toks),
        cfg=get_smoke_config(arch).scaled(dtype="float32"), mode="train")
    assert set(aux) == set(jaux) == {"moe_aux", "moe_z", "mtp_hidden"}
    assert _err(aux["mtp_hidden"], jaux["mtp_hidden"]) <= F32_TOL
    head = aux["mtp_hidden"] @ tp["lm_head"].float()
    assert _err(head, logits) <= F32_TOL
    # the other configs carry no mtp_hidden
    cfg = get_smoke_config("whisper_small").scaled(dtype="float32")
    _, _, aux = apply_model(
        _model_weights("whisper_small")[1], torch.from_numpy(toks), cfg=cfg,
        mode="train",
        frontend=torch.zeros((B, cfg.n_frontend_tokens, cfg.d_model)))
    assert set(aux) == {"moe_aux", "moe_z"}


# ----------------------------------------------------------------------------
# specs and cache shapes of the full configs
# ----------------------------------------------------------------------------


def _spec_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _spec_leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, (tuple(tree.shape), tuple(tree.axes), tree.init,
                       tree.scale, str(tree.dtype), tree.fan_in)


def _cache_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _cache_leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, tuple):                 # the port's (shape, dtype)
        yield prefix, (tuple(tree[0]), str(tree[1]).replace("torch.", ""))
    else:                                         # ShapeDtypeStruct
        yield prefix, (tuple(tree.shape), str(tree.dtype))


@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_specs_and_cache_shapes_match_reference(arch):
    """Key paths, shapes, logical axes, init and dtypes of build_specs,
    and the decode cache's shapes and dtypes, for the full config:
    declared, never materialised."""
    cfg, jcfg = get_config(arch), j_config(arch)
    got, want = dict(_spec_leaves(build_specs(cfg))), \
        dict(_spec_leaves(j_model.build_specs(jcfg)))
    assert got == want
    got = dict(_cache_leaves(cache_shapes(cfg, 2, 64)))
    want = dict(_cache_leaves(j_model.cache_shapes(jcfg, 2, 64)[0]))
    assert got == want
    if arch == "deepseek_v3_671b":
        assert {"/mtp/proj", "/groups/g0/p0/attn/wkv_a"} <= set(
            dict(_spec_leaves(build_specs(cfg))))
        assert got["/groups/g1/p0/ckv"][0] == (58, 2, 64, 512)
    if cfg.n_frontend_tokens and any(ls.attn_kind == "cross"
                                     for g in cfg.groups
                                     for ls in g.pattern):
        cross = [v for k, v in got.items() if k.endswith("/k")
                 and v[0][2] == cfg.n_frontend_tokens]
        assert cross, "no cross cache over the frontend's tokens"
