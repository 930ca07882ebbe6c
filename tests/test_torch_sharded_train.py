"""The port's sharded train step and context-parallel attention, 8 gloo
ranks on the CPU:

* tests/test_parallel.py's ``t8`` config on (data=4, model=2): parameters
  and AdamW moments DTensors laid out by ``spec_for``, the batch over
  ``data``; its loss and grad norm against the port's unsharded step and
  the reference's sharded step (a subprocess with 8 host devices, mesh
  axes ``Auto``), compute in f32 in both;
* starcoder2-smoke (6 heads, 2 kv heads) on (data=2, model=4): the heads
  do not divide 4, so attention runs context parallel (each rank its
  query slice at its offset); logits against the unsharded forward;
* a decode step of ``t8`` (4 heads, 2 kv heads) on (data=2, model=4): the
  kv heads do not divide 4, so the cache's sequence holds ``model``;
  logits and the written cache against the unsharded step;
* ``flash_attention_ref``'s ``q_offset`` against the reference's;
* the loss under a mesh keeps the batch over ``data`` and the vocab over
  ``model`` (no gather of the logits): ``t8`` with a vocab of 250 on
  (data=2, model=4), its logits padded to 256, the last ``model`` rank's
  shard holding the six masked columns (``vocab_padded`` is a multiple of
  256, so no padded vocab leaves a remainder over a ``model`` axis of a
  power of two up to 256: this is the case the padding rules allow),
  against the unsharded step and the reference's sharded step; and
  deepseek-smoke's MTP head, its logits vocab-sharded as the main
  head's: loss and every grad in f32 against the unsharded port and the
  reference's unsharded ``value_and_grad`` on the same parameters."""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.kernels.ref import flash_attention_ref as jax_flash_ref
from repro_torch.kernels.ref import flash_attention_ref
from repro_torch.parallel.collectives import spawn_ranks

ROOT = Path(__file__).resolve().parents[1]
WORLD = 8

REFERENCE = """
import sys, numpy as np, jax, jax.numpy as jnp
from jax.sharding import AxisType
from repro.configs.base import ArchConfig, dense_stack
from repro.models.model import init_params, params_logical_axes
from repro.optim.adamw import adamw_init
from repro.parallel import sharding as sh
from repro.train.train_step import make_train_step
for out, vocab, shape in ((sys.argv[1], 256, (4, 2)),
                          (sys.argv[2], 250, (2, 4))):
    cfg = ArchConfig(name="t8", d_model=64, n_heads=4, n_kv_heads=2,
                     d_ff=128, vocab=vocab, groups=dense_stack(2),
                     remat="none", dtype="float32")
    mesh = jax.make_mesh(shape, ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    sh.set_mesh(mesh)
    params = init_params(cfg, jax.random.PRNGKey(0))
    flat = {"/".join(str(k.key) for k in path): np.asarray(v, np.float32)
            for path, v in jax.tree_util.tree_flatten_with_path(params)[0]}
    p_sh = sh.tree_shardings(mesh, params_logical_axes(cfg), params)
    params = jax.device_put(params, p_sh)
    opt = adamw_init(params)
    step = jax.jit(make_train_step(cfg), donate_argnums=(0, 1))
    toks = np.random.default_rng(1).integers(0, vocab, (8, 32)).astype(
        np.int32)
    batch = {"tokens": jnp.asarray(toks),
             "targets": jnp.asarray(np.roll(toks, -1, 1))}
    params, opt, metrics = step(params, opt, batch)
    np.savez(out, loss=float(metrics["loss"]),
             grad_norm=float(metrics["grad_norm"]), tokens=toks, **flat)
# deepseek-smoke (MTP) in f32, unsharded: its loss and every grad
import functools
from repro.configs.registry import get_smoke_config
from repro.train.train_step import loss_fn
sh.set_mesh(None)
cfg = get_smoke_config("deepseek_v3_671b").scaled(dtype="float32")
params = jax.tree.map(lambda a: a.astype(jnp.float32),
                      init_params(cfg, jax.random.PRNGKey(1)))
toks = np.random.default_rng(9).integers(0, cfg.vocab, (4, 18)).astype(
    np.int32)
batch = {"tokens": jnp.asarray(toks),
         "targets": jnp.asarray(np.roll(toks, -1, 1))}
(loss, metrics), grads = jax.jit(jax.value_and_grad(
    functools.partial(loss_fn, cfg=cfg), has_aux=True))(params, batch)

def named(tree, tag):
    return {tag + "/" + "/".join(str(k.key) for k in path):
            np.asarray(v, np.float32)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}

np.savez(sys.argv[3], loss=float(loss), mtp=float(metrics["mtp"]),
         tokens=toks, **named(params, "p"), **named(grads, "g"))
"""


def _t8(vocab: int = 256):
    from repro_torch.configs.base import ArchConfig, dense_stack
    return ArchConfig(name="t8", d_model=64, n_heads=4, n_kv_heads=2,
                      d_ff=128, vocab=vocab, groups=dense_stack(2),
                      remat="none", dtype="float32")


def _params(ref, dtype=torch.bfloat16):
    out = {}
    for k, v in ref.items():
        if k in ("loss", "grad_norm", "tokens"):
            continue
        node = out
        *path, leaf = k.split("/")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = torch.from_numpy(v).to(dtype)
    return out


def _leaves(a, b, prefix=""):
    if isinstance(a, dict):
        for k in a:
            yield from _leaves(a[k], b[k], f"{prefix}{k}/")
    else:
        yield prefix[:-1], a, b


def _padded_vocab(sh, ref_path, res):
    """``t8`` with a vocab of 250 on (2, 4): the reference's parameters,
    one sharded and one unsharded step."""
    import copy
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.model import params_logical_axes
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.train.train_step import make_train_step
    ref = dict(np.load(ref_path))
    cfg = _t8(250)
    params = _params(ref)
    toks = torch.from_numpy(ref["tokens"])
    batch = {"tokens": toks, "targets": torch.roll(toks, -1, 1)}
    mesh = make_host_mesh((2, 4), device_type="cpu")
    sh.set_mesh(mesh)
    dp = sh.tree_distribute(mesh, copy.deepcopy(params),
                            params_logical_axes(cfg))
    db = {k: sh.distribute(v, mesh, sh.batch_spec(mesh))
          for k, v in batch.items()}
    dp, _, m = make_train_step(cfg)(dp, adamw_init(dp), db)
    res["pad_loss_s"] = float(sh.full(m["loss"]))
    res["pad_gnorm_s"] = float(sh.full(m["grad_norm"]))
    res["pad_embed_s"] = sh.full(dp["embed"]).float().numpy()
    res["pad_embed_placements"] = str(dp["embed"].placements)
    sh.set_mesh(None)
    p1 = copy.deepcopy(params)
    p1, _, m1 = make_train_step(cfg)(p1, adamw_init(p1), batch)
    res["pad_loss_u"] = float(m1["loss"])
    res["pad_gnorm_u"] = float(m1["grad_norm"])
    res["pad_embed_u"] = p1["embed"].float().numpy()


def _mtp(sh, ref_path, res):
    """deepseek-smoke's loss (with its MTP head) and every grad, f32, on
    (2, 4) and unsharded, from the reference's parameters and tokens.
    S = 18 does not divide ``model``, so the MoE routes the whole batch
    as the unsharded step does (expert parallelism routes each sequence
    slice and averages its aux loss over the slices: the reference's
    ``shard_map`` branch, another loss)."""
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.model import params_logical_axes
    from repro_torch.train.train_step import value_and_grad
    cfg = get_smoke_config("deepseek_v3_671b").scaled(dtype="float32")
    ref = dict(np.load(ref_path))
    params = _params({k[2:]: v for k, v in ref.items()
                      if k.startswith("p/")}, torch.float32)
    toks = torch.from_numpy(ref["tokens"]).long()
    batch = {"tokens": toks, "targets": torch.roll(toks, -1, 1)}
    (loss_u, m_u), g_u = value_and_grad(params, batch, cfg)
    mesh = make_host_mesh((2, 4), device_type="cpu")
    sh.set_mesh(mesh)
    db = {k: sh.distribute(v, mesh, sh.batch_spec(mesh))
          for k, v in batch.items()}
    (loss_s, m_s), g_s = value_and_grad(
        sh.tree_distribute(mesh, params, params_logical_axes(cfg)), db, cfg)
    res["mtp_loss_s"] = float(sh.full(loss_s))
    res["mtp_loss_u"] = float(loss_u)
    res["mtp_mtp_s"] = float(sh.full(m_s["mtp"]))
    res["mtp_mtp_u"] = float(m_u["mtp"])
    for path, a, b in _leaves(g_s, g_u):
        res[f"mtp_grad_s/{path}"] = sh.full(a).float().numpy()
        res[f"mtp_grad_u/{path}"] = b.float().numpy()
    sh.set_mesh(None)


def _ranks(rank, world, init, ref_path, out_dir):
    import copy
    import torch.distributed as dist
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.model import (apply_model, cache_axes,
                                          init_cache, init_params,
                                          params_logical_axes)
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.parallel import collectives
    from repro_torch.parallel import sharding as sh
    from repro_torch.train.train_step import make_train_step
    torch.set_num_threads(1)
    collectives.init("gloo", rank, world, init)
    res = {}
    try:
        ref = dict(np.load(ref_path))
        cfg = _t8()
        params = _params(ref)
        toks = torch.from_numpy(ref["tokens"])
        batch = {"tokens": toks, "targets": torch.roll(toks, -1, 1)}
        mesh = make_host_mesh((4, 2), device_type="cpu")
        sh.set_mesh(mesh)
        dp = sh.tree_distribute(mesh, copy.deepcopy(params),
                                params_logical_axes(cfg))
        placed = {k: str(v.placements) for k, v in dp.items()
                  if not isinstance(v, dict)}
        db = {k: sh.distribute(v, mesh, sh.batch_spec(mesh))
              for k, v in batch.items()}
        opt = adamw_init(dp)
        moments_sharded = opt.m["embed"].placements == dp["embed"].placements
        dp, opt, m = make_train_step(cfg)(dp, opt, db)
        res["loss_s"] = float(sh.full(m["loss"]))
        res["gnorm_s"] = float(sh.full(m["grad_norm"]))
        res["embed_s"] = sh.full(dp["embed"]).float().numpy()
        sh.set_mesh(None)
        p1 = copy.deepcopy(params)
        p1, _, m1 = make_train_step(cfg)(p1, adamw_init(p1), batch)
        res["loss_u"], res["gnorm_u"] = float(m1["loss"]), float(
            m1["grad_norm"])
        res["embed_u"] = p1["embed"].float().numpy()
        res["moments_sharded"] = moments_sharded
        res["embed_placements"] = placed["embed"]
        # context parallel: 6 heads over model=4
        sc = get_smoke_config("starcoder2_7b").scaled(dtype="float32")
        sp = init_params(sc, torch.Generator().manual_seed(0), device="cpu")
        stoks = torch.from_numpy(np.random.default_rng(2).integers(
            0, sc.vocab, (4, 30)))
        whole = apply_model(sp, stoks, cfg=sc, mode="train")[0]
        mesh = make_host_mesh((2, 4), device_type="cpu")
        sh.set_mesh(mesh)
        got = apply_model(sh.tree_distribute(mesh, sp,
                                             params_logical_axes(sc)),
                          sh.distribute(stoks, mesh, sh.batch_spec(mesh)),
                          cfg=sc, mode="train")[0]
        res["cp_logits_s"] = sh.full(got).detach().numpy()
        res["cp_logits_u"] = whole.detach().numpy()
        sh.set_mesh(None)
        # decode: t8's 2 kv heads over model=4, a 16-token cache at 12
        rng = np.random.default_rng(4)
        cache = init_cache(cfg, 4, 16, dtype="float32", device="cpu")
        kv = cache["groups"]["g0"]["p0"]
        for name in ("k", "v"):
            kv[name].copy_(torch.from_numpy(rng.standard_normal(
                tuple(kv[name].shape)).astype(np.float32)))
        cache["pos"].fill_(12)
        dtoks = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 1)))
        c_u = copy.deepcopy(cache)
        res["dec_logits_u"] = apply_model(params, dtoks, cfg=cfg,
                                          mode="decode", cache=c_u)[0] \
            .detach().float().numpy()
        res["dec_k_u"] = c_u["groups"]["g0"]["p0"]["k"].numpy()
        sh.set_mesh(mesh)
        dc = sh.tree_distribute(mesh, cache, cache_axes(cfg))
        got = apply_model(sh.tree_distribute(mesh, params,
                                             params_logical_axes(cfg)),
                          sh.distribute(dtoks, mesh, sh.batch_spec(mesh)),
                          cfg=cfg, mode="decode", cache=dc)[0]
        dk = dc["groups"]["g0"]["p0"]["k"]
        res["dec_cache_placements"] = str(dk.placements)
        res["dec_logits_s"] = sh.full(got).detach().float().numpy()
        res["dec_k_s"] = sh.full(dk).numpy()
        sh.set_mesh(None)
        _padded_vocab(sh, os.path.join(out_dir, "ref_pad.npz"), res)
        _mtp(sh, os.path.join(out_dir, "ref_mtp.npz"), res)
        if rank == 0:
            np.savez(os.path.join(out_dir, "port.npz"), **res)
        dist.barrier()
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded_train")
    env = {"XLA_FLAGS": "--xla_force_host_platform_device_count=8",
           "PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
           "JAX_PLATFORMS": "cpu"}
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(REFERENCE),
                        str(tmp / "ref.npz"), str(tmp / "ref_pad.npz"),
                        str(tmp / "ref_mtp.npz")],
                       env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    spawn_ranks(_ranks, WORLD, (str(tmp / "ref.npz"), str(tmp)),
                timeout_s=240)
    return (dict(np.load(tmp / "port.npz")), dict(np.load(tmp / "ref.npz")),
            dict(np.load(tmp / "ref_pad.npz")),
            dict(np.load(tmp / "ref_mtp.npz")))


# the parameter leaves are bf16 (their Specs' dtype), so the grads are
# rounded to bf16 after sums taken in another order on each layout: their
# norm agrees to ~1e-4, not to f32's rounding
GNORM_REL = 1e-3
# f32 parameters and compute: only the order of the sums differs
GRAD_REL = 1e-4


def test_sharded_step_matches_unsharded(runs):
    port, *_ = runs
    assert port["loss_s"] == pytest.approx(port["loss_u"], rel=1e-5)
    assert port["gnorm_s"] == pytest.approx(port["gnorm_u"], rel=GNORM_REL)
    np.testing.assert_allclose(port["embed_s"], port["embed_u"], atol=1e-5)


def test_sharded_step_matches_reference_loss(runs):
    port, ref, *_ = runs
    assert port["loss_s"] == pytest.approx(float(ref["loss"]), rel=1e-5)
    assert port["gnorm_s"] == pytest.approx(float(ref["grad_norm"]),
                                            rel=GNORM_REL)


def test_parameters_and_moments_are_laid_out_by_spec_for(runs):
    port, *_ = runs
    # embed (vocab, embed): vocab over model, embed over data
    assert str(port["embed_placements"]) == \
        "(Shard(dim=1), Shard(dim=0))"
    assert bool(port["moments_sharded"])


def test_context_parallel_logits_match_unsharded(runs):
    port, *_ = runs
    np.testing.assert_allclose(port["cp_logits_s"], port["cp_logits_u"],
                               atol=1e-5, rtol=1e-5)


def test_decode_with_kv_heads_not_dividing_model_matches_unsharded(runs):
    port, *_ = runs
    # (layers, batch, kv_seq, kv_heads, D): batch over data, the sequence
    # over model (2 kv heads do not divide 4)
    assert str(port["dec_cache_placements"]) == \
        "(Shard(dim=1), Shard(dim=2))"
    np.testing.assert_allclose(port["dec_logits_s"], port["dec_logits_u"],
                               atol=1e-5, rtol=1e-5)
    # the token's K written at 12, in the shard that holds it
    np.testing.assert_allclose(port["dec_k_s"], port["dec_k_u"], atol=1e-5,
                               rtol=1e-5)


def test_sharded_loss_with_padded_vocab_matches_unsharded(runs):
    """A vocab of 250 padded to 256 over model=4: the padding on the last
    rank's shard, the loss and the step as the unsharded step's."""
    port, *_ = runs
    # (vocab, embed): vocab over model, embed over data
    assert str(port["pad_embed_placements"]) == \
        "(Shard(dim=1), Shard(dim=0))"
    assert port["pad_loss_s"] == pytest.approx(port["pad_loss_u"], rel=1e-5)
    assert port["pad_gnorm_s"] == pytest.approx(port["pad_gnorm_u"],
                                                rel=GNORM_REL)
    np.testing.assert_allclose(port["pad_embed_s"], port["pad_embed_u"],
                               atol=1e-5)


def test_sharded_loss_with_padded_vocab_matches_reference(runs):
    port, _, ref, _ = runs
    assert port["pad_loss_s"] == pytest.approx(float(ref["loss"]), rel=1e-5)
    assert port["pad_gnorm_s"] == pytest.approx(float(ref["grad_norm"]),
                                                rel=GNORM_REL)


def test_sharded_mtp_loss_and_grads_match_unsharded(runs):
    """deepseek-smoke on (2, 4): the MTP head's logits vocab-sharded, its
    loss and the whole loss and every grad as the unsharded port's."""
    port, *_ = runs
    assert port["mtp_mtp_s"] == pytest.approx(port["mtp_mtp_u"], rel=1e-5)
    assert port["mtp_loss_s"] == pytest.approx(port["mtp_loss_u"], rel=1e-5)
    _assert_mtp_grads_close(port, {k.split("/", 1)[1]: v
                                   for k, v in port.items()
                                   if k.startswith("mtp_grad_u/")})


def test_sharded_mtp_loss_and_grads_match_reference(runs):
    """The same sharded loss, its MTP term and every grad against the
    reference's unsharded ``value_and_grad`` on the same parameters."""
    port, *_, ref = runs
    assert port["mtp_mtp_s"] == pytest.approx(float(ref["mtp"]), rel=1e-5)
    assert port["mtp_loss_s"] == pytest.approx(float(ref["loss"]), rel=1e-5)
    _assert_mtp_grads_close(port, {k[2:]: v for k, v in ref.items()
                                   if k.startswith("g/")})


def _assert_mtp_grads_close(port, want):
    """Every grad of the sharded MTP run within GRAD_REL of ``want``'s
    (path -> array), relative to the leaf's largest entry."""
    names = [k.split("/", 1)[1] for k in port if k.startswith("mtp_grad_s/")]
    assert sorted(names) == sorted(want)
    assert any(n.startswith("mtp/") for n in names)
    for n in names:
        got = port[f"mtp_grad_s/{n}"]
        if np.abs(want[n]).max() == 0:
            assert np.abs(got).max() == 0, n
            continue
        rel = np.abs(got - want[n]).max() / np.abs(want[n]).max()
        assert rel <= GRAD_REL, (n, rel)


@pytest.mark.parametrize("case", [
    # (Sq, Sk, H, Hkv, D, causal, window, q_offset)
    (16, 64, 4, 2, 16, True, 0, 48),
    (16, 64, 4, 2, 16, True, 0, 0),
    (20, 100, 6, 2, 8, True, 24, 60),
    (8, 40, 3, 1, 32, True, 0, 17),
])
def test_flash_ref_q_offset_matches_reference(case):
    Sq, Sk, H, Hkv, D, causal, window, off = case
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, Sq, H, D)).astype(np.float32)
    k = rng.standard_normal((2, Sk, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((2, Sk, Hkv, D)).astype(np.float32)
    kw = dict(causal=causal, window=window, q_offset=off)
    want = np.asarray(jax_flash_ref(q, k, v, **kw))
    got = flash_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), **kw).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)
