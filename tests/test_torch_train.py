"""The port's training path against the reference's, on the CPU.

The reference runs on its default XLA path (``flash_attention_ref`` and
``linear_scan_ref``: it has no backward kernel), which is what the port's
CPU path -- the kernels' ``autograd.Function``s over the plain versions --
must match.  Weights are the reference's, bridged 1:1; tokens, targets and
frontends are made with numpy and handed to both.

Tolerances, each with its reason:

* pipeline batches, checkpoints, the kernels' Function on the CPU:
  bit-equal (the same numpy code; the same bytes; the same plain ops).
* ``cosine_schedule``: 1e-7 relative (``cos`` of XLA and of PyTorch may
  differ by an ulp of f32).
* ``adamw_update``: f32 leaves 1e-6 absolute (the same f32 formula; XLA
  fuses the elementwise chain, ``pow`` may differ by an ulp); bf16 leaves
  one bf16 ulp of the new value (a last-bit difference of the f32 value
  can round either way).
* ``loss_fn`` in f32 (leaves cast to f32 first, or bf16 rounding of the
  grads would hide everything): the loss within 1e-5, and every leaf's
  grad within ``GRAD_TOL`` = 1e-4 of the reference, both as max |diff|
  over max(1, max |g|) and as ||diff|| / ||g||.  The two packages run the
  same f32 operations; only summation orders differ (measured <= 2e-5).
* two ``make_train_step`` steps (f32 leaves): each leaf's update within
  ``STEP_TOL`` = 1e-3 of the reference's, as ||p - p_ref|| over
  ||p_ref - p_0||; and no element further than 2 (lr_1 + lr_2) from the
  reference's.  AdamW's step m^/(sqrt(v^) + eps) is scale-free, so a
  grad element near 0, whose f32 value differs in its last bits between
  the two summation orders, may step by anything up to lr either way
  (measured: one element of 8192 in ``wo`` 7.8e-5 off at lr 1e-3).
* ``Trainer`` histories over 8 steps: losses within 1e-4.
"""

import functools
import os
import pathlib
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs.base import ArchConfig as JArchConfig
from repro.configs.base import dense_stack as j_dense_stack
from repro.configs.registry import get_smoke_config as j_smoke
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import TokenPipeline as JTokenPipeline
from repro.models.model import init_params as j_init
from repro.optim import adamw as jadamw
from repro.train.checkpoint import CheckpointManager as JCheckpointManager
from repro.train.train_step import loss_fn as j_loss_fn
from repro.train.train_step import make_train_step as j_make_train_step
from repro.train.trainer import Trainer as JTrainer
from repro.train.trainer import TrainerConfig as JTrainerConfig
from repro_torch.bridge import (opt_state_from_jax, params_from_jax,
                                tree_to_numpy)
from repro_torch.configs.base import ArchConfig, dense_stack
from repro_torch.configs.registry import get_smoke_config
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import linear_scan as ls
from repro_torch.kernels import ops, ref
from repro_torch.models.model import init_params
from repro_torch.optim.adamw import (AdamWState, adamw_init, adamw_update,
                                     cosine_schedule)
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.train_step import make_train_step, value_and_grad
from repro_torch.train.trainer import StragglerMonitor, Trainer, TrainerConfig

ROOT = pathlib.Path(__file__).resolve().parents[1]
GRAD_ARCHS = ["stablelm_12b", "zamba2_2p7b", "rwkv6_1p6b", "gemma2_27b",
              "olmoe_1b_7b", "deepseek_v3_671b", "whisper_small"]
B, S = 2, 12
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
STEP_TOL = 1e-3
HISTORY_TOL = 1e-4

TINY = ArchConfig(
    name="tiny", d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=128,
    groups=dense_stack(2), remat="none", dtype="float32")
J_TINY = JArchConfig(
    name="tiny", d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=128,
    groups=j_dense_stack(2), remat="none", dtype="float32")


def _named(tree, prefix=""):
    """``[(path, f32 numpy)]``, keys sorted, for either package's tree."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _named(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, torch.Tensor):
        return [(prefix, tree.detach().float().numpy())]
    return [(prefix, np.asarray(tree, np.float32))]


def _batch(cfg, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    if cfg.n_frontend_tokens:
        batch["frontend"] = 0.02 * rng.standard_normal(
            (B, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)
    return batch


@functools.lru_cache(maxsize=None)
def _f32_weights(arch):
    """The reference's smoke weights with every leaf cast to f32, in both
    packages."""
    cfg = j_smoke(arch).scaled(dtype="float32")
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      j_init(cfg, jax.random.PRNGKey(1)))
    return jp, jax.device_get(jp)


def _port_inputs(arch, remat=None):
    cfg = get_smoke_config(arch).scaled(dtype="float32")
    if remat is not None:
        cfg = cfg.scaled(remat=remat)
    _, host = _f32_weights(arch)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    return cfg, params_from_jax(host), batch


def _assert_grads_close(got, want, tol=GRAD_TOL):
    got, want = _named(got), _named(want)
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, a), (_, b) in zip(got, want):
        diff = np.abs(a - b)
        scale = max(1.0, float(np.abs(b).max()))
        assert diff.max() <= tol * scale, (k, diff.max(), scale)
        nb = float(np.linalg.norm(b))
        if nb > 0:
            assert np.linalg.norm(a - b) / nb <= tol, (k, nb)


# ----------------------------------------------------------------------------
# data pipeline, schedule, AdamW
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("step,shard", [(0, 0), (1, 0), (7, 1), (123, 3)])
def test_pipeline_batches_bit_equal(step, shard):
    kw = dict(vocab=1000, seq_len=48, global_batch=8, n_shards=4, seed=11)
    a = TokenPipeline(DataConfig(**kw)).batch(step, shard)
    b = JTokenPipeline(JDataConfig(**kw)).batch(step, shard)
    for k in ("tokens", "targets"):
        assert a[k].dtype == b[k].dtype
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("step", [0, 1, 20, 510, 1000])
def test_cosine_schedule_matches(step):
    mine = cosine_schedule(3e-4, warmup=20, total=1000)(
        torch.tensor(step, dtype=torch.int32))
    want = jadamw.cosine_schedule(3e-4, warmup=20, total=1000)(
        jnp.asarray(step, jnp.int32))
    assert mine.dtype == torch.float32
    np.testing.assert_allclose(float(mine), float(want), rtol=1e-7, atol=0)


def _random_tree(rng, dtype):
    shapes = {"a": (5, 7), "b": {"c": (3,), "d": (2, 4, 3)}, "e": (11,)}

    def make(s):
        if isinstance(s, dict):
            return {k: make(v) for k, v in s.items()}
        return rng.standard_normal(s).astype(np.float32).astype(dtype)

    return make(shapes)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(dtype):
    """Three updates from a random state, one with clipping active."""
    npdt = np.float32 if dtype == "float32" else ml_dtypes.bfloat16
    rng = np.random.default_rng(4)
    params = _random_tree(rng, npdt)
    jp = jax.tree.map(jnp.asarray, params)
    tp = params_from_jax(params)
    jst, tst = jadamw.adamw_init(jp), adamw_init(tp)
    jlr = jadamw.cosine_schedule(1e-2, warmup=2, total=10)
    tlr = cosine_schedule(1e-2, warmup=2, total=10)
    for i, gscale in enumerate((0.1, 3.0, 0.5)):
        grads = jax.tree.map(lambda a: (gscale * rng.standard_normal(
            a.shape)).astype(np.float32).astype(npdt), params)
        jp, jst, jm = jadamw.adamw_update(
            jax.tree.map(jnp.asarray, grads), jst, jp, lr=jlr)
        tp, tst, tm = adamw_update(params_from_jax(grads), tst, tp, lr=tlr)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-7)
        assert int(tst.step) == int(jst.step) == i + 1
        for tree_t, tree_j in ((tst.m, jst.m), (tst.v, jst.v)):
            for (k, a), (_, b) in zip(_named(tree_t), _named(tree_j)):
                np.testing.assert_allclose(a, b, atol=1e-6, err_msg=k)
        for (k, a), (_, b) in zip(_named(tp), _named(jp)):
            if dtype == "float32":
                np.testing.assert_allclose(a, b, atol=1e-6, err_msg=k)
            else:
                ulp = np.abs(b) * 2.0 ** -7 + 1e-30
                assert (np.abs(a - b) <= ulp).all(), k


# ----------------------------------------------------------------------------
# the loss and its gradients
# ----------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_value_and_grad(arch):
    cfg = j_smoke(arch).scaled(dtype="float32")
    jp, _ = _f32_weights(arch)
    batch = {k: jnp.asarray(v) for k, v in _batch(cfg).items()}
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        functools.partial(j_loss_fn, cfg=cfg), has_aux=True))(jp, batch)
    return float(loss), jax.device_get(metrics), jax.device_get(grads)


@pytest.mark.parametrize("arch", GRAD_ARCHS)
def test_loss_and_every_grad_match_reference(arch):
    want_loss, want_metrics, want_grads = _jax_value_and_grad(arch)
    cfg, params, batch = _port_inputs(arch)
    (loss, metrics), grads = value_and_grad(params, batch, cfg)
    assert sorted(metrics) == sorted(want_metrics)
    for k in metrics:
        assert abs(float(metrics[k]) - float(want_metrics[k])) <= LOSS_TOL, k
    assert abs(float(loss) - want_loss) <= LOSS_TOL
    if cfg.mtp:
        assert float(metrics["mtp"]) > 0
        for _, g in _named(grads["mtp"]):
            assert np.abs(g).max() > 0
    _assert_grads_close(grads, want_grads)


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_gives_the_same_grads(remat):
    """zamba2 (the shared block under the checkpoint, the scan) and
    deepseek (MLA, MoE): remat recomputes the same ops, so bit-equal."""
    for arch in ("zamba2_2p7b", "deepseek_v3_671b"):
        cfg, params, batch = _port_inputs(arch, remat="none")
        (l0, _), g0 = value_and_grad(params, batch, cfg)
        cfg_r = cfg.scaled(remat=remat)
        (l1, _), g1 = value_and_grad(params, batch, cfg_r)
        assert float(l0) == float(l1)
        for (k, a), (_, b) in zip(_named(g1), _named(g0)):
            np.testing.assert_array_equal(a, b, err_msg=k)


def test_train_step_matches_reference_after_two_steps():
    """Two ``make_train_step`` steps (loss, AdamW) on deepseek's smoke
    config (MLA, MoE, MTP): the new params, f32 leaves."""
    arch = "deepseek_v3_671b"
    jcfg = j_smoke(arch).scaled(dtype="float32")
    jp, host = _f32_weights(arch)
    cfg = get_smoke_config(arch).scaled(dtype="float32")
    tp = params_from_jax(host)
    jlr = jadamw.cosine_schedule(1e-3, warmup=1, total=4)
    tlr = cosine_schedule(1e-3, warmup=1, total=4)
    jstep = jax.jit(j_make_train_step(jcfg, lr=jlr))
    tstep = make_train_step(cfg, lr=tlr)
    jst, tst = jadamw.adamw_init(jp), adamw_init(tp)
    for i in range(2):
        batch = _batch(cfg, seed=10 + i)
        jp, jst, jm = jstep(jp, jst, {k: jnp.asarray(v)
                                      for k, v in batch.items()})
        tp, tst, tm = tstep(tp, tst, {k: torch.from_numpy(v)
                                      for k, v in batch.items()})
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-5, err_msg=k)
    moved = 2 * sum(float(tlr(torch.tensor(i + 1))) for i in range(2))
    for (k, a), (_, b), (_, p0) in zip(_named(tp), _named(jax.device_get(jp)),
                                       _named(host)):
        assert np.abs(a - b).max() <= moved, k
        assert np.linalg.norm(a - b) <= STEP_TOL * np.linalg.norm(b - p0), k


# ----------------------------------------------------------------------------
# the kernels' autograd.Functions
# ----------------------------------------------------------------------------


def _leaf(rng, shape, scale=1.0):
    return torch.from_numpy((scale * rng.standard_normal(shape)).astype(
        np.float32)).requires_grad_(True)


def _grads_both_ways(fn_ops, fn_ref, ins, rng):
    out = fn_ops(*ins)
    g = torch.from_numpy(rng.standard_normal(out.shape).astype(np.float32))
    got = torch.autograd.grad(out, [t for t in ins if t is not None], g)
    out_r = fn_ref(*ins)
    want = torch.autograd.grad(out_r, [t for t in ins if t is not None], g)
    assert torch.equal(out, out_r)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    return got


@pytest.mark.parametrize("case", ["causal_gqa", "window_softcap",
                                  "cross_dv"])
def test_flash_function_cpu_grads_bit_equal(case):
    rng = np.random.default_rng(5)
    Sq, Sk, H, Hkv, D, Dv = {"causal_gqa": (9, 9, 4, 2, 8, 8),
                             "window_softcap": (10, 10, 2, 2, 8, 8),
                             "cross_dv": (6, 11, 4, 4, 12, 8)}[case]
    kw = {"causal_gqa": dict(causal=True),
          "window_softcap": dict(causal=True, window=4, softcap=5.0),
          "cross_dv": dict(causal=False)}[case]
    ins = [_leaf(rng, (2, Sq, H, D)), _leaf(rng, (2, Sk, Hkv, D)),
           _leaf(rng, (2, Sk, Hkv, Dv))]
    _grads_both_ways(
        lambda q, k, v: ops.flash_attention(q, k, v, impl="cuda", **kw),
        lambda q, k, v: ref.flash_attention_ref(q, k, v, **kw), ins, rng)


@pytest.mark.parametrize("case", ["mamba2_expand", "rwkv6_bonus"])
def test_scan_function_cpu_grads_bit_equal(case):
    """Mamba2's B and C as stride-0 ``expand`` views over the heads (the
    Function returns full-shaped grads, the ``expand`` sums them), and
    RWKV6's vector decay with the bonus."""
    rng = np.random.default_rng(6)
    Bn, T, H, K, Vd = 2, 13, 3, 4, 5
    if case == "mamba2_expand":
        bm, cm = _leaf(rng, (Bn, T, K)), _leaf(rng, (Bn, T, K))
        v = _leaf(rng, (Bn, T, H, Vd))
        ld = torch.from_numpy(-np.abs(rng.standard_normal((Bn, T, H))
                                      ).astype(np.float32)).requires_grad_()

        def run(scan, bm, cm, v, ld):
            q = cm[:, :, None].expand(Bn, T, H, K)
            k = bm[:, :, None].expand(Bn, T, H, K)
            return scan(q, k, v, ld, None)

        ins = [bm, cm, v, ld]
        chunk = 4
    else:
        q, k = _leaf(rng, (Bn, T, H, K)), _leaf(rng, (Bn, T, H, K))
        v = _leaf(rng, (Bn, T, H, Vd))
        ld = torch.from_numpy(-np.abs(rng.standard_normal((Bn, T, H, K))
                                      ).astype(np.float32)).requires_grad_()
        u = _leaf(rng, (H, K), 0.5)

        def run(scan, q, k, v, ld, u):
            return scan(q, k, v, ld, u)

        ins = [q, k, v, ld, u]
        chunk = 5
    via_ops = lambda q, k, v, ld, u: ops.linear_scan(
        q, k, v, ld, bonus=u, chunk=chunk, impl="cuda")
    via_ref = lambda q, k, v, ld, u: ref.linear_scan_ref(
        q, k, v, ld, bonus=u, chunk=chunk)
    got = _grads_both_ways(lambda *a: run(via_ops, *a)[0],
                           lambda *a: run(via_ref, *a)[0], ins, rng)
    assert all(g.shape == t.shape for g, t in zip(got, ins))
    _, state = run(via_ops, *ins)
    assert not state.requires_grad     # train mode never reads it


@pytest.mark.parametrize("vector", [False, True])
def test_scan_ref_f64_evaluation(vector):
    """``linear_scan_ref(acc=torch.float64)``, the card's yardstick for the
    rwkv6 whole-model gradient: the default is bit-equal to acc=f32, and
    the f64 evaluation agrees with the f32 one within 1e-5 of the output's
    scale (f32's rounding of the same function) and returns an f64 state."""
    rng = np.random.default_rng(7)
    Bn, T, H, K, Vd = 2, 37, 3, 8, 6
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((Bn, T, H, K), (Bn, T, H, K), (Bn, T, H, Vd)))
    ld = torch.from_numpy(-np.abs(rng.standard_normal(
        (Bn, T, H, K) if vector else (Bn, T, H))).astype(np.float32))
    u = torch.from_numpy(rng.standard_normal((H, K)).astype(np.float32)
                         ) if vector else None
    out, st = ref.linear_scan_ref(q, k, v, ld, bonus=u, chunk=16)
    out32, st32 = ref.linear_scan_ref(q, k, v, ld, bonus=u, chunk=16,
                                      acc=torch.float32)
    assert torch.equal(out, out32) and torch.equal(st, st32)
    out64, st64 = ref.linear_scan_ref(q, k, v, ld, bonus=u, chunk=16,
                                      acc=torch.float64)
    assert out64.dtype == torch.float32 and st64.dtype == torch.float64
    scale = float(out64.abs().max())
    assert float((out64 - out).abs().max()) <= 1e-5 * scale
    assert float((st64.float() - st).abs().max()) <= 1e-5 * float(
        st64.abs().max())


def _meta(*shape):
    return torch.empty(shape, device="meta").requires_grad_(True)


@pytest.mark.parametrize("kernel", ["flash_attention", "linear_scan"])
def test_raw_wrappers_refuse_inputs_requiring_grad(kernel):
    """The raw wrappers would cut the graph (their output has no
    ``grad_fn``): with grad mode on they raise on inputs that require
    grad, before any launch; the same inputs pass the guard under
    ``no_grad`` (where the meta tensors then fail the kernel's own
    checks, never reaching a launch)."""
    if kernel == "flash_attention":
        call = lambda: fa.flash_attention(_meta(1, 8, 2, 16),
                                          _meta(1, 8, 2, 16),
                                          _meta(1, 8, 2, 16))
    else:
        call = lambda: ls.linear_scan(_meta(1, 8, 2, 16), _meta(1, 8, 2, 16),
                                      _meta(1, 8, 2, 16), _meta(1, 8, 2))
    with pytest.raises(RuntimeError, match="no gradient"):
        call()
    with torch.no_grad(), pytest.raises((ValueError, RuntimeError)) as e:
        call()
    assert "no gradient" not in str(e.value)


# ----------------------------------------------------------------------------
# the trainer and its checkpoints (the reference's tests/test_trainer.py)
# ----------------------------------------------------------------------------


def _mk(tmp_path, steps=24, **kw):
    tcfg = TrainerConfig(steps=steps, ckpt_every=8, log_every=1000,
                         ckpt_dir=str(tmp_path / "ckpt"), lr_peak=2e-3, **kw)
    dcfg = DataConfig(vocab=TINY.vocab, seq_len=32, global_batch=4, seed=3)
    return Trainer(TINY, tcfg, dcfg, device="cpu")


def test_loss_decreases(tmp_path):
    out = _mk(tmp_path).run()
    first = np.mean([h["loss"] for h in out["history"][:4]])
    last = np.mean([h["loss"] for h in out["history"][-4:]])
    assert last < first - 0.1, f"no learning: {first} -> {last}"


def test_checkpoint_restart_resumes_stream(tmp_path):
    a = _mk(tmp_path / "a").run()
    tr1 = _mk(tmp_path / "b", steps=24)
    tr1.run(max_steps=16)            # checkpoints at 8 and 16
    tr1.ckpt.wait()
    tr2 = _mk(tmp_path / "b", steps=24)
    b = tr2.run()                    # restores at 16, continues
    assert b["step"] == 24
    la = a["history"][-1]["loss"]
    lb = b["history"][-1]["loss"]
    assert abs(la - lb) < 2e-2, (la, lb)


def test_straggler_monitor_flags_outliers():
    m = StragglerMonitor(factor=3.0, alpha=0.5)
    for step in range(10):
        assert not m.observe(step, 0.1)
    assert m.observe(10, 1.0)        # 10x the EMA
    assert m.events and m.events[0]["step"] == 10
    assert not m.observe(11, 0.12)   # EMA not poisoned by the outlier


def test_async_checkpoint_reservation(tmp_path):
    ckpt = CheckpointManager(str(tmp_path), keep=2)
    state = {"w": torch.ones((256, 256))}
    ckpt.save(1, state, async_=True)
    ckpt.save(2, state, async_=True)   # must wait for write 1 (reservation)
    ckpt.wait()
    assert ckpt.latest_step() == 2
    restored, _ = ckpt.restore({"w": torch.zeros((256, 256))})
    assert torch.equal(restored["w"], state["w"])
    for s in (3, 4, 5):
        ckpt.save(s, state)
    assert ckpt.latest_step() == 5
    assert len(list(pathlib.Path(tmp_path).glob("step_*"))) == 2


def test_elastic_restore_dtype_and_structure(tmp_path):
    ckpt = CheckpointManager(str(tmp_path))
    state = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
             "nest": {"b": torch.tensor([1.0, 1 + 2 ** -9, 3.0, 4.0])}}
    ckpt.save(7, state)
    template = {"a": np.zeros((2, 3), np.float32),
                "nest": {"b": torch.zeros(4, dtype=torch.bfloat16)}}
    restored, meta = ckpt.restore(template)
    assert meta["step"] == 7
    np.testing.assert_array_equal(restored["a"], state["a"].numpy())
    assert restored["nest"]["b"].dtype == torch.bfloat16
    # f32 -> bf16 rounds to nearest even: 1 + 2^-9 is a tie, to 1.0
    assert torch.equal(restored["nest"]["b"],
                       state["nest"]["b"].to(torch.bfloat16))
    assert float(restored["nest"]["b"][1]) == 1.0


def test_data_pipeline_determinism_and_sharding():
    p = TokenPipeline(DataConfig(vocab=100, seq_len=16, global_batch=8,
                                 n_shards=2, seed=5))
    b1, b2, b3 = p.batch(3, shard=0), p.batch(3, shard=0), p.batch(3, 1)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    assert not np.array_equal(b1["tokens"], b3["tokens"])
    assert (b1["tokens"][:, 1:] == b1["targets"][:, :-1]).all()


def test_trainer_history_matches_reference(tmp_path):
    """The reference ``Trainer`` and the port's, both on the reference's
    ``TINY`` from the reference's initial params (bridged), 8 steps."""
    kw = dict(steps=8, ckpt_every=100, log_every=1000, lr_peak=2e-3)
    dkw = dict(vocab=TINY.vocab, seq_len=32, global_batch=4, seed=3)
    jtr = JTrainer(J_TINY, JTrainerConfig(ckpt_dir=str(tmp_path / "j"), **kw),
                   JDataConfig(**dkw))
    jp, jo = jtr.init_state()
    tp = params_from_jax(jax.device_get(jp))
    to = opt_state_from_jax(jax.device_get(jo))
    want = [h["loss"] for h in jtr.run(params=jp, opt_state=jo)["history"]]
    tr = Trainer(TINY, TrainerConfig(ckpt_dir=str(tmp_path / "t"), **kw),
                 DataConfig(**dkw), device="cpu")
    got = [h["loss"] for h in tr.run(params=tp, opt_state=to)["history"]]
    assert len(got) == len(want) == 8
    np.testing.assert_allclose(got, want, atol=HISTORY_TOL)
    assert got[-1] < got[0]


@functools.lru_cache(maxsize=None)
def _smoke_state():
    """bf16 smoke params (stablelm: partial rope, qk-norm) and an AdamW
    state after one step, in both packages."""
    arch = "stablelm_12b"
    jcfg = j_smoke(arch)
    jp = j_init(jcfg, jax.random.PRNGKey(2))
    jst = jadamw.adamw_init(jp)
    batch = {k: jnp.asarray(v) for k, v in _batch(jcfg, seed=3).items()}
    jp, jst, _ = jax.jit(j_make_train_step(jcfg))(jp, jst, batch)
    return jcfg, jax.device_get(jp), jax.device_get(jst)


def _assert_state_equal(jstate, tstate):
    jp, jst = jstate["params"], jstate["opt"]
    tnp = tree_to_numpy(tstate["params"])
    tst = tree_to_numpy(tstate["opt"])
    assert jst.step.shape == tst.step.shape == ()
    assert int(jst.step) == int(tst.step)
    for a_tree, b_tree in ((jp, tnp), (jst.m, tst.m), (jst.v, tst.v)):
        for (k, a), (_, b) in zip(_named_np(a_tree), _named_np(b_tree)):
            assert a.dtype == b.dtype and a.shape == b.shape, k
            np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8),
                                          err_msg=k)


def _named_np(tree, prefix=""):
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _named_np(tree[k], f"{prefix}/{k}")]
    return [(prefix, np.asarray(tree))]


def test_port_checkpoint_restores_in_reference(tmp_path):
    jcfg, jp, jst = _smoke_state()
    tstate = {"params": params_from_jax(jp), "opt": opt_state_from_jax(jst)}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(5, tstate, extra={"data_step": 5}, async_=True)
    mgr.wait()      # the writer thread's files before the reference reads
    tmpl_p = j_init(jcfg, jax.random.PRNGKey(0))
    restored, meta = JCheckpointManager(str(tmp_path)).restore(
        {"params": tmpl_p, "opt": jadamw.adamw_init(tmpl_p)})
    assert meta["step"] == 5 and meta["extra"]["data_step"] == 5
    restored = jax.device_get(restored)
    _assert_state_equal(restored, tstate)


def test_reference_checkpoint_restores_in_port(tmp_path):
    jcfg, jp, jst = _smoke_state()
    JCheckpointManager(str(tmp_path)).save(
        9, {"params": jp, "opt": jst}, extra={"data_step": 9})
    cfg = get_smoke_config("stablelm_12b")
    tmpl = init_params(cfg, device="cpu")
    mgr = CheckpointManager(str(tmp_path))
    restored, meta = mgr.restore({"params": tmpl, "opt": adamw_init(tmpl)})
    assert meta["step"] == 9
    keys = set(np.load(tmp_path / "step_00000009" / "leaves.npz").files)
    assert {"opt/.step", "params/embed", "opt/.m/embed",
            "opt/.v/final_norm"} <= keys
    assert isinstance(restored["opt"], AdamWState)
    _assert_state_equal({"params": jp, "opt": jst}, restored)


def test_launcher_prints_the_reference_line(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "zamba2_2p7b", "--steps", "3", "--seq-len", "16", "--device", "cpu",
         "--ckpt-dir", str(tmp_path / "ck")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    last = res.stdout.strip().splitlines()[-1]
    assert re.fullmatch(r"\[launch\.train\] zamba2-smoke: done at step 3, "
                        r"final loss \d+\.\d{4}, stragglers \d+", last), last
