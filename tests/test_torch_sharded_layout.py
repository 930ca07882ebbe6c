"""The sharded layout in which each rank does its own share of the work,
8 gloo ranks on the CPU, each case against the unsharded port on the same
weights (f32 parameters and compute, weights from a seed):

* a decode step of olmoe-smoke on (data=2, model=4): S = 1 does not
  divide ``model``, so the MoE routes the whole batch and each rank runs
  its own experts on the weights where they lie; every matrix of the
  step is used where it lies (``layers.linear``), the embedding too;
* olmoe-smoke trained at S = 30 (no expert parallelism either): loss and
  every grad;
* a decode step of deepseek-smoke on (2, 4): MLA's compressed cache holds
  ``model`` on its sequence, and the softmax is combined over the slices;
* llama-vision-smoke (4 heads, 2 kv heads over 4: each rank's query head
  shares one kv head and projects it), gemma2-smoke (post-norms, a
  window) and zamba2-smoke (Mamba2 by heads: in_proj's and the conv's
  weights re-laid, cut where their shards do not split them) trained on
  (2, 4); llama-vision's and zamba2's prefill logits and every leaf of
  their caches;
* whisper-smoke (4 heads over model=8: sequence slices for the encoder,
  the decoder and the cross attention) trained on (1, 8);
* decode steps of rwkv6-smoke at batch 1 on (4, 2) (the batch whole on
  every rank, long_500k's case) and zamba2-smoke on (2, 4)."""

import os

import numpy as np
import pytest
import torch

from repro_torch.parallel.collectives import spawn_ranks

WORLD = 8
DECODE = ["olmoe_1b_7b", "deepseek_v3_671b", "rwkv6_1p6b", "zamba2_2p7b"]
TRAIN = ["olmoe_1b_7b", "llama32_vision_90b", "gemma2_27b", "zamba2_2p7b",
         "whisper_small"]
# trained, then prefilled: the groups layout's cache on sequence slices,
# Mamba2's by heads
PREFILL = ["llama32_vision_90b", "zamba2_2p7b"]
# f32 throughout: only the order of the sums differs between the layouts
LOGITS_REL = 1e-5
GRAD_REL = 1e-4


def _f32(tree):
    if isinstance(tree, dict):
        return {k: _f32(v) for k, v in tree.items()}
    return tree.float()


def _cfg(arch):
    from repro_torch.configs.registry import get_smoke_config
    return get_smoke_config(arch).scaled(dtype="float32")


def _params(cfg):
    from repro_torch.models.model import init_params
    return _f32(init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu"))


def _batch_dt(sh, mesh, t):
    return sh.distribute(t, mesh, sh.spec_for(
        mesh, ("batch",) + (None,) * (t.dim() - 1), tuple(t.shape)))


def _decode(arch, B, sh, mesh, res):
    import copy
    from repro_torch.models.model import (apply_model, cache_axes,
                                          init_cache, params_logical_axes)
    cfg = _cfg(arch)
    params = _params(cfg)
    rng = np.random.default_rng(7)
    cache = init_cache(cfg, B, 16, dtype="float32", device="cpu")

    def fill(t):
        if isinstance(t, dict):
            for v in t.values():
                fill(v)
        else:
            t.copy_(torch.from_numpy(0.5 * rng.standard_normal(
                tuple(t.shape)).astype(np.float32)).to(t.dtype))
    fill(cache["groups"])
    cache["pos"].fill_(12)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (B, 1)))
    c_u = copy.deepcopy(cache)
    res[f"{arch}/dec_u"] = apply_model(params, toks, cfg=cfg, mode="decode",
                                       cache=c_u)[0].detach().numpy()
    sh.set_mesh(mesh)
    dc = sh.tree_distribute(mesh, cache, cache_axes(cfg))
    got = apply_model(sh.tree_distribute(mesh, params,
                                         params_logical_axes(cfg)),
                      _batch_dt(sh, mesh, toks), cfg=cfg, mode="decode",
                      cache=dc)[0]
    res[f"{arch}/dec_s"] = sh.full(got).detach().numpy()
    for path, a, b in _leaves(dc["groups"], c_u["groups"]):
        res[f"{arch}/cache_s/{path}"] = sh.full(a).float().numpy()
        res[f"{arch}/cache_u/{path}"] = b.float().numpy()
    sh.set_mesh(None)


def _leaves(a, b, prefix=""):
    if isinstance(a, dict):
        for k in a:
            yield from _leaves(a[k], b[k], f"{prefix}{k}/")
    else:
        yield prefix[:-1], a, b


def _train(arch, S, sh, mesh, res):
    from repro_torch.models.model import params_logical_axes
    from repro_torch.train.train_step import value_and_grad
    cfg = _cfg(arch)
    params = _params(cfg)
    rng = np.random.default_rng(8)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (4, S)))
    batch = {"tokens": toks, "targets": torch.roll(toks, -1, 1)}
    if cfg.n_frontend_tokens:
        batch["frontend"] = torch.from_numpy(0.02 * rng.standard_normal(
            (4, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32))
    (loss_u, _), g_u = value_and_grad(params, batch, cfg)
    sh.set_mesh(mesh)
    db = {k: _batch_dt(sh, mesh, v) for k, v in batch.items()}
    (loss_s, _), g_s = value_and_grad(
        sh.tree_distribute(mesh, params, params_logical_axes(cfg)), db, cfg)
    res[f"{arch}/loss_s"] = float(sh.full(loss_s))
    res[f"{arch}/loss_u"] = float(loss_u)
    for path, a, b in _leaves(g_s, g_u):
        res[f"{arch}/grad_s/{path}"] = sh.full(a).float().numpy()
        res[f"{arch}/grad_u/{path}"] = b.float().numpy()
    if arch in PREFILL:
        from repro_torch.train.train_step import make_prefill_step
        lg, cache_s = make_prefill_step(cfg)(
            sh.tree_distribute(mesh, params, params_logical_axes(cfg)),
            db["tokens"], db.get("frontend"))
        res[f"{arch}/prefill_s"] = sh.full(lg).detach().numpy()
        sh.set_mesh(None)
        lg, cache_u = make_prefill_step(cfg)(params, toks,
                                             batch.get("frontend"))
        res[f"{arch}/prefill_u"] = lg.detach().numpy()
        for path, a, b in _leaves(cache_s["groups"], cache_u["groups"]):
            res[f"{arch}/pcache_s/{path}"] = sh.full(a).detach().numpy()
            res[f"{arch}/pcache_u/{path}"] = b.detach().numpy()
        if arch == "llama32_vision_90b":
            res[f"{arch}/prefill_k_s"] = res[f"{arch}/pcache_s/g0/p2/k"]
            res[f"{arch}/prefill_k_u"] = res[f"{arch}/pcache_u/g0/p2/k"]
    sh.set_mesh(None)


def _ranks(rank, world, init, out_dir):
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel import collectives
    from repro_torch.parallel import sharding as sh
    torch.set_num_threads(1)
    collectives.init("gloo", rank, world, init)
    res = {}
    try:
        mesh = make_host_mesh((2, 4), device_type="cpu")
        for arch in DECODE:
            if arch == "rwkv6_1p6b":    # 2 heads: model=2; batch 1 whole
                _decode(arch, 1, sh, make_host_mesh((4, 2),
                                                    device_type="cpu"), res)
            else:
                _decode(arch, 4, sh, mesh, res)
        for arch in TRAIN[:-1]:
            _train(arch, 30 if arch == "olmoe_1b_7b" else 16, sh, mesh, res)
        _train("whisper_small", 16, sh, make_host_mesh((1, 8),
                                                       device_type="cpu"),
               res)
        if rank == 0:
            np.savez(os.path.join(out_dir, "port.npz"), **res)
        dist.barrier()
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded_layout")
    spawn_ranks(_ranks, WORLD, (str(tmp),), timeout_s=400)
    return dict(np.load(tmp / "port.npz"))


def _rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("arch", DECODE)
def test_decode_step_matches_unsharded(runs, arch):
    assert _rel(runs[f"{arch}/dec_s"], runs[f"{arch}/dec_u"]) <= LOGITS_REL
    names = [k.split("/", 2)[2] for k in runs
             if k.startswith(f"{arch}/cache_s/")]
    assert names
    for n in names:
        got, want = runs[f"{arch}/cache_s/{n}"], runs[f"{arch}/cache_u/{n}"]
        assert _rel(got, want) <= LOGITS_REL, n


@pytest.mark.parametrize("arch", TRAIN)
def test_train_grads_match_unsharded(runs, arch):
    assert runs[f"{arch}/loss_s"] == pytest.approx(runs[f"{arch}/loss_u"],
                                                   rel=LOGITS_REL)
    names = [k.split("/", 2)[2] for k in runs
             if k.startswith(f"{arch}/grad_s/")]
    assert names
    for n in names:
        got, want = runs[f"{arch}/grad_s/{n}"], runs[f"{arch}/grad_u/{n}"]
        if np.abs(want).max() == 0:
            assert np.abs(got).max() == 0, n
            continue
        assert _rel(got, want) <= GRAD_REL, n


def test_groups_layout_prefill_matches_unsharded(runs):
    arch = "llama32_vision_90b"
    assert _rel(runs[f"{arch}/prefill_s"], runs[f"{arch}/prefill_u"]) \
        <= LOGITS_REL
    assert _rel(runs[f"{arch}/prefill_k_s"], runs[f"{arch}/prefill_k_u"]) \
        <= LOGITS_REL


@pytest.mark.parametrize("arch", PREFILL)
def test_prefill_cache_matches_unsharded(runs, arch):
    """A sharded prefill's logits and every leaf of its cache (laid out as
    decode reads it) against the unsharded prefill's."""
    assert _rel(runs[f"{arch}/prefill_s"], runs[f"{arch}/prefill_u"]) \
        <= LOGITS_REL
    names = [k.split("/", 2)[2] for k in runs
             if k.startswith(f"{arch}/pcache_s/")]
    assert names
    for n in names:
        got, want = runs[f"{arch}/pcache_s/{n}"], runs[f"{arch}/pcache_u/{n}"]
        assert _rel(got, want) <= LOGITS_REL, n
