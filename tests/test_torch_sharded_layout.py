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
  every rank, long_500k's case) and zamba2-smoke on (2, 4), at batch 4
  and at batch 1 (Mamba2 by heads in decode: in_proj's column shards and
  the conv's channel shards realigned to the rank's heads by all-to-all,
  every FSDP-sharded vector used on the rank's slice of the embed dim);
  logits and every written cache leaf (RWKV-6's ``state``, ``tm_shift``
  and ``cm_shift``; Mamba2's ``conv`` and ``ssm``, the shared attention's
  K/V);
* zamba2-smoke prefilled at batch 1 on (2, 4) and its cache handed to a
  sharded decode step (Mamba2's leaves as the prefill lays them out, the
  shared attention's K/V grown to the decode cache's length), against
  the unsharded prefill and decode;
* the greedy token from vocab-sharded logits on (2, 4)."""

import os

import numpy as np
import pytest
import torch

from repro_torch.parallel.collectives import spawn_ranks

WORLD = 8
DECODE = ["olmoe_1b_7b", "deepseek_v3_671b", "rwkv6_1p6b", "zamba2_2p7b",
          "zamba2_2p7b-b1"]
# each decode case's batch and mesh (default: batch 4 on (2, 4)); at batch
# 1 the batch is whole on every rank, long_500k's case
DECODE_AT = {"rwkv6_1p6b": (1, (4, 2)),    # 2 heads: model=2
             "zamba2_2p7b-b1": (1, (2, 4))}
# prefilled, then one decode step from the prefill's cache
HANDOFF = ["zamba2_2p7b"]
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


def _decode(case, B, sh, mesh, res):
    import copy
    from repro_torch.models.model import (apply_model, cache_axes,
                                          init_cache, params_logical_axes)
    arch = case.split("-")[0]
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
    res[f"{case}/dec_u"] = apply_model(params, toks, cfg=cfg, mode="decode",
                                       cache=c_u)[0].detach().numpy()
    sh.set_mesh(mesh)
    dc = sh.tree_distribute(mesh, cache, cache_axes(cfg))
    got = apply_model(sh.tree_distribute(mesh, params,
                                         params_logical_axes(cfg)),
                      _batch_dt(sh, mesh, toks), cfg=cfg, mode="decode",
                      cache=dc)[0]
    res[f"{case}/dec_s"] = sh.full(got).detach().numpy()
    for path, a, b in _leaves(dc["groups"], c_u["groups"]):
        res[f"{case}/cache_s/{path}"] = sh.full(a).float().numpy()
        res[f"{case}/cache_u/{path}"] = b.float().numpy()
    sh.set_mesh(None)


def _argmax(sh, mesh, res):
    """The greedy token of logits laid out as ("batch", "vocab"): random
    rows, a maximum tied across two vocab shards, a NaN in a later shard,
    a constant row; against ``argmax`` of the whole rows."""
    rng = np.random.default_rng(10)
    lg = torch.from_numpy(rng.standard_normal((4, 256)).astype(np.float32))
    lg[1, 70] = lg[1, 200] = 9.0
    lg[2, 230] = float("nan")
    lg[3] = 1.0
    res["argmax_u"] = lg.argmax(-1).numpy()
    sh.set_mesh(mesh)
    got = sh.argmax_last(sh.distribute(lg, mesh, sh.spec_for(
        mesh, ("batch", "vocab"), (4, 256))))
    res["argmax_s"] = sh.full(got).numpy()
    sh.set_mesh(None)


def _grown(cache, axes, seq, sh=None, mesh=None):
    """A prefill's cache as a decode step reads it: each leaf with a
    sequence dim (K/V) zero-padded to ``seq`` positions (under a mesh
    gathered, padded and laid out again by its axes), every other leaf
    the prefill's own tensor."""
    import torch.nn.functional as F
    out = {}
    for k, v in cache.items():
        if isinstance(v, dict):
            out[k] = _grown(v, axes[k], seq, sh, mesh)
        elif "kv_seq" in axes[k]:
            d = axes[k].index("kv_seq")
            whole = sh.full(v) if sh is not None else v
            pad = [0, 0] * (whole.dim() - 1 - d) + [0, seq - whole.shape[d]]
            whole = F.pad(whole, pad)
            out[k] = (sh.distribute(whole, mesh, sh.spec_for(
                mesh, axes[k], tuple(whole.shape))) if sh is not None
                else whole)
        else:
            out[k] = v
    return out


def _handoff(arch, S, sh, mesh, res):
    """A prefill of S tokens at batch 1, then one decode step from its
    cache, sharded on ``mesh`` and unsharded."""
    from repro_torch.models.model import (apply_model, cache_axes,
                                          params_logical_axes)
    from repro_torch.train.train_step import make_prefill_step
    cfg = _cfg(arch)
    params = _params(cfg)
    rng = np.random.default_rng(9)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (1, S + 1)))
    axes = cache_axes(cfg)["groups"]
    lg_u, c_u = make_prefill_step(cfg)(params, toks[:, :S])
    c_u = {"pos": c_u["pos"], "groups": _grown(c_u["groups"], axes, 16)}
    res[f"{arch}/hand_prefill_u"] = lg_u.detach().numpy()
    res[f"{arch}/hand_dec_u"] = apply_model(
        params, toks[:, S:], cfg=cfg, mode="decode",
        cache=c_u)[0].detach().numpy()
    sh.set_mesh(mesh)
    dp = sh.tree_distribute(mesh, params, params_logical_axes(cfg))
    lg_s, c_s = make_prefill_step(cfg)(dp, _batch_dt(sh, mesh, toks[:, :S]))
    res[f"{arch}/hand_prefill_s"] = sh.full(lg_s).detach().numpy()
    c_s = {"pos": sh.distribute(c_s["pos"], mesh, sh.spec_for(
               mesh, ("batch",), (1,))),
           "groups": _grown(c_s["groups"], axes, 16, sh, mesh)}
    got = apply_model(dp, _batch_dt(sh, mesh, toks[:, S:]), cfg=cfg,
                      mode="decode", cache=c_s)[0]
    res[f"{arch}/hand_dec_s"] = sh.full(got).detach().numpy()
    for path, a, b in _leaves(c_s["groups"], c_u["groups"]):
        res[f"{arch}/hand_cache_s/{path}"] = sh.full(a).float().numpy()
        res[f"{arch}/hand_cache_u/{path}"] = b.float().numpy()
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
        for case in DECODE:
            B, shape = DECODE_AT.get(case, (4, (2, 4)))
            _decode(case, B, sh, make_host_mesh(shape, device_type="cpu"),
                    res)
        for arch in HANDOFF:
            _handoff(arch, 12, sh, mesh, res)
        _argmax(sh, mesh, res)
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


def test_greedy_token_from_vocab_shards(runs):
    """Each vocab shard's (value, index) pair a row picks ``argmax``'s
    token of the whole row: ties to the lower index, a NaN first."""
    np.testing.assert_array_equal(runs["argmax_s"], runs["argmax_u"])


@pytest.mark.parametrize("arch", HANDOFF)
def test_prefill_cache_feeds_sharded_decode(runs, arch):
    """A sharded prefill's cache, as it lays it out, read by the sharded
    decode step: the prefill's and the step's logits and every cache leaf
    the step wrote against the unsharded prefill and step."""
    for what in ("hand_prefill", "hand_dec"):
        assert _rel(runs[f"{arch}/{what}_s"], runs[f"{arch}/{what}_u"]) \
            <= LOGITS_REL, what
    names = [k.split("/", 2)[2] for k in runs
             if k.startswith(f"{arch}/hand_cache_s/")]
    assert {n.rsplit("/", 1)[-1] for n in names} >= {"conv", "ssm",
                                                      "shared_k",
                                                      "shared_v"}
    for n in names:
        got = runs[f"{arch}/hand_cache_s/{n}"]
        want = runs[f"{arch}/hand_cache_u/{n}"]
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
