"""The port's ServeEngine on the CPU: token parity with the reference
engine, publish-on-ping serving with prefix sharing and no use-after-free,
the deliberately unsafe policy tripping the tripwires, and the refusal to
fall back to the CPU silently.

Mirrors ``tests/test_kv_store.py`` (paged token parity, paged serving under
an SMR policy) and ``tests/test_serve_multi_engine.py`` (the unsafe
policy's use-after-free).
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import ArchConfig as JArch
from repro.configs.base import dense_stack as j_stack
from repro.models.model import init_params as j_init
from repro.serve.engine import ServeEngine as JEngine
from repro_torch.bridge import params_from_jax
from repro_torch.configs.base import ArchConfig, dense_stack
from repro_torch.configs.registry import get_smoke_config
from repro_torch.core.sim.engine import UseAfterFree
from repro_torch.models.model import init_params
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.worker import Request

PAGE = 4
PLAIN = dict(name="kv-plain", d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
             vocab=64, remat="none", dtype="float32")
FANCY = dict(name="kv-fancy", d_model=32, n_heads=4, n_kv_heads=4, d_ff=48,
             vocab=80, remat="none", dtype="float32", qk_norm=True,
             post_norms=True, attn_softcap=30.0, rope_pct=0.5,
             tie_embeddings=True)
CONFIGS = {
    "plain": (JArch(groups=j_stack(2), **PLAIN),
              ArchConfig(groups=dense_stack(2), **PLAIN)),
    "fancy": (JArch(groups=j_stack(3), **FANCY),
              ArchConfig(groups=dense_stack(3), **FANCY)),
}
CFG = CONFIGS["plain"][1]
ENGINE_KW = dict(max_batch=4, page_size=PAGE, num_pages=64, max_seq=32,
                 kv_store="paged")


def _run(eng, prompts, max_new=4):
    eng.start()
    reqs = [eng.submit(p, max_new=max_new) for p in prompts]
    for r in reqs:
        assert r.done.wait(timeout=300)
    eng.stop()
    assert eng.error is None, f"engine failed: {eng.error!r}"
    return [list(r.out) for r in reqs]


@pytest.mark.parametrize("name", list(CONFIGS))
def test_token_parity_with_reference_engine(name):
    """The prompt set of tests/test_kv_store.py's parity test -- a
    single-token tail page, a page-aligned prompt, a one-token prompt and
    a longer one -- decodes to the same tokens in both engines, with the
    same weights."""
    jcfg, tcfg = CONFIGS[name]
    jparams = j_init(jcfg, jax.random.PRNGKey(1))
    tparams = params_from_jax(jax.device_get(jparams))
    rng = np.random.default_rng(3)
    prompts = [[1, 9, 3, 5, 2], [7, 2, 8, 6, 4, 1, 3, 5], [11],
               [int(x) for x in rng.integers(1, tcfg.vocab, 11)]]
    want = _run(JEngine(jcfg, jparams, **ENGINE_KW), prompts)
    got = _run(ServeEngine(tcfg, tparams, device="cpu", **ENGINE_KW), prompts)
    assert got == want


def test_epoch_pop_serving_with_prefix_sharing_is_safe():
    """EpochPOP-pool, 2 decode engines, 1 prefill worker, prefix sharing:
    no use-after-free, every freed page poisoned, no leaks, and no
    host->device KV bytes."""
    params = init_params(CFG, torch.Generator().manual_seed(5), device="cpu")
    eng = ServeEngine(CFG, params, device="cpu", smr="EpochPOP-pool",
                      n_engines=2, prefill_workers=1, prefix_cache=True,
                      prefill_chunk=3, **ENGINE_KW)
    shared = [5, 3, 9, 1, 2, 6, 4, 8]             # two full pages
    prompts = [shared + [i + 1] for i in range(6)] + [[7, 7, 1]]
    outs = _run(eng, prompts, max_new=3)
    assert all(len(o) == 3 for o in outs)
    pool = eng.pool
    assert pool.stats.prefix_hits > 0
    pool.evict_prefixes(0)
    pool.policy.flush()
    assert pool.stats.freed > 0
    assert eng.kv_store.poisons == pool.stats.freed
    assert pool.check_no_leaks()
    assert eng.kv_copy_stats()["bytes_h2d_per_step"] == 0


@pytest.mark.parametrize("smr,trips", [("unsafe", True),
                                       ("EpochPOP-pool", False)])
def test_freeing_under_an_open_session(smr, trips):
    """Engine 1 holds a reader session over a request's pages while engine
    0 decodes it to the end and retires them.  The unsafe policy frees them
    at once: both tripwires fire (pool touch and page gather) and the pages
    hold the poison.  EpochPOP keeps them until the session closes."""
    params = init_params(CFG, torch.Generator().manual_seed(7), device="cpu")
    eng = ServeEngine(CFG, params, device="cpu", smr=smr, n_engines=2,
                      **ENGINE_KW)
    pool, store = eng.pool, eng.kv_store
    w0 = eng.workers[0]
    r = Request(rid=0, prompt=[3, 1, 4, 1, 5], max_new=2)
    assert w0._admit_blocks(r) and w0._run_prefill(r)
    blocks = list(r.all_blocks)
    pool.start_step(1)
    pool.reserve(1, blocks)
    w0.running[r.rid] = r
    while w0.running:
        pool.start_step(0)
        w0._step()
        pool.end_step(0)
    assert len(r.out) == 2
    if trips:
        with pytest.raises(UseAfterFree):
            pool.touch(1, blocks)
        with pytest.raises(UseAfterFree):
            store.assert_alive(1, blocks)
        assert float(store.k[:, blocks[0]].min()) == store.POISON
    else:
        pool.touch(1, blocks)
        store.assert_alive(1, blocks)
        pool.end_step(1)
        pool.reclaim(0)
        assert store.poisons == pool.stats.freed


def test_engine_without_device_needs_cuda(monkeypatch):
    """No device given and no CUDA: raise, never carry on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params = init_params(CFG, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(CFG, params, **ENGINE_KW)


def test_unported_paths_raise_and_name_their_slice():
    for arch, slice_ in (("olmoe_1b_7b", "MoE slice"),
                         ("deepseek_v3_671b", "MLA slice"),
                         ("whisper_small", "encoder slice")):
        with pytest.raises(NotImplementedError, match=slice_):
            init_params(get_smoke_config(arch),
                        torch.Generator().manual_seed(0), device="cpu")
    params = init_params(CFG, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(NotImplementedError, match="later slice"):
        ServeEngine(CFG, params, device="cpu", smr="HazardPtrPOP",
                    **ENGINE_KW)
    bad = CFG.scaled(groups=dense_stack(2, attn_kind="local"))
    with pytest.raises(ValueError, match="not supported"):
        ServeEngine(bad, params, device="cpu", **ENGINE_KW)
