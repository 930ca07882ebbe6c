"""The port's async prefill pipeline on the CPU, the twin of
``tests/test_prefill_pipeline.py``: chunked against whole prefill (pages
and logits, and against the reference's chunked pages and logits from the
same bridged weights), resuming, a ping serviced within one chunk, a
partial prefill handed across workers, stop and reroute, a dead prefill
stage, and the whole pipeline's tokens against the reference engine's
under the reclaim policies.

The reference's paged runs use its XLA paged path (``impl="xla"``); its
Pallas kernel in interpret mode is held to the port elsewhere
(``tests/test_torch_kernels.py``).  Timing properties of threads (the
ping window) are asserted of the port alone.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ArchConfig as JArch
from repro.configs.base import dense_stack as j_stack
from repro.models.model import init_params as j_init
from repro.runtime.kv_store import PagedKVStore as JStore
from repro.serve.engine import ServeEngine as JEngine
from repro.serve.paged_model import prefill_kv_chunked as j_chunked
from repro_torch.bridge import params_from_jax
from repro_torch.configs.base import ArchConfig, dense_stack
from repro_torch.models.model import apply_model
from repro_torch.runtime.block_pool import BlockPool
from repro_torch.runtime.kv_store import PagedKVStore
from repro_torch.runtime.reclaim import EpochPOPPolicy, make_policy
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.paged_model import (paged_decode_step, prefill_kv,
                                           prefill_kv_chunked)
from repro_torch.serve.worker import PrefillWorker, Request

PLAIN = dict(name="pf-plain", d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
             vocab=64, remat="none", dtype="float32")
FANCY = dict(name="pf-fancy", d_model=32, n_heads=4, n_kv_heads=4, d_ff=48,
             vocab=80, remat="none", dtype="float32", qk_norm=True,
             post_norms=True, attn_softcap=30.0, rope_pct=0.5,
             tie_embeddings=True)
CONFIGS = {
    "plain": (JArch(groups=j_stack(2), **PLAIN),
              ArchConfig(groups=dense_stack(2), **PLAIN)),
    "fancy": (JArch(groups=j_stack(3), **FANCY),
              ArchConfig(groups=dense_stack(3), **FANCY)),
}
JCFG, CFG = CONFIGS["plain"]
PAGE = 4
TOL = 2e-5           # f32 pages and logits, ROADMAP.md's contract


def _weights(jcfg, seed):
    jp = j_init(jcfg, jax.random.PRNGKey(seed))
    return jp, params_from_jax(jax.device_get(jp))


def _store(cfg, n):
    return PagedKVStore(cfg, n, PAGE, device="cpu")


def _run(eng, prompts, max_new=3):
    eng.start()
    reqs = [eng.submit(p, max_new=max_new) for p in prompts]
    for r in reqs:
        assert r.done.wait(timeout=300)
    eng.stop()
    assert eng.error is None, f"engine failed: {eng.error!r}"
    return [list(r.out) for r in reqs]


_REF_TOKENS = {}


def _ref_tokens(seed, prompts, max_new=3, kv_store="dense"):
    """The reference engine's greedy tokens (one engine, inline prefill;
    its own tests hold them equal under every schedule and policy)."""
    key = (seed, tuple(map(tuple, prompts)), max_new, kv_store)
    if key not in _REF_TOKENS:
        jp, _ = _weights(JCFG, seed)
        kw = {"kernel_impl": "xla"} if kv_store == "paged" else {}
        _REF_TOKENS[key] = _run(JEngine(
            JCFG, jp, max_batch=4, page_size=PAGE, num_pages=64, max_seq=32,
            kv_store=kv_store, **kw), prompts, max_new)
    return _REF_TOKENS[key]


# ----------------------------------------------------------------------------
# chunked against whole prefill; the reference's chunked pages and logits
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("chunk", [1, 3, 16])
def test_chunked_vs_full_prefill_page_and_logit_parity(name, chunk):
    jcfg, cfg = CONFIGS[name]
    jp, params = _weights(jcfg, 7)
    prompt = [2, 7, 1, 8, 2, 8, 1, 4, 5, 9, 3]      # 11: ragged tail page
    blocks = [0, 1, 2]
    full = _store(cfg, 4)
    k, v = prefill_kv(params, cfg, prompt)
    full.write_prefill(blocks, k, v)
    chunked = _store(cfg, 4)
    for _, last in prefill_kv_chunked(params, cfg, chunked, blocks, prompt,
                                      chunk):
        pass
    torch.testing.assert_close(chunked.k, full.k, atol=TOL, rtol=TOL)
    torch.testing.assert_close(chunked.v, full.v, atol=TOL, rtol=TOL)
    dense = apply_model(params, torch.tensor([prompt]), cfg=cfg,
                        mode="prefill")[0]
    torch.testing.assert_close(last[-1], dense[0, -1], atol=2e-4, rtol=2e-4)

    # the reference's chunked prefill of the same prompt and weights
    jstore = JStore(jcfg, num_blocks=4, page_size=PAGE)
    for _, jlast in j_chunked(jp, jcfg, jstore, blocks, prompt, chunk,
                              impl="xla"):
        pass
    np.testing.assert_allclose(chunked.k.numpy(), np.asarray(jstore.k),
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(chunked.v.numpy(), np.asarray(jstore.v),
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast, np.float32),
                               atol=TOL, rtol=TOL)

    # the next decode step over either store agrees on the token
    a = paged_decode_step(params, cfg, full, [blocks], [len(prompt)],
                          [prompt[-1]])
    b = paged_decode_step(params, cfg, chunked, [blocks], [len(prompt)],
                          [prompt[-1]])
    assert int(a[0].argmax()) == int(b[0].argmax())
    assert int(last[-1].argmax()) == int(jnp.argmax(jlast[-1]))


def test_chunked_prefill_resumes_from_start():
    jp, params = _weights(JCFG, 8)
    prompt, blocks, chunk = [5, 3, 9, 1, 2, 6, 4, 8, 7, 2], [0, 1, 2], 3
    whole = _store(CFG, 4)
    for _ in prefill_kv_chunked(params, CFG, whole, blocks, prompt, chunk):
        pass
    split = _store(CFG, 4)
    gen = prefill_kv_chunked(params, CFG, split, blocks, prompt, chunk)
    end, _ = next(gen)                    # one chunk, then abandon
    gen.close()
    assert 0 < end < len(prompt)
    for _ in prefill_kv_chunked(params, CFG, split, blocks, prompt, chunk,
                                start=end):
        pass
    torch.testing.assert_close(split.k, whole.k, atol=TOL, rtol=TOL)
    torch.testing.assert_close(split.v, whole.v, atol=TOL, rtol=TOL)
    jstore = JStore(JCFG, num_blocks=4, page_size=PAGE)
    for _ in j_chunked(jp, JCFG, jstore, blocks, prompt, chunk, impl="xla"):
        pass
    np.testing.assert_allclose(split.k.numpy(), np.asarray(jstore.k),
                               atol=TOL, rtol=TOL)


# ----------------------------------------------------------------------------
# the ping-delivery window: one chunk, not one prompt (a property)
# ----------------------------------------------------------------------------


def test_ping_mid_prefill_is_serviced_within_a_chunk():
    chunk = 2
    prompt = [1 + (i % 40) for i in range(40)]
    _, params = _weights(JCFG, 9)
    eng = ServeEngine(CFG, params, device="cpu", max_batch=2, page_size=PAGE,
                      num_pages=32, max_seq=64, n_engines=1,
                      prefill_workers=1, prefill_chunk=chunk,
                      kv_store="paged")
    policy = eng.pool.policy
    assert isinstance(policy, EpochPOPPolicy)
    eid = eng.prefill_workers[0].engine_id
    eng.start()
    try:
        r = eng.submit(prompt, max_new=1)
        deadline = time.monotonic() + 120
        while r.prefilled < 2 * chunk and time.monotonic() < deadline:
            time.sleep(0.0005)
        assert r.prefilled >= 2 * chunk, "prefill never started"
        p0 = r.prefilled
        snap = policy._publish_counter[eid]
        policy._ping_flags[eid].set()               # the reclaimer's ping
        deadline = time.monotonic() + 120
        while (policy._publish_counter[eid] <= snap
               and time.monotonic() < deadline):
            time.sleep(0.0002)
        p1 = r.prefilled
        assert policy._publish_counter[eid] > snap, "ping never serviced"
        assert p1 - p0 <= 3 * chunk, \
            f"publish took {p1 - p0} tokens of prefill (chunk={chunk})"
        assert p1 < len(prompt), "only published after the whole prompt"
    finally:
        eng.stop()
    assert eng.error is None, f"engine failed: {eng.error!r}"


# ----------------------------------------------------------------------------
# a partial prefill handed across workers
# ----------------------------------------------------------------------------


def test_partial_prefill_resumable_across_workers():
    jp, params = _weights(JCFG, 10)
    chunk = 4
    prompt = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8]
    pool = BlockPool(16, n_engines=2, reclaim_threshold=4)
    store = _store(CFG, pool.num_blocks)
    pool.add_block_listener(store)
    mk = lambda eid: PrefillWorker(eid, CFG, params, pool, None,  # noqa: E731
                                   page_size=PAGE, max_seq=32,
                                   kv_store=store, prefill_chunk=chunk,
                                   device="cpu")
    w0, w1 = mk(0), mk(1)
    r = Request(1, list(prompt), max_new=4)
    w0._stop.set()                       # stop lands after the first chunk
    assert w0.prefill_one(r) is False
    assert 0 < r.prefilled < len(prompt) and r.owner == 0
    assert set(r.blocks) <= pool._live_local[0]
    assert w1.prefill_one(r) is True     # adopt + resume
    assert r.owner == 1 and r.prefilled == len(prompt)
    assert set(r.blocks) <= pool._live_local[1]
    assert not set(r.blocks) & pool._live_local[0]
    assert w1.prefill_tokens == len(prompt) - w0.prefill_tokens
    assert pool.stats.adopts == 1
    # the pages equal one uninterrupted prefill's, the port's and the
    # reference's, in the blocks the request holds
    ref = _store(CFG, pool.num_blocks)
    k, v = prefill_kv(params, CFG, prompt)
    ref.write_prefill(r.all_blocks, k, v)
    jstore = JStore(JCFG, num_blocks=pool.num_blocks, page_size=PAGE)
    from repro.serve.paged_model import prefill_kv as j_prefill_kv
    jk, jv = j_prefill_kv(jp, JCFG, prompt)
    jstore.write_prefill(r.all_blocks, jk, jv)
    for b in r.all_blocks:
        torch.testing.assert_close(store.k[:, b], ref.k[:, b], atol=TOL,
                                   rtol=TOL)
        np.testing.assert_allclose(store.k[:, b].numpy(),
                                   np.asarray(jstore.k)[:, b], atol=TOL,
                                   rtol=TOL)
        np.testing.assert_allclose(store.v[:, b].numpy(),
                                   np.asarray(jstore.v)[:, b], atol=TOL,
                                   rtol=TOL)
    pool.retire(1, r.blocks)
    pool.reclaim(1)
    assert pool.check_no_leaks()


# ----------------------------------------------------------------------------
# stop, reroute, a dead prefill stage
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("prefill_workers", [1, 0])
def test_stop_finalizes_a_request_stopped_mid_prefill(prefill_workers):
    """stop() mid-prefill releases the waiter of the request stopped
    partway (re-queued on the shared queue, or on the decode worker's
    own) and returns its blocks: the pool ends leak-free."""
    _, params = _weights(JCFG, 15)
    chunk = 2
    prompt = [1 + (i % 30) for i in range(30)]
    eng = ServeEngine(CFG, params, device="cpu", max_batch=2, page_size=PAGE,
                      num_pages=32, max_seq=40, n_engines=1,
                      prefill_workers=prefill_workers, prefill_chunk=chunk,
                      kv_store="paged")
    eng.start()
    r = eng.submit(prompt, max_new=2)
    deadline = time.monotonic() + 120
    while r.prefilled < chunk and time.monotonic() < deadline:
        time.sleep(0.0005)
    assert r.prefilled >= chunk, "prefill never started"
    eng.stop()
    assert r.done.is_set(), "stranded prefill request left hanging"
    assert not r.blocks and not r.shared_blocks
    eng.pool.policy.flush()
    assert eng.pool.check_no_leaks()


def test_reroute_hands_queued_requests_to_decode():
    _, params = _weights(JCFG, 16)
    eng = ServeEngine(CFG, params, device="cpu", max_batch=2, page_size=PAGE,
                      num_pages=32, max_seq=32, n_engines=1,
                      prefill_workers=1, prefill_chunk=4, kv_store="paged")
    r = Request(1, [5, 3, 9], max_new=2)
    eng.scheduler.prefill_queue.put(r)
    eng.scheduler.reroute_prefill_queue()
    assert eng.scheduler.prefill_queue.empty()
    assert eng.workers[0].queue.qsize() == 1
    assert not r.done.is_set()


def test_scheduler_routes_around_dead_prefill_stage():
    """Every prefill worker failed: submit places on the decode fleet,
    whose inline chunked prefill serves the request with the reference's
    tokens."""
    _, params = _weights(JCFG, 11)
    eng = ServeEngine(CFG, params, device="cpu", max_batch=2, page_size=PAGE,
                      num_pages=32, max_seq=32, n_engines=1,
                      prefill_workers=1, prefill_chunk=4, kv_store="paged")
    eng.start()
    try:
        eng.prefill_workers[0].error = RuntimeError("injected")
        r = eng.submit([5, 3, 9, 1, 2], max_new=3)
        assert r.done.wait(timeout=300)
    finally:
        eng.stop()
    assert all(w.error is None for w in eng.workers)
    assert eng.prefill_workers[0].requests == 0
    assert [list(r.out)] == _ref_tokens(11, [[5, 3, 9, 1, 2]])


# ----------------------------------------------------------------------------
# the whole pipeline: tokens equal the reference's; no use-after-free
# ----------------------------------------------------------------------------

PROMPTS = [[1, 9, 3, 5, 2], [7, 2, 8, 6, 4, 1, 3, 5], [11],
           [5, 3, 9, 1, 2, 6, 4, 8, 7, 2, 9]]


@pytest.mark.parametrize("kv_store", ["dense", "paged"])
def test_async_prefill_token_parity(kv_store):
    """prefill_workers=2 is a scheduling change only: the inline engine's
    tokens, and the reference engine's on the same storage layer."""
    _, params = _weights(JCFG, 12)
    outs = {}
    for n_pw in (0, 2):
        eng = ServeEngine(CFG, params, device="cpu", max_batch=4,
                          page_size=PAGE, num_pages=64, max_seq=32,
                          n_engines=1, prefill_workers=n_pw, prefill_chunk=3,
                          kv_store=kv_store)
        outs[n_pw] = _run(eng, PROMPTS)
        if n_pw:
            assert sum(pw.requests for pw in eng.prefill_workers) == \
                len(PROMPTS)
            assert all(w.prefill_tokens == 0 for w in eng.workers)
    assert outs[0] == outs[2] == _ref_tokens(12, PROMPTS, kv_store=kv_store)


@pytest.mark.parametrize("smr", ["EpochPOP-pool", "HazardPtrPOP", "EBR"])
def test_async_prefill_no_uaf_under_reclaim_policies(smr):
    _, params = _weights(JCFG, 13)
    pool = BlockPool(48, n_engines=4, reclaim_threshold=4,
                     pressure_factor=2, policy=make_policy(smr))
    eng = ServeEngine(CFG, params, device="cpu", max_batch=4, page_size=PAGE,
                      max_seq=32, pool=pool, n_engines=1, prefill_workers=2,
                      prefill_chunk=2, prefix_cache=True, kv_store="paged")
    hot = [5, 3, 9, 1]
    prompts = [hot + [i + 1, i + 2] for i in range(6)]
    outs = _run(eng, prompts, max_new=2)
    pool.evict_prefixes(0)
    pool.policy.flush()
    assert pool.stats.freed > 0
    assert eng.kv_store.poisons == pool.stats.freed
    assert pool.check_no_leaks()
    assert outs == _ref_tokens(13, prompts, max_new=2)


def test_prefill_worker_ownership_handoff_is_leak_free():
    _, params = _weights(JCFG, 14)
    eng = ServeEngine(CFG, params, device="cpu", max_batch=2, page_size=PAGE,
                      num_pages=32, max_seq=32, n_engines=1,
                      prefill_workers=1, prefill_chunk=4, kv_store="paged")
    prompts = [[1, 2, 3, 4, 5, 6], [9, 8, 7]]
    assert _run(eng, prompts) == _ref_tokens(14, prompts)
    eng.pool.policy.flush()
    assert eng.pool.check_no_leaks()
    assert all(not s for s in eng.pool._live_local)
