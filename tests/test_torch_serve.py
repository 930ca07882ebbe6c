"""The port's ServeEngine on the CPU: token parity with the reference
engine, publish-on-ping serving with prefix sharing and no use-after-free,
serving under the simulator-backed SMR schemes, the deliberately unsafe
policy tripping the tripwires, and the refusal to fall back to the CPU
silently.

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


def _drain(pool, rounds=None):
    """Flush, round after round, until nothing is left retired: each round
    gives every engine slot one empty step, then flushes.  Under the
    simulated EBR one round may free nothing: a block retired at epoch e
    is freed only where every other slot reads as past e, but a slot's
    quiescent store (``end_op``) reaches another simulated thread only
    once that thread's clock passes the store's drain time, and the
    epoch moves on only at each thread's ``epoch_freq``-th step.  Within
    ``2 * epoch_freq`` rounds a thread has moved the epoch past every
    retire and each slot announces the later one.  Fails at the bound."""
    epoch_freq = getattr(pool.policy, "epoch_freq", 1)
    rounds = 2 * epoch_freq if rounds is None else rounds
    for n in range(rounds):
        for e in range(pool.n_engines):
            pool.start_step(e)
            pool.end_step(e)
        pool.policy.flush()
        if not pool.retired_blocks:
            return n + 1
    raise AssertionError(f"{pool.retired_blocks} blocks still retired "
                         f"after {rounds} rounds of empty steps and flushes")


@pytest.mark.parametrize("smr,backend", [
    ("HazardPtrPOP", "gen"), ("HazardEraPOP", "gen"), ("EpochPOP", "gen"),
    ("HP", "gen"), ("HE", "gen"), ("EBR", "gen"), ("HazardPtrPOP", "vec")])
def test_simulated_scheme_serving_matches_reference_tokens(smr, backend):
    """Each simulated scheme serves the parity prompt set on 2 decode
    engines with the reference engine's tokens (same bridged weights, same
    scheme and backend), no use-after-free, no leak, and a poison fill for
    every freed page.  The reference runs its XLA paged path here: its
    Pallas kernel in interpret mode is held to the port by the test
    above."""
    jcfg, tcfg = CONFIGS["plain"]
    jparams = j_init(jcfg, jax.random.PRNGKey(1))
    tparams = params_from_jax(jax.device_get(jparams))
    rng = np.random.default_rng(3)
    prompts = [[1, 9, 3, 5, 2], [7, 2, 8, 6, 4, 1, 3, 5], [11],
               [int(x) for x in rng.integers(1, tcfg.vocab, 11)],
               [1, 9, 3, 5, 2, 6]]
    kw = dict(ENGINE_KW, smr=smr, sim_backend=backend, n_engines=2)
    want = _run(JEngine(jcfg, jparams, kernel_impl="xla", **kw), prompts)
    eng = ServeEngine(tcfg, tparams, device="cpu", **kw)
    assert type(eng.pool.policy).__name__ == "SimulatedSMRPolicy"
    assert eng.pool.policy.scheme_name == smr
    assert _run(eng, prompts) == want
    pool = eng.pool
    # an epoch scheme (EBR) frees only what every other slot can be seen to
    # have passed: drive the idle slots until nothing is left retired, so
    # what the flush frees does not hang on how the decode threads
    # interleaved (``_drain``)
    _drain(pool)
    assert pool.stats.freed > 0
    assert eng.kv_store.poisons == pool.stats.freed
    assert pool.check_no_leaks()
    assert pool.policy.drives > 0 and pool.policy.host_s > 0


def test_simulated_ebr_frees_late_after_stop():
    """The state ``[EBR-gen]`` stopped in when it freed nothing, built
    step by step, with no thread: both decode slots retire their blocks
    at the same epoch, within a few simulated cycles of each other.  One
    empty step a slot and a flush free nothing: each slot's quiescent
    store sits in its simulated store buffer, unseen by the other slot's
    flush, which reads the epoch the other last announced -- the retires'
    own -- and no step bumped the epoch past it (every ``epoch_freq``-th
    step of a thread does).  The reference's EBR does the same: a lag,
    not a leak.  Driven on, the slots free every retired block within the
    drain's bound, each freed page poisoned."""
    params = init_params(CFG, torch.Generator().manual_seed(5), device="cpu")
    eng = ServeEngine(CFG, params, device="cpu", smr="EBR",
                      sim_backend="gen", n_engines=2, **ENGINE_KW)
    pool = eng.pool
    assert pool.n_engines == 3 and pool.policy.epoch_freq == 4
    held = {}
    for e in (0, 1):
        pool.start_step(e)
        held[e] = pool.allocate(e, 3)
        pool.end_step(e)
    for e in (0, 1):
        pool.start_step(e)
        pool.retire(e, held[e])
        pool.end_step(e)
    for e in range(pool.n_engines):
        pool.start_step(e)
        pool.end_step(e)
    pool.policy.flush()
    assert pool.stats.freed == 0 and pool.retired_blocks == 6
    rounds = _drain(pool)
    assert rounds <= 2 * pool.policy.epoch_freq
    assert pool.stats.freed == 6 and pool.retired_blocks == 0
    assert eng.kv_store.poisons == 6 and pool.check_no_leaks()


def test_stop_raises_while_a_decode_thread_is_held(monkeypatch):
    """``stop()`` returns only once every actor's thread has ended: with
    decode thread 0 held inside its step (``_admit`` waits on an event),
    it raises, naming the thread, where it used to return after its join
    timed out and leave the thread to announce and retire beside the
    caller's flush.  Released, the thread closes its step (the slot's
    last ``start_step`` has its ``end_step``) and ends, and ``stop()``
    returns."""
    import threading
    from repro_torch.serve import worker
    from repro_torch.serve.worker import EngineWorker
    params = init_params(CFG, torch.Generator().manual_seed(5), device="cpu")
    eng = ServeEngine(CFG, params, device="cpu", smr="EBR",
                      sim_backend="gen", n_engines=2, **ENGINE_KW)
    entered, release = threading.Event(), threading.Event()
    admit = EngineWorker._admit

    def held_admit(self):
        if self.engine_id == 0 and not release.is_set():
            entered.set()
            release.wait(60)
        return admit(self)
    monkeypatch.setattr(EngineWorker, "_admit", held_admit)
    monkeypatch.setattr(worker, "STOP_TIMEOUT_S", 0.5, raising=False)
    try:
        eng.start()
        assert entered.wait(60)
        with pytest.raises(RuntimeError, match="engine-0"):
            eng.stop()
        w0 = eng.workers[0]
        assert w0._thread.is_alive()
        assert not any(w._thread.is_alive() for w in eng.workers[1:])
        release.set()
        eng.stop()
        assert not w0._thread.is_alive() and eng.error is None
    finally:
        release.set()
    from repro_torch.core.smr.base import MAX_ERA
    sim, smr = eng.pool.policy.sim, eng.pool.policy.smr
    # every decode slot's last step closed: the slot reads quiescent to
    # its own thread (from its store buffer, or from memory once drained)
    for e in range(eng.n_engines):
        fwd = sim.mem.forwarded(e, smr.reserved + e)
        assert (sim.mem.cells[smr.reserved + e] if fwd is None
                else fwd) == MAX_ERA, e


@pytest.mark.parametrize("smr,trips", [("unsafe", True),
                                       ("EpochPOP-pool", False),
                                       ("HazardPtrPOP", False),
                                       ("EpochPOP", False),
                                       ("HP", False)])
def test_freeing_under_an_open_session(smr, trips):
    """Engine 1 holds a reader session over a request's pages while engine
    0 decodes it to the end and retires them.  The unsafe policy frees them
    at once: both tripwires fire (pool touch and page gather) and the pages
    hold the poison.  EpochPOP-pool and the simulated schemes keep them
    until the session closes."""
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
        pool.policy.flush()
        pool.touch(1, blocks)                 # still held after a pass
        store.assert_alive(1, blocks)
        assert not any(store.is_poisoned(b) for b in blocks)
        pool.end_step(1)
        pool.start_step(0)
        pool.end_step(0)
        pool.reclaim(0)
        assert all(store.is_poisoned(b) for b in blocks)
        assert store.poisons == pool.stats.freed


def test_engine_without_device_needs_cuda(monkeypatch):
    """No device given and no CUDA: raise, never carry on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params = init_params(CFG, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(CFG, params, **ENGINE_KW)


def test_paged_path_refuses_what_the_reference_refuses():
    """MoE, MLA, cross attention and enc-dec configs build and run densely;
    the paged path refuses each with the reference's exact ValueError."""
    from repro.configs.registry import get_smoke_config as j_smoke
    from repro.serve.paged_model import check_paged_support as j_check
    for arch, what in (("olmoe_1b_7b", "mlp=moe"),
                       ("deepseek_v3_671b", "attn_kind=mla"),
                       ("llama32_vision_90b", "attn_kind=cross"),
                       ("whisper_small", "encoder_groups (enc-dec)")):
        cfg = get_smoke_config(arch)
        params = init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
        with pytest.raises(ValueError) as got:
            ServeEngine(cfg, params, device="cpu", **ENGINE_KW)
        with pytest.raises(ValueError) as want:
            j_check(j_smoke(arch))
        assert str(got.value) == str(want.value)
        assert what in str(got.value)
    params = init_params(CFG, torch.Generator().manual_seed(0), device="cpu")
    # every safe registry scheme resolves now; the unsafe demo scheme and
    # unknown names are refused as the reference's make_policy refuses them
    for name in ("HP-broken", "no-such-scheme"):
        with pytest.raises(ValueError, match="unknown or unsafe SMR scheme"):
            ServeEngine(CFG, params, device="cpu", smr=name, **ENGINE_KW)
    bad = CFG.scaled(groups=dense_stack(2, attn_kind="local"))
    with pytest.raises(ValueError, match="not supported"):
        ServeEngine(bad, params, device="cpu", **ENGINE_KW)
