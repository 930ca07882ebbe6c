"""The port end to end, the twin of ``tests/test_system.py``: train a tiny
model, checkpoint, restore into a fresh trainer, serve it through the
paged engine under publish-on-ping reclamation -- single engine, and two
engines with the prefix cache.

Both packages start from the same weights (the reference's
``init_params``, bridged) and read one data stream (``TokenPipeline``'s
numpy batches, bit-equal across the packages); each trains 30 steps,
restores from its own checkpoint and serves.  The port's greedy tokens
must equal the reference's path's.
"""

import jax
import pytest

from repro.configs.base import ArchConfig as JArch
from repro.configs.base import dense_stack as j_stack
from repro.data.pipeline import DataConfig as JDataConfig
from repro.models.model import init_params as j_init
from repro.optim.adamw import adamw_init as j_adamw_init
from repro.runtime.block_pool import BlockPool as JBlockPool
from repro.serve.engine import ServeEngine as JEngine
from repro.train.trainer import Trainer as JTrainer
from repro.train.trainer import TrainerConfig as JTrainerConfig
from repro_torch.bridge import opt_state_from_jax, params_from_jax
from repro_torch.configs.base import ArchConfig, dense_stack
from repro_torch.data.pipeline import DataConfig
from repro_torch.runtime.block_pool import BlockPool
from repro_torch.serve.engine import ServeEngine
from repro_torch.train.trainer import Trainer, TrainerConfig

KW = dict(name="tiny-sys", d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
          vocab=128, remat="none", dtype="float32")
JTINY = JArch(groups=j_stack(2), **KW)
TINY = ArchConfig(groups=dense_stack(2), **KW)
TKW = dict(steps=30, ckpt_every=10, log_every=1000, lr_peak=2e-3)
DKW = dict(vocab=TINY.vocab, seq_len=32, global_batch=4, seed=1)
PREFIX = [2, 4, 6, 8, 1, 3, 5, 7]                # exactly one full page


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Each package trained from the same weights, then restored from its
    checkpoint by a fresh trainer: ``{"port": ..., "reference": ...}``,
    each ``(trainer config, the run's output, the restored params and
    start step)``."""
    tmp = tmp_path_factory.mktemp("sys")
    jp = j_init(JTINY, jax.random.PRNGKey(0))
    host = jax.device_get(jp)
    tp, to = params_from_jax(host), opt_state_from_jax(
        jax.device_get(j_adamw_init(jp)))
    out = {}
    jcfg = JTrainerConfig(ckpt_dir=str(tmp / "ref"), **TKW)
    jout = JTrainer(JTINY, jcfg, JDataConfig(**DKW)).run(
        params=jp, opt_state=j_adamw_init(jp))
    jparams, _, jstart = JTrainer(JTINY, jcfg, None).try_restore()
    out["reference"] = (jcfg, jout, jparams, jstart)
    tcfg = TrainerConfig(ckpt_dir=str(tmp / "port"), **TKW)
    tout = Trainer(TINY, tcfg, DataConfig(**DKW), device="cpu").run(
        params=tp, opt_state=to)
    tparams, _, tstart = Trainer(TINY, tcfg, None,
                                 device="cpu").try_restore()
    out["port"] = (tcfg, tout, tparams, tstart)
    return out


def _serve(eng, prompts, max_new):
    eng.start()
    reqs = [eng.submit(p, max_new=max_new) for p in prompts]
    for r in reqs:
        assert r.done.wait(timeout=120), "generation timed out"
    eng.stop()
    assert eng.error is None, f"engine failed: {eng.error!r}"
    return reqs


def test_train_checkpoint_restore_serve(trained):
    _, tout, tparams, tstart = trained["port"]
    _, jout, jparams, jstart = trained["reference"]
    assert tout["step"] == jout["step"] == 30
    assert tstart == jstart == 30
    prompts = [[1 + i, 5, 9] for i in range(6)]
    pool = BlockPool(64, n_engines=1, reclaim_threshold=4, pressure_factor=2)
    eng = ServeEngine(TINY, tparams, device="cpu", max_batch=4, page_size=8,
                      max_seq=64, pool=pool, kv_store="paged")
    got = _serve(eng, prompts, 6)
    for r in got:
        assert len(r.out) == 6
        assert all(0 <= t < TINY.vocab_padded for t in r.out)
    assert pool.stats.freed > 0
    assert pool.check_no_leaks()
    assert eng.kv_store.poisons == pool.stats.freed
    jpool = JBlockPool(64, n_engines=1, reclaim_threshold=4,
                       pressure_factor=2)
    want = _serve(JEngine(JTINY, jparams, max_batch=4, page_size=8,
                          max_seq=64, pool=jpool), prompts, 6)
    assert [r.out for r in got] == [r.out for r in want]


def test_serve_deterministic_greedy(trained):
    tout = trained["port"][1]
    pool = BlockPool(32, n_engines=1, reclaim_threshold=4)
    eng = ServeEngine(TINY, tout["params"], device="cpu", max_batch=2,
                      page_size=8, max_seq=64, pool=pool, kv_store="paged")
    a, b = _serve(eng, [[3, 7], [3, 7]], 5)
    assert a.out == b.out, "greedy decode must be deterministic"
    jout = trained["reference"][1]
    j = _serve(JEngine(JTINY, jout["params"], max_batch=2, page_size=8,
                       max_seq=64, pool=JBlockPool(32, n_engines=1,
                                                   reclaim_threshold=4)),
               [[3, 7]], 5)
    assert a.out == j[0].out


def test_serve_multi_engine_prefix_cache(trained):
    """2 engine workers + reclaimer over one pool, prefix cache on: the
    shared prompts hit the cache, skip prefill for the cached page, decode
    as fresh prefills do, and as the reference's engine does."""
    tparams = trained["port"][2]
    prompts = [PREFIX + [9 + i % 2] for i in range(6)]
    eng = ServeEngine(TINY, tparams, device="cpu", max_batch=2, page_size=8,
                      max_seq=64, num_pages=64, n_engines=2,
                      prefix_cache=True, kv_store="paged")
    reqs = _serve(eng, prompts, 5)
    assert all(len(r.out) == 5 for r in reqs)
    s = eng.pool.stats
    assert s.prefix_hits > 0, "shared prompts never hit the prefix cache"
    assert sum(w.prefill_tokens_skipped for w in eng.workers) > 0
    outs = {}
    for r in reqs:
        outs.setdefault(tuple(r.prompt), set()).add(tuple(r.out))
    assert all(len(v) == 1 for v in outs.values()), outs
    want = _serve(JEngine(JTINY, trained["reference"][2], max_batch=2,
                          page_size=8, max_seq=64, num_pages=64, n_engines=2,
                          prefix_cache=True), prompts, 5)
    assert [r.out for r in reqs] == [r.out for r in want]
    eng.pool.evict_prefixes(0)
    eng.pool.reclaim()
    assert eng.pool.check_no_leaks()
