"""The port's dense ServeEngine against the reference's, on the CPU.

``ServeEngine(kv_store="dense")`` -- one private decode cache per request,
prefilled token by token and decoded through ``apply_model`` -- decodes
the same greedy tokens as the reference's dense engine on the zamba2,
rwkv6 and gemma2 smoke configs, with the same bridged weights, two decode
engines and the prefix cache on, and leaks no block.  The configs run in
f32 compute, where the two packages' logits agree to ~1e-5, so a greedy
token can only differ through a real fault (bf16 rounds differently in
the two packages and could flip a near tie).

The prompts go in two waves: the first request alone until it has
finished, so its page-aligned prefix is published, then requests that
share that prefix (prefix hits, whose caches start from a copy of the
published snapshot) and others.  The port's decode writes its caches in
place: a hit that shared storage with the snapshot, or with the request
that published it, would decode other tokens than the reference's.
"""

import jax
import numpy as np
import pytest

from repro.configs.registry import get_smoke_config as j_smoke
from repro.models.model import init_params as j_init
from repro.serve.engine import ServeEngine as JEngine
from repro_torch.bridge import params_from_jax
from repro_torch.configs.registry import get_smoke_config
from repro_torch.serve.engine import ServeEngine

PAGE = 4
ENGINE_KW = dict(max_batch=4, page_size=PAGE, num_pages=96, max_seq=48,
                 kv_store="dense", smr="EpochPOP-pool", n_engines=2,
                 prefix_cache=True)


def _prompts(vocab):
    rng = np.random.default_rng(31)
    shared = [int(x) for x in rng.integers(1, vocab, 2 * PAGE)]
    first = [shared + [int(x) for x in rng.integers(1, vocab, 3)]]
    rest = [shared + [int(x) for x in rng.integers(1, vocab, n)]
            for n in (1, 6)]
    rest += [[int(x) for x in rng.integers(1, vocab, n)] for n in (5, 9)]
    return first, rest


def _serve(eng, waves, max_new=5):
    eng.start()
    outs = []
    try:
        for wave in waves:
            reqs = [eng.submit(p, max_new=max_new) for p in wave]
            for r in reqs:
                assert r.done.wait(timeout=300)
            outs += [list(r.out) for r in reqs]
    finally:
        eng.stop()
    assert eng.error is None, f"engine failed: {eng.error!r}"
    pool = eng.pool
    hits = pool.stats.prefix_hits
    pool.evict_prefixes(0)
    pool.policy.flush()
    assert pool.check_no_leaks()
    return outs, hits


@pytest.mark.parametrize("arch", ["zamba2_2p7b", "rwkv6_1p6b", "gemma2_27b"])
def test_dense_engine_tokens_match_reference(arch):
    jcfg = j_smoke(arch).scaled(dtype="float32")
    tcfg = get_smoke_config(arch).scaled(dtype="float32")
    jparams = j_init(jcfg, jax.random.PRNGKey(2))
    tparams = params_from_jax(jax.device_get(jparams))
    waves = _prompts(tcfg.vocab)
    want, _ = _serve(JEngine(jcfg, jparams, **ENGINE_KW), waves)
    eng = ServeEngine(tcfg, tparams, device="cpu", **ENGINE_KW)
    got, hits = _serve(eng, waves)
    assert hits >= 2
    assert got == want
    stats = eng.kv_copy_stats()
    assert stats["kv_store"] == "dense" and stats["admitted_hit"] >= 2
    assert stats["bytes_per_hit"] == stats["bytes_per_miss"] > 0
