"""The port's continuous-batching scheduler on the CPU, the twin of
``tests/test_scheduler_props.py``: under random submit / preempt /
migrate / prefill-worker-crash runs every request completes exactly once
with the tokens of the reference's plain decode loop (the same bridged
weights), and the pool ends leak-free; the prefill queue pops in the
reference queue's order under ``fifo``, ``sjf`` and ``deadline``, with
the same reorder count; ``Scheduler.stop()`` finalises queued partials
with no prefill worker configured.

The property is driven by a seeded generator always and, where
``hypothesis`` is installed, by ``@given`` as the reference runs it.
"""

import random
import threading
import time

import jax
import jax.numpy as jnp
import pytest

from repro.configs.base import ArchConfig as JArch
from repro.configs.base import dense_stack as j_stack
from repro.models.model import apply_model as j_apply
from repro.models.model import init_cache as j_init_cache
from repro.models.model import init_params as j_init
from repro.serve.scheduler import PrefillQueue as JPrefillQueue
from repro.serve.worker import Request as JRequest
from repro_torch.bridge import params_from_jax
from repro_torch.configs.base import ArchConfig, dense_stack
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.scheduler import SCHED_POLICIES, PrefillQueue
from repro_torch.serve.worker import Request

try:
    from hypothesis import HealthCheck, given, settings
    from hypothesis import strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:  # no hypothesis: the seeded cases only
    HAVE_HYPOTHESIS = False

KW = dict(name="sched-props", d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
          vocab=64, remat="none", dtype="float32")
JCFG = JArch(groups=j_stack(2), **KW)
CFG = ArchConfig(groups=dense_stack(2), **KW)
MAX_SEQ = 32
MAX_NEW = 4


@pytest.fixture(scope="module")
def weights():
    jp = j_init(JCFG, jax.random.PRNGKey(0))
    return jp, params_from_jax(jax.device_get(jp))


class Oracle:
    """The reference's tokens from its plain single-threaded decode loop
    (no scheduler, no pool), memoised."""

    def __init__(self, jparams):
        self.params = jparams
        self._decode = jax.jit(lambda p, c, t: j_apply(
            p, t, cfg=JCFG, mode="decode", cache=c))
        self._memo = {}

    def __call__(self, prompt):
        prompt = tuple(prompt)
        if prompt not in self._memo:
            cache = j_init_cache(JCFG, 1, MAX_SEQ, JCFG.dtype)
            toks = jnp.asarray([list(prompt)], jnp.int32)
            for t in range(len(prompt)):
                _, cache, _ = self._decode(self.params, cache,
                                           toks[:, t:t + 1])
            out, last = [], prompt[-1]
            for _ in range(MAX_NEW):
                logits, cache, _ = self._decode(
                    self.params, cache, jnp.asarray([[last]], jnp.int32))
                last = int(jnp.argmax(logits[0, -1]))
                out.append(last)
            self._memo[prompt] = tuple(out)
        return self._memo[prompt]


@pytest.fixture(scope="module")
def oracle(weights):
    return Oracle(weights[0])


def _engine(params, **kw):
    return ServeEngine(CFG, params, device="cpu", max_batch=2, page_size=4,
                       max_seq=MAX_SEQ, **kw)


# -- the property --


def check_perturbed_run(prompts, policy, crash, deadlines, params, oracle):
    """``policy`` ordering, chunk preemption on, the migration monitor on
    at a hair trigger, optionally a prefill worker crashed mid-run: the
    reference's tokens, exactly once per request, leak-free."""
    eng = _engine(params, num_pages=96, n_engines=2, prefill_workers=2,
                  prefill_chunk=4, sched_policy=policy, preempt_prefill=True,
                  migrate=True, migrate_interval_s=0.005,
                  migrate_threshold=1)
    eng.start()
    try:
        reqs = [eng.submit(p, max_new=MAX_NEW, deadline_s=d)
                for p, d in zip(prompts, deadlines)]
        if crash:
            pw = eng.prefill_workers[0]
            pw._stop.set()
            if pw._thread is not None:
                pw._thread.join(timeout=30)
            pw.error = RuntimeError("injected crash")
            eng.scheduler.reroute_prefill_queue()
        for r in reqs:
            assert r.done.wait(timeout=120), f"rid {r.rid} never completed"
    finally:
        eng.stop()
    err = eng.error
    if crash:
        assert err is None or str(err) == "injected crash", err
    else:
        assert err is None, err
    for p, r in zip(prompts, reqs):
        assert len(r.out) == MAX_NEW, (r.rid, r.out)
        assert tuple(r.out) == oracle(p), (r.rid, p, r.out, oracle(p))
    eng.pool.reclaim()
    assert eng.pool.check_no_leaks()
    assert eng.pool.stats.stale_handoffs == 0


def _draw_case(rng: random.Random):
    prompts = [[rng.randint(1, 63) for _ in range(rng.randint(1, 12))]
               for _ in range(rng.randint(3, 8))]
    policy = rng.choice(SCHED_POLICIES)
    crash = rng.random() < 0.5
    deadlines = [rng.uniform(0.01, 0.5) if rng.random() < 0.5 else None
                 for _ in prompts]
    return prompts, policy, crash, deadlines


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_token_parity_under_perturbation(seed, weights, oracle):
    prompts, policy, crash, deadlines = _draw_case(random.Random(seed))
    check_perturbed_run(prompts, policy, crash, deadlines, weights[1],
                        oracle)


def test_preemption_fires_and_keeps_tokens(weights, oracle):
    """One long prompt prefilling while short ones queue: under ``sjf``
    with ``preempt_prefill`` the long prefill yields at a chunk boundary
    (``preemptions > 0``), and every request keeps the reference's
    tokens."""
    prompts = [[1 + (i % 60) for i in range(28)]] + [[7, 3], [9, 4, 2],
                                                     [5], [8, 8, 1]]
    eng = _engine(weights[1], num_pages=96, n_engines=1, prefill_workers=1,
                  prefill_chunk=2, sched_policy="sjf", preempt_prefill=True,
                  preempt_margin=0)
    eng.start()
    try:
        first = eng.submit(prompts[0], max_new=MAX_NEW)
        while first.prefilled < 2 and not first.done.is_set():
            time.sleep(0.0005)
        reqs = [first] + [eng.submit(p, max_new=MAX_NEW)
                          for p in prompts[1:]]
        for r in reqs:
            assert r.done.wait(timeout=120)
    finally:
        eng.stop()
    assert eng.error is None
    assert eng.scheduler.preemptions > 0
    assert [tuple(r.out) for r in reqs] == [oracle(p) for p in prompts]
    eng.pool.reclaim()
    assert eng.pool.check_no_leaks()


if HAVE_HYPOTHESIS:
    prompts_st = st.lists(
        st.lists(st.integers(min_value=1, max_value=63),
                 min_size=1, max_size=12),
        min_size=3, max_size=8)

    @settings(max_examples=5, deadline=None, database=None,
              suppress_health_check=[HealthCheck.too_slow,
                                     HealthCheck.function_scoped_fixture])
    @given(data=st.data())
    def test_token_parity_under_perturbation_hypothesis(data, weights,
                                                        oracle):
        prompts = data.draw(prompts_st)
        policy = data.draw(st.sampled_from(SCHED_POLICIES))
        crash = data.draw(st.booleans())
        deadlines = [data.draw(st.one_of(
            st.none(), st.floats(min_value=0.01, max_value=0.5)))
            for _ in prompts]
        check_perturbed_run(prompts, policy, crash, deadlines, weights[1],
                            oracle)


# -- the queue's order, against the reference's queue --


def _drain(q):
    out = []
    while not q.empty():
        out.append(q.get_nowait().rid)
    return out, q.reorders


def _both(policy, specs):
    """Put the same requests (rid, prompt length, prefilled, deadline) in
    the port's queue and the reference's: both pop orders and reorder
    counts."""
    got = []
    for queue_cls, req_cls in ((PrefillQueue, Request),
                               (JPrefillQueue, JRequest)):
        q = queue_cls(policy)
        for rid, n, done, deadline in specs:
            r = req_cls(rid, [0] * n, 1)
            r.prefilled = done
            r.deadline_s = deadline
            q.put(r)
        got.append(_drain(q))
    return got


def test_scheduler_policies_match_the_reference():
    assert tuple(SCHED_POLICIES) == ("fifo", "sjf", "deadline")


@pytest.mark.parametrize("policy", SCHED_POLICIES)
@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_prefill_queue_drains_completely_in_policy_order(policy, seed):
    """Every put pops exactly once, in the reference queue's order: sjf by
    remaining length, fifo in arrival order with no reorder counted."""
    rng = random.Random(seed)
    specs = [(i + 1, rng.randint(0, 30), 0,
              rng.uniform(0.0, 5.0) if rng.random() < 0.5 else None)
             for i in range(rng.randint(1, 30))]
    (port, port_re), (ref, ref_re) = _both(policy, specs)
    assert port == ref and port_re == ref_re
    assert sorted(port) == [s[0] for s in specs]
    if policy == "sjf":
        n = {s[0]: s[1] for s in specs}
        assert [n[r] for r in port] == sorted(n[r] for r in port)
    if policy == "fifo":
        assert port == [s[0] for s in specs] and port_re == 0


def test_sjf_sorts_resumed_partial_by_remaining_not_total():
    (port, port_re), ref = _both("sjf", [(1, 5, 0, None), (2, 20, 18, None)])
    assert (port, port_re) == ref
    assert port[0] == 2 and port_re == 1


def test_deadline_policy_orders_by_deadline_then_best_effort():
    (port, port_re), ref = _both("deadline", [(1, 2, 0, None),
                                              (2, 9, 0, 9.0), (3, 9, 0, 1.0)])
    assert (port, port_re) == ref
    assert port == [3, 2, 1] and port_re >= 1


# -- Scheduler.stop(): the worker-independent finalize seam --


def test_stop_finalizes_queued_partials_with_zero_prefill_workers(weights):
    eng = _engine(weights[1], num_pages=32, n_engines=1, prefill_workers=0)
    w = eng.workers[0]
    r = Request(1, [1, 2, 3, 4, 5], MAX_NEW)
    assert w._admit_blocks(r)
    r.prefilled = 2
    eng.scheduler.prefill_queue.put(r)
    eng.scheduler.stop()
    assert r.done.is_set()
    assert not r.blocks and not r.shared_blocks
    eng.pool.reclaim()
    assert eng.pool.check_no_leaks()


def test_stop_releases_unadmitted_queued_requests(weights):
    eng = _engine(weights[1], num_pages=32, n_engines=1, prefill_workers=0)
    r = Request(7, [1, 2, 3], MAX_NEW)
    eng.scheduler.prefill_queue.put(r)
    eng.scheduler.stop()
    assert r.done.is_set()
    assert eng.pool.check_no_leaks()


def test_stop_unblocks_concurrent_waiter(weights):
    eng = _engine(weights[1], num_pages=32, n_engines=1, prefill_workers=0)
    r = Request(9, [1, 2], MAX_NEW)
    eng.scheduler.prefill_queue.put(r)
    woke = threading.Event()

    def waiter():
        if r.done.wait(timeout=60):
            woke.set()

    t = threading.Thread(target=waiter)
    t.start()
    eng.scheduler.stop()
    t.join(timeout=60)
    assert woke.is_set()
