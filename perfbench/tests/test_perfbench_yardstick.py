"""The yardstick's arithmetic against hand counts: FLOPs, a paged launch's
operations and bytes, the end-to-end readers on synthetic timelines, and
the traffic's sizes."""

import threading
from dataclasses import dataclass, field
from typing import List

from perfbench.bench import flops
from perfbench.bench.loop import Sent
from perfbench.bench.window import Run, percentile
from perfbench.bench import spec
from perfbench.traffic.mix import BLOCK, Mix

M = {"d_model": 8, "n_layers": 2, "n_heads": 4, "n_kv_heads": 2,
     "head_dim": 2, "d_ff": 16, "vocab": 10, "vocab_padded": 10,
     "act": "gelu_tanh"}


def test_matmul_params_by_hand():
    # a layer: q 8x8, k and v 8x4 each, o 8x8, MLP 2 x 8x16
    assert flops.matmul_params(M) == 2 * (64 + 32 + 32 + 64 + 256)
    assert flops.matmul_params(dict(M, act="swiglu")) == 2 * (192 + 384)


def test_chunk_and_decode_flops_by_hand():
    mm = 2 * flops.matmul_params(M)
    per_pos = 4 * 2 * 4 * 2                          # 4 x L x H x hd
    head = 2 * 8 * 10                                # 2 x d x vocab
    # rows at positions 3, 4, 5 attend 4, 5, 6 positions, no head
    assert flops.prefill_chunk_flops(M, 3, 3) == 3 * mm + 15 * per_pos
    # decode rows holding 3 and 7 positions attend 4 and 8, with the head
    assert flops.decode_flops(M, [3, 7]) == 2 * (mm + head) + 12 * per_pos


def test_paged_launch_counts_a_shared_page_once():
    page = 4
    slot = 2 * 2 * 2 * 2                              # K+V x Hkv x hd x bf16
    # two rows share page 7 whole; row 0 reads 2 slots of page 8, row 1
    # 3 slots of page 9
    c = flops.paged_launch(M, page, [[7, 8], [7, 9]], [6, 7], new_rows=2)
    live = 4 + 2 + 3
    assert c["bytes"] == live * slot + 2 * slot + 2 * 2 * 4 * 2 * 4
    assert c["ops"] == 4 * 4 * 2 * 13
    # the same page partly read by two rows: the larger read counts
    c2 = flops.paged_launch(M, page, [[5], [5]], [1, 3], new_rows=2)
    assert c2["bytes"] == 3 * slot + 2 * slot + 2 * 2 * 4 * 2 * 4


def test_bound_takes_the_larger():
    peak = {"flops": 10.0, "bytes_s": 2.0}
    assert flops.bound_s(100, 4, peak) == 10.0
    assert flops.bound_s(10, 40, peak) == 20.0


@dataclass
class _Req:
    t_submit: float
    max_new: int = 4
    out: List[int] = field(default_factory=list)
    t_first_tok: float = 0.0
    t_last_tok: float = 0.0
    t_admitted: float = 0.0
    prompt: List[int] = field(default_factory=list)
    done: threading.Event = field(default_factory=threading.Event)


def _run(sent, snap0, snap1):
    return Run(cell="x", model=M, page=16, t0=10.0, t1=20.0, sent=sent,
               snap0=snap0, snap1=snap1)


def test_e2e_readers_on_a_synthetic_timeline():
    sent = [Sent(0, 0, _Req(5.0)),     # before the window: not a TTFT sample
            Sent(1, 1, _Req(11.0)),    # first token at 12.0
            Sent(2, 2, _Req(12.0)),    # no first token by 20.0: censored
            Sent(3, 3, _Req(19.0))]    # first token at 19.5
    snap0 = {0: (3, 9.0, 6.0, False)}
    snap1 = {0: (5, 19.0, 6.0, True),          # 2 tokens in: gaps (19-9)/2
             1: (4, 18.0, 12.0, False),        # 4 tokens in: (18-12)/3
             2: (0, 0.0, 0.0, False),
             3: (1, 19.5, 19.5, False)}        # 1 token in: no gap
    run = _run(sent, snap0, snap1)
    assert spec.reader("e2e", "out_tok_s")(run) == (2 + 4 + 0 + 1) / 10.0
    # TTFTs: 1.0, 8.0 (censored at the window's end), 0.5
    assert spec.reader("metrics", "ttft_p50_s")(run) == 1.0
    sent.append(Sent(4, 4, _Req(13.0)))        # censored too: 7.0
    assert spec.reader("metrics", "ttft_p50_s")(run) == 1.0
    sent.append(Sent(5, 5, _Req(14.0)))        # censored: 6.0
    assert spec.reader("metrics", "ttft_p50_s")(run) == 6.0
    # gaps (19 - 9) / 2 and (18 - 12) / 3; the median of two is the lower
    assert spec.reader("e2e", "tpot_p50_s")(run) == 2.0


def test_percentile_is_nearest_rank():
    v = list(range(1, 101))
    assert percentile(v, 0.9) == 90
    assert percentile(v, 0.5) == 50
    assert percentile([3.0], 0.9) == 3.0
    assert percentile(list(range(1, 11)), 0.9) == 9


def test_every_seed_gets_the_same_sizes():
    traffic = spec.workload("starcoder2-7b.long-prompt")["mix"]
    a, b = Mix(traffic, 100, seed=1), Mix(traffic, 100, seed=2 ** 33 + 1)
    n = BLOCK
    sa = sorted(a.shape(i) for i in range(n))
    sb = sorted(b.shape(i) for i in range(n))
    assert sa == sb
    assert [a.shape(i) for i in range(n)] != [b.shape(i) for i in range(n)]
    assert a.request(3, 0) == Mix(traffic, 100, seed=1).request(3, 0)
