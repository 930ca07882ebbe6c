"""Model step: the model FLOPs that the window's decode rows needed (from
``bench/flops.py``: matrix products, attention over the positions each
row reads, and for generated tokens the head; cache hits not counted) over
the read part of the window's seconds times the card's dense bf16 peak,
in %."""

from perfbench.bench.flops import forwards_mfu


def read(run):
    return forwards_mfu(run, "decode")
