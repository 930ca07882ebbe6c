"""The general traffic generator: a cell's ``mix`` parameters in, the n-th
request of a run out.

Every seed gets the same sizes in another order: a block of ``BLOCK``
(prompt, output) lengths -- the distributions' quantiles, from draws of
``LENGTHS_SEED`` -- is made once, and the requests of a run go through
that block again and again, each pass in an order drawn from the run's
seed.  A block is short (16) so that a window, which holds a few tens of
requests, holds whole passes: seeds then differ in order, not in sizes.
Token ids, and the contexts' contents, come from the run's seed; request
``i`` is a function of ``(seed, i)`` alone, whatever the timing.

With ``contexts`` (shared repository contexts, asked about by many
clients) a request's prompt is its client's context followed by a fresh
question whose length is the block's prompt length.
"""

from __future__ import annotations

import random
from typing import List, Optional, Tuple

import numpy as np

from perfbench.traffic.lengths import sample_length

BLOCK = 16                      # requests a block of lengths holds
LENGTHS_SEED = 1                # draws of the block, the same for every seed
_CONTEXT_KEY = 1 << 40          # rng streams of contexts, apart from requests
_WARMUP_KEY = 1 << 41           # ... and of the warm-up prompt


def _strata(dist: dict, n: int, rng: random.Random) -> List[int]:
    """``n`` lengths that stand for ``dist``: of 64 x n draws, sorted, the
    middle one of each n-th, so that a block of a few requests carries
    the distribution's quantiles and not the luck of a few draws."""
    draws = sorted(sample_length(dist, rng) for _ in range(64 * n))
    return [draws[64 * k + 32] for k in range(n)]


class Mix:
    def __init__(self, traffic: dict, vocab: int, seed: int):
        self.vocab = int(vocab)
        self.seed = int(seed) % (1 << 63)
        rng = random.Random(LENGTHS_SEED)
        n = BLOCK
        prompts = _strata(traffic["prompt"], n, rng)
        outputs = _strata(traffic["output"], n, rng)
        rng.shuffle(outputs)
        self.block: List[Tuple[int, int]] = list(zip(prompts, outputs))
        ctx = traffic.get("contexts")
        self.context_lengths: List[int] = (
            _strata(ctx["length"], ctx["count"], rng) if ctx else [])
        if self.context_lengths:
            rng.shuffle(self.context_lengths)
        self._orders = {}
        self._contexts = {}

    def _order(self, j: int) -> List[int]:
        order = self._orders.get(j)
        if order is None:
            order = list(range(len(self.block)))
            random.Random(self.seed * 1_000_003 + j).shuffle(order)
            self._orders = {j: order}          # passes are taken in turn
        return order

    def shape(self, i: int) -> Tuple[int, int]:
        """(prompt or question length, output length) of request ``i``."""
        n = len(self.block)
        return self.block[self._order(i // n)[i % n]]

    def tokens(self, key: int, n: int) -> List[int]:
        rng = np.random.default_rng([self.seed, key])
        return rng.integers(0, self.vocab, size=n).tolist()

    def warmup(self, n: int) -> List[int]:
        return self.tokens(_WARMUP_KEY, n)

    def context(self, c: int) -> List[int]:
        toks = self._contexts.get(c)
        if toks is None:
            toks = self.tokens(_CONTEXT_KEY + c, self.context_lengths[c])
            self._contexts[c] = toks
        return toks

    def request(self, i: int, client: int) -> Tuple[List[int], int]:
        """The prompt and ``max_new`` of the run's ``i``-th request, sent
        by ``client``."""
        plen, olen = self.shape(i)
        fresh = self.tokens(i, plen)
        if self.context_lengths:
            return self.context(client % len(self.context_lengths)) + fresh, olen
        return fresh, olen

    @property
    def n_contexts(self) -> int:
        return len(self.context_lengths)

    def longest(self) -> int:
        """The most positions a request of this mix can take."""
        ctx = max(self.context_lengths, default=0)
        return max(p + o for p, o in self.block) + ctx
