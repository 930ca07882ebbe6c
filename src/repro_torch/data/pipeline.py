"""Deterministic, shardable, checkpointable token pipeline.

Batches are a pure function of (step, shard) via a counter-mode PRNG, so:
  * restart-from-checkpoint reproduces the exact stream (only the step
    counter is persisted);
  * each data shard draws disjoint substreams (host-parallel loading);
  * elastic re-sharding changes nothing but the shard->substream mapping.

The synthetic distribution is Zipfian over the vocab with a repeated-ngram
process so the LM has actual structure to learn (quickstart shows loss
dropping), not uniform noise.

A copy of the reference's ``data/pipeline.py`` (numpy only, no framework),
so the port's batches are bit-equal to the reference's for any
``(step, shard)``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np


@dataclass
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    n_shards: int = 1
    seed: int = 0
    zipf_a: float = 1.3
    motif_len: int = 8
    motif_prob: float = 0.6


class TokenPipeline:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        assert cfg.global_batch % cfg.n_shards == 0
        self.per_shard = cfg.global_batch // cfg.n_shards
        # fixed motif bank: the learnable structure
        rng = np.random.default_rng(cfg.seed)
        ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
        p = ranks ** (-cfg.zipf_a)
        self._zipf_p = p / p.sum()
        self._motifs = rng.integers(0, cfg.vocab,
                                    (256, cfg.motif_len)).astype(np.int32)

    def batch(self, step: int, shard: int = 0) -> Dict[str, np.ndarray]:
        """(step, shard) -> {"tokens", "targets"} ; stateless."""
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, shard]))
        B, S = self.per_shard, cfg.seq_len
        toks = rng.choice(cfg.vocab, size=(B, S + 1),
                          p=self._zipf_p).astype(np.int32)
        # paste motifs: gives next-token structure
        n_paste = int(B * S * cfg.motif_prob / cfg.motif_len)
        rows = rng.integers(0, B, n_paste)
        cols = rng.integers(0, S + 1 - cfg.motif_len, n_paste)
        ids = rng.integers(0, len(self._motifs), n_paste)
        for r, c, i in zip(rows, cols, ids):
            toks[r, c: c + cfg.motif_len] = self._motifs[i]
        return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}

    def iterate(self, start_step: int = 0, shard: int = 0) -> Iterator[Dict]:
        step = start_step
        while True:
            yield self.batch(step, shard)
            step += 1

    # checkpoint surface: just the step counter (stateless stream)
    def state_dict(self, step: int) -> Dict:
        return {"step": step, "seed": self.cfg.seed}

    @staticmethod
    def restore_step(state: Dict) -> int:
        return int(state["step"])
