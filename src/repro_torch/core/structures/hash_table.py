"""HMHT: hash table of Harris-Michael lists (the paper's HT benchmark)."""

from __future__ import annotations

from typing import Generator

from repro_torch.core.sim.engine import Engine, ThreadCtx
from repro_torch.core.smr.base import SMRScheme
from repro_torch.core.structures.harris_michael import HarrisMichaelList


class HashTable:
    SLOTS = 3

    def __init__(self, engine: Engine, smr: SMRScheme, nbuckets: int = 64):
        self.engine = engine
        self.smr = smr
        self.nbuckets = nbuckets
        self.heads = engine.alloc_shared(nbuckets)
        self.buckets = [
            HarrisMichaelList(engine, smr, head_cell=self.heads + i)
            for i in range(nbuckets)
        ]

    def _bucket(self, key: int) -> HarrisMichaelList:
        return self.buckets[key % self.nbuckets]

    def contains(self, t: ThreadCtx, key: int) -> Generator:
        r = yield from self._bucket(key).contains(t, key)
        return r

    def insert(self, t: ThreadCtx, key: int) -> Generator:
        r = yield from self._bucket(key).insert(t, key)
        return r

    def delete(self, t: ThreadCtx, key: int) -> Generator:
        r = yield from self._bucket(key).delete(t, key)
        return r

    def snapshot_keys(self) -> list:
        out = []
        for b in self.buckets:
            out.extend(b.snapshot_keys())
        return sorted(out)
