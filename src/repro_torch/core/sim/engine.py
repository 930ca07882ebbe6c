"""Errors of the SMR simulator that the serving runtime raises too.

The deterministic weak-memory simulator itself is ported in a later slice;
the block pool and the paged KV store only need its error types, so that a
use-after-free on a physical page is the same exception a simulated scheme
raises.
"""

from __future__ import annotations


class SimError(Exception):
    pass


class UseAfterFree(SimError):
    """A thread touched memory that had been freed (the bug class SMR prevents)."""

    def __init__(self, tid: int, addr: int, op: str):
        super().__init__(f"use-after-free: t{tid} {op} addr={addr}")
        self.tid, self.addr, self.op = tid, addr, op
