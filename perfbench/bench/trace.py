"""The traced run's wrappers: transparent spans around the calls into the
model step (``serve/paged_model.py``'s ``paged_decode_step`` and
``prefill_chunk_step``) and around each paged attention launch
(``kernels/ops.py``'s ``paged_attention``).

Installed only in a ``--trace 1`` run.  A forward's record carries what
its host-side arguments say: rows, positions and, inside the profiler
slice, each row's pages, from which ``flops.py`` gives the model FLOPs and
each launch's operations and bytes.  The launch log is appended under the
page store's write guard, which every paged launch holds, so its order is
the launches' order on the one stream.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import List, Optional

from perfbench.bench import flops


@dataclass
class Call:
    kind: str                         # "decode" | "prefill"
    t: float                          # monotonic, at the call
    rows: int
    flops: int
    start: int = 0                    # prefill: the chunk's first position
    pages: Optional[list] = None      # decode: each row's pages (slice only)
    attended: Optional[list] = None   # decode: positions each row reads


class Wrappers:
    def __init__(self, model: dict):
        self.model = model
        self.calls: List[Call] = []
        self.launches: List[Optional[int]] = []   # the call of each launch
        self.detail = False       # keep the decode rows' pages (the slice)
        self._lock = threading.Lock()
        self._tls = threading.local()
        self._undo = []

    def _record(self, c: Call) -> int:
        with self._lock:
            self.calls.append(c)
            return len(self.calls) - 1

    def _within(self, idx: int, fn, *a, **kw):
        self._tls.call = idx
        try:
            return fn(*a, **kw)
        finally:
            self._tls.call = None

    def install(self) -> None:
        import repro_torch.kernels.ops as kops
        import repro_torch.serve.paged_model as pm

        dec, pre, pa = pm.paged_decode_step, pm.prefill_chunk_step, \
            kops.paged_attention
        model = self.model

        def paged_decode_step(params, cfg, store, blocks, lens, last, **kw):
            lens_l = [int(n) for n in lens]
            c = Call("decode", time.monotonic(), len(lens_l),
                     flops.decode_flops(model, lens_l))
            if self.detail:
                c.pages = [list(b) for b in blocks]
                c.attended = [n + 1 for n in lens_l]
            return self._within(self._record(c), dec, params, cfg, store,
                                blocks, lens, last, **kw)

        def prefill_chunk_step(params, cfg, store, blocks, tokens, start,
                               **kw):
            n = len(tokens)
            c = Call("prefill", time.monotonic(), n,
                     flops.prefill_chunk_flops(model, int(start), n),
                     start=int(start))
            return self._within(self._record(c), pre, params, cfg, store,
                                blocks, tokens, start, **kw)

        def paged_attention(*a, **kw):
            self.launches.append(getattr(self._tls, "call", None))
            return pa(*a, **kw)

        pm.paged_decode_step = paged_decode_step
        pm.prefill_chunk_step = prefill_chunk_step
        kops.paged_attention = paged_attention
        self._undo = [(pm, "paged_decode_step", dec),
                      (pm, "prefill_chunk_step", pre),
                      (kops, "paged_attention", pa)]

    def uninstall(self) -> None:
        for mod, name, fn in self._undo:
            setattr(mod, name, fn)
        self._undo = []

    def launch_cost(self, idx: int, page: int) -> Optional[dict]:
        """Operations and bytes of one layer's launch of call ``idx``; None
        for a decode call made before the slice began (its rows' pages
        were not kept)."""
        c = self.calls[idx]
        if c.kind == "decode" and c.pages is None:
            return None
        if c.kind == "prefill":
            # every row reads the one request's pages: each slot up to the
            # chunk's end once; the chunk's rows are the new rows
            attended = [c.start + i + 1 for i in range(c.rows)]
            H, hd = self.model["n_heads"], self.model["head_dim"]
            slot = 2 * self.model["n_kv_heads"] * hd * 2
            return {"ops": 4 * H * hd * sum(attended),
                    "bytes": ((c.start + c.rows) * slot + c.rows * slot
                              + 2 * c.rows * H * hd * 4)}
        return flops.paged_launch(self.model, page, c.pages, c.attended,
                                  new_rows=c.rows)
