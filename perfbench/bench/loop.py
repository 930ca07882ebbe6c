"""The closed loop: ``clients`` callers, each sending its next request as
soon as its last one is done, started ``stagger_s`` apart.

One thread drives every client (it polls the clients' requests every
``POLL_S``), so the load comes from one process with few threads.  Each
request is recorded with its client and its index in the run, so that
the window's snapshots and the output check can find it.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

POLL_S = 0.02


@dataclass
class Sent:
    i: int                 # index in the run (the traffic's request i)
    client: int
    req: object            # the engine's Request


# i -> (tokens, t_last, t_first, done)
Snapshot = Dict[int, Tuple[int, float, float, bool]]


class ClosedLoop:
    def __init__(self, engine, mix, clients: int, stagger_s: float):
        self.engine = engine
        self.mix = mix
        self.clients = int(clients)
        self.stagger_s = float(stagger_s)
        self.sent: List[Sent] = []
        self.first: Dict[int, Sent] = {}     # each client's first request
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.error: Optional[BaseException] = None

    def _submit(self, client: int) -> Sent:
        i = len(self.sent)
        prompt, max_new = self.mix.request(i, client)
        s = Sent(i, client, self.engine.submit(prompt, max_new))
        self.sent.append(s)
        self.first.setdefault(client, s)
        return s

    def _run(self) -> None:
        try:
            t_start = time.monotonic()
            started = 0
            current: Dict[int, Sent] = {}
            while not self._stop.is_set():
                now = time.monotonic()
                while (started < self.clients
                       and now >= t_start + started * self.stagger_s):
                    current[started] = self._submit(started)
                    started += 1
                for c, s in current.items():
                    if s.req.done.is_set():
                        current[c] = self._submit(c)
                time.sleep(POLL_S)
        except BaseException as e:  # noqa: BLE001 -- reported by the harness
            self.error = e

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="perfbench-clients")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30)
            if self._thread.is_alive():
                raise RuntimeError("the client thread did not stop")

    def wait_all_first(self, timeout_s: float) -> None:
        """Block until every client's first request has its first token."""
        t_end = time.monotonic() + timeout_s
        while True:
            if self.error is not None:
                raise RuntimeError("client loop failed") from self.error
            if self.engine.error is not None:
                raise RuntimeError("engine failed") from self.engine.error
            if (len(self.first) == self.clients
                    and all(s.req.t_first_tok or s.req.done.is_set()
                            for s in list(self.first.values()))):
                return
            if time.monotonic() > t_end:
                raise TimeoutError(
                    f"{sum(1 for s in list(self.first.values()) if s.req.t_first_tok)}"
                    f" of {self.clients} clients had a first token after "
                    f"{timeout_s} s")
            time.sleep(0.01)

    def snapshot(self) -> Snapshot:
        """Each request's token count, last / first token times and
        whether it is done."""
        return {s.i: (len(s.req.out), s.req.t_last_tok, s.req.t_first_tok,
                      s.req.done.is_set()) for s in list(self.sent)}
