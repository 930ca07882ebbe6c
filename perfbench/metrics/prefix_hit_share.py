"""Block pool: share (%) of the prompt tokens admitted in the read part of
the window that the prefix cache served: the workers'
``prefill_tokens_skipped`` counters, differenced, over the prompt tokens
of the requests picked up in it."""


def read(run):
    tokens = sum(len(s.req.prompt) for s in run.sent
                 if s.req.t_admitted and run.t0 <= s.req.t_admitted < run.read_end)
    if not tokens:
        return None
    return 100.0 * run.counter_delta("prefill_tokens_skipped") / tokens
