"""The output check that decides ``correct``.

Once the window has closed and the program's state is freed, a sample
of the requests the program finished -- drawn from the seed, the longest
always in it -- is run through the plain reference (``reference/``) in
float32: each prompt followed by its served tokens, as the program fed
them.  The numbers compared are the widest and the mean gap by which a
served token's reference logit lies below the reference's best logit at
that position (0 where the program served the reference's best).

The port feeds the last prompt token again at the first decode step
(position ``len(prompt)``), and each served token at the next: so the
sequence the reference reads is ``prompt + [prompt[-1]] + out[:-1]`` and
served token ``j`` is scored at position ``len(prompt) + j``.
"""

from __future__ import annotations

import random
from typing import List, Sequence, Tuple

import torch


def served_sequence(prompt: Sequence[int], out: Sequence[int]):
    """(tokens the program's positions hold, first served position)."""
    return list(prompt) + [prompt[-1]] + list(out[:-1]), len(prompt)


def sample(finished: List[Tuple[list, list]], k: int, seed: int):
    """``k`` of the finished (prompt, out) pairs: the longest, and the
    rest drawn from ``seed``."""
    if not finished:
        return []
    order = sorted(range(len(finished)),
                   key=lambda j: -(len(finished[j][0]) + len(finished[j][1])))
    rest = order[1:]
    random.Random(int(seed) % (1 << 63)).shuffle(rest)
    return [finished[j] for j in [order[0]] + rest[:k - 1]]


def gaps(ref_logits: torch.Tensor, tokens: Sequence[int]) -> torch.Tensor:
    """Per position, the reference's best logit minus its logit of the
    token given there."""
    t = torch.as_tensor(list(tokens), device=ref_logits.device)
    return ref_logits.max(dim=-1).values - ref_logits.gather(
        1, t[:, None])[:, 0]


def _readings(all_gaps: List[torch.Tensor]) -> Tuple[float, float, int]:
    g = torch.cat(all_gaps)
    return float(g.max()), float(g.mean()), int(g.numel())


def served_gaps(reference, pairs) -> Tuple[float, float, int]:
    """(widest gap, mean gap, tokens compared) over the served tokens of
    ``pairs``."""
    seqs, starts = zip(*(served_sequence(p, o) for p, o in pairs))
    return _readings([gaps(lg, out) for lg, (_, out) in
                      zip(reference.logits(seqs, starts), pairs)])


def control_gaps(reference, control, pairs) -> Tuple[float, float, int]:
    """The control's readings on the same sequences: at each served
    position, the gap of the token the control puts first."""
    seqs, starts = zip(*(served_sequence(p, o) for p, o in pairs))
    return _readings([gaps(lg, cl.argmax(dim=-1).tolist()) for lg, cl in
                      zip(reference.logits(seqs, starts),
                          control.logits(seqs, starts))])
