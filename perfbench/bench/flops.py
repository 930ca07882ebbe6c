"""The yardstick's arithmetic: model FLOPs of the served tokens, the paged
attention launch's operations and bytes, and the chips' peaks.

Written from the configuration's shapes (``configs/<name>.json``'s
``model``), not from the program.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Sequence

#: published peaks a card, by ``torch.cuda.get_device_name()``: dense bf16
#: tensor-core FLOP/s and HBM bytes/s (NVIDIA's H100 SXM data sheet, at
#: its 700 W limit)
PEAKS: Dict[str, Dict[str, float]] = {
    "NVIDIA H100 80GB HBM3": {"flops": 989e12, "bytes_s": 3.35e12},
}


def matmul_params(model: dict) -> int:
    """Parameters of the layers' matrix products (no embedding, no head)."""
    D, H, Hkv, hd = (model["d_model"], model["n_heads"], model["n_kv_heads"],
                     model["head_dim"])
    F = model["d_ff"]
    attn = D * H * hd + 2 * D * Hkv * hd + H * hd * D
    mlp = (3 if model["act"] == "swiglu" else 2) * D * F
    return model["n_layers"] * (attn + mlp)


def attn_flops_per_position(model: dict) -> int:
    """QK and PV operations of one query row per attended position, all
    layers: 2 x (D_qk + D_v) x heads."""
    return 4 * model["n_layers"] * model["n_heads"] * model["head_dim"]


def prefill_chunk_flops(model: dict, start: int, rows: int) -> int:
    """A chunk of prompt rows at positions ``start .. start + rows - 1``:
    row p attends positions 0..p.  Their logits are not needed work."""
    attended = rows * start + rows * (rows + 1) // 2
    return (2 * matmul_params(model) * rows
            + attn_flops_per_position(model) * attended)


def decode_flops(model: dict, lens: Sequence[int]) -> int:
    """One decode step: row b holds ``lens[b]`` positions and attends them
    and its own, and yields a token through the head."""
    n = len(lens)
    attended = sum(lens) + n
    return ((2 * matmul_params(model) + 2 * model["d_model"] * model["vocab"])
            * n + attn_flops_per_position(model) * attended)


def paged_launch(model: dict, page: int, rows: Iterable[Sequence[int]],
                 attended: Sequence[int], new_rows: int) -> Dict[str, int]:
    """Operations and bytes of ONE layer's paged attention launch.

    ``rows[b]`` is row b's page list and ``attended[b]`` the positions it
    reads (its own included).  Each live KV slot is counted once, however
    many rows read its page: a page's live slots are the most any row
    reads of it.  Added: the ``new_rows`` K/V rows written, q read and the
    output written (both f32, as the launch takes and gives them)."""
    H, Hkv, hd = model["n_heads"], model["n_kv_heads"], model["head_dim"]
    live: Dict[int, int] = {}
    for pages, n in zip(rows, attended):
        full, rest = divmod(int(n), page)
        for j in range(full):
            live[pages[j]] = page
        if rest:
            b = pages[full]
            if live.get(b, 0) < rest:
                live[b] = rest
    slot_bytes = 2 * Hkv * hd * 2                      # K and V, bf16
    nq = len(attended)
    nbytes = (sum(live.values()) * slot_bytes + new_rows * slot_bytes
              + 2 * nq * H * hd * 4)
    ops = 4 * H * hd * int(sum(attended))
    return {"ops": ops, "bytes": nbytes}


def bound_s(ops: float, nbytes: float, peak: Dict[str, float]) -> float:
    """The least time the chip could take: the larger of the two bounds."""
    return max(ops / peak["flops"], nbytes / peak["bytes_s"])


def forwards_mfu(run, kind: str) -> Optional[float]:
    """The model FLOPs of ``kind`` forwards ("prefill" | "decode") issued
    in the read part of a traced run's window, over its seconds times the
    card's bf16 peak, in %."""
    if run.peak is None:
        return None
    f = sum(c.flops for c in run.calls
            if c.kind == kind and run.t0 <= c.t < run.read_end)
    if not f:
        return None
    return 100.0 * f / ((run.read_end - run.t0) * run.peak["flops"])
