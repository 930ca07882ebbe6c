"""Roofline terms of a dry-run cell, against one H100 SXM's peaks.

compute    = FLOPs_per_device / peak FLOP/s     (989 TFLOP/s bf16, dense)
memory     = bytes_per_device / HBM bandwidth   (3.35 TB/s, HBM3)
collective = wire_bytes_per_device / link bandwidth

All three peaks are NVIDIA data-sheet figures, not measurements.  The
per-device FLOPs, bytes and collectives come from ``roofline/op_stats.py``
(the step's ops on one rank, counted as they run on the meta device); the
collective bytes use the ring formulas of :func:`collective_bytes`.

The reference's version of this module (TPU v5e peaks, HLO text parsed
for collectives) is the source of :func:`analytic_model_flops`, which
gives the reference's numbers exactly, and of :class:`Roofline`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, Tuple

PEAK_FLOPS = 989e12          # bf16 tensor cores, dense: H100 SXM data sheet
HBM_BW = 3.35e12             # bytes/s, HBM3: H100 SXM data sheet
# bytes/s a GPU sends on a ring's slowest hop.  A 16-wide mesh axis spans
# two 8-GPU nodes, so a ring over it crosses the inter-node network: one
# 400 Gb/s ConnectX-7 port per GPU (DGX H100 data sheet) = 50 GB/s.  Inside
# a node NVLink gives 450 GB/s each way (H100 SXM data sheet); the ring
# runs at its slowest link.
LINK_BW = 50e9


def ring_bytes(kind: str, payload: float, n: int) -> float:
    """Effective per-device wire bytes of one collective over ``n`` ranks
    of ``payload`` bytes (the full tensor: the all-reduce's input, the
    all-gather's output, the reduce-scatter's input, the all-to-all's
    input); a point-to-point send is one hop of its payload."""
    n = max(2, n)
    if kind == "all-reduce":
        return 2.0 * payload * (n - 1) / n
    if kind in ("all-gather", "reduce-scatter", "all-to-all"):
        return payload * (n - 1) / n
    return float(payload)           # collective-permute / send


@dataclass
class CollectiveStats:
    wire_bytes: float = 0.0                       # effective per-device bytes
    by_kind: Dict[str, float] = field(default_factory=dict)
    count: int = 0

    def add(self, kind: str, b: float):
        self.wire_bytes += b
        self.by_kind[kind] = self.by_kind.get(kind, 0.0) + b
        self.count += 1


def collective_bytes(records: Iterable[Tuple[str, float, int]]) -> CollectiveStats:
    """Effective ring-transfer bytes per device of recorded collectives,
    each ``(kind, payload bytes, group size)``."""
    stats = CollectiveStats()
    for kind, payload, n in records:
        stats.add(kind, ring_bytes(kind, payload, n))
    return stats


@dataclass
class Roofline:
    flops: float
    hbm_bytes: float              # op-granularity eager traffic
    coll: CollectiveStats
    model_flops: float = 0.0      # 6*N*D (analytic, per device)
    hbm_bytes_raw: float = 0.0    # incl. pure data movement (copies, casts)

    @property
    def compute_s(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.coll.wire_bytes / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Roofline lower bound (perfect overlap): max of the three terms."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_fraction(self) -> float:
        return self.model_flops / self.flops if self.flops else 0.0

    def as_dict(self) -> Dict:
        return {
            "flops_per_device": self.flops,
            "hbm_bytes_per_device": self.hbm_bytes,
            "hbm_bytes_raw_per_device": self.hbm_bytes_raw,
            "collective_bytes_per_device": self.coll.wire_bytes,
            "collective_by_kind": self.coll.by_kind,
            "collective_count": self.coll.count,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "bottleneck": self.bottleneck,
            "step_time_lower_bound_s": self.step_time_s,
            "model_flops_per_device": self.model_flops,
            "useful_flops_fraction": self.useful_flops_fraction,
        }


def _count(tree) -> int:
    """Elements of every Spec leaf of a spec tree."""
    if isinstance(tree, dict):
        return sum(_count(v) for v in tree.values())
    n = 1
    for d in tree.shape:
        n *= d
    return n


def analytic_model_flops(cfg, shape, n_devices: int) -> float:
    """Analytic 'useful' FLOPs per device: 2*params*tokens forward
    (x3 for train = fwd+bwd), counting only active experts, the encoder at
    its own token count, and the LM head at the positions actually computed.
    """
    from repro_torch.models.model import build_specs

    specs = build_specs(cfg)
    count = _count

    body = count(specs["groups"])
    if "shared_attn" in specs:
        sa = count(specs["shared_attn"])
        n_apps = sum(g.repeats for g in cfg.groups
                     for ls in g.pattern if ls.shared_attn)
        body += sa * n_apps
    if cfg.moe is not None:
        from repro_torch.models.moe import moe_specs
        m = cfg.moe
        per_layer = sum(count(s) for k, s in moe_specs(cfg).items()
                        if k in ("wi_gate", "wi_up", "wo"))
        n_moe = sum(g.repeats for g in cfg.groups
                    for ls in g.pattern if ls.mlp == "moe")
        body -= per_layer * n_moe * (1 - m.top_k / m.n_experts)

    B = shape.global_batch
    tokens = B * (shape.seq_len if shape.kind != "decode" else 1)
    mult = 6 if shape.kind == "train" else 2
    flops = mult * body * tokens

    # attention score+value flops (the analytic includes the KV-cache work,
    # otherwise decode cells would read as ~0% useful)
    S = shape.seq_len
    hd = cfg.head_dim_
    for g in cfg.groups:
        for ls in g.pattern:
            kinds = []
            if ls.mixer == "attn":
                kinds.append(ls.attn_kind)
            if ls.shared_attn:
                kinds.append("full")
            for kind in kinds:
                if kind == "mla":
                    qk = cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim
                    vd = cfg.mla.v_head_dim
                else:
                    qk = vd = hd
                if kind == "cross":
                    kv_len_eff = cfg.n_frontend_tokens
                    q_tokens = tokens
                elif shape.kind == "decode":
                    kv_len_eff = min(S, cfg.window) if kind == "local" else S
                    q_tokens = B
                else:  # causal full-seq: average kv length = S/2 (or window)
                    kv_len_eff = min(S, cfg.window) if kind == "local" else S / 2
                    q_tokens = tokens
                # fwd = qk-matmul + pv-matmul = 2*q*kv*H*(qk+vd); train x3
                per_layer = 2 * q_tokens * kv_len_eff * cfg.n_heads * (qk + vd)
                flops += (mult / 2) * per_layer * g.repeats

    if cfg.encoder_groups and shape.kind != "decode":
        enc = count(specs["encoder"]["groups"])
        flops += mult * enc * B * cfg.n_frontend_tokens
        for g in cfg.encoder_groups:
            flops += ((mult / 2) * g.repeats * 2 * B
                      * cfg.n_frontend_tokens ** 2 * cfg.n_heads * 2 * hd)

    head = cfg.d_model * cfg.vocab_padded
    head_tokens = tokens if shape.kind == "train" else B
    flops += mult * head * head_tokens
    if cfg.mtp and shape.kind == "train":
        flops += mult * (count(specs["mtp"]) + head) * tokens
    return flops / n_devices
