"""--arch registry: one exact config per architecture of the reference
package, its reduced smoke variant, and the dry-run's cells: the same
names, aliases, skips and input specs as the reference's
``configs/registry.py`` (``input_specs`` gives ``meta`` tensors, no
allocation)."""

from __future__ import annotations

import importlib
from typing import Dict, Optional

import torch

from repro_torch.configs.base import SHAPES, ArchConfig, ShapeConfig

ARCHS = [
    "zamba2_2p7b", "gemma2_27b", "stablelm_12b", "starcoder2_7b",
    "codeqwen15_7b", "olmoe_1b_7b", "deepseek_v3_671b", "rwkv6_1p6b",
    "llama32_vision_90b", "whisper_small",
]

ALIASES = {
    "zamba2-2.7b": "zamba2_2p7b",
    "gemma2-27b": "gemma2_27b",
    "stablelm-12b": "stablelm_12b",
    "starcoder2-7b": "starcoder2_7b",
    "codeqwen1.5-7b": "codeqwen15_7b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "rwkv6-1.6b": "rwkv6_1p6b",
    "llama-3.2-vision-90b": "llama32_vision_90b",
    "whisper-small": "whisper_small",
}


def _module(name: str):
    return importlib.import_module(
        f"repro_torch.configs.{ALIASES.get(name, name)}")


def get_config(name: str) -> ArchConfig:
    return _module(name).CONFIG


def get_smoke_config(name: str) -> ArchConfig:
    return _module(name).SMOKE


def cell_supported(cfg: ArchConfig, shape: ShapeConfig) -> Optional[str]:
    """None if (arch x shape) is a valid dry-run cell, else the skip reason."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return "long_500k needs sub-quadratic attention (DESIGN.md carve-outs)"
    if shape.kind == "decode" and not cfg.decode_ok:
        return "architecture has no decode step"
    return None


def input_specs(cfg: ArchConfig, shape: ShapeConfig) -> Dict[str, object]:
    """``meta`` stand-ins for every model input of this cell: tokens and
    targets (int32), the decode cache (the tree of
    ``models.model.cache_shapes``), the frontend's embeddings."""
    from repro_torch.models.model import cache_shapes

    def meta(shape_, dtype):
        return torch.empty(shape_, dtype=dtype, device="meta")

    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32
    specs: Dict[str, object] = {}
    if shape.kind == "train":
        specs["tokens"] = meta((B, S), i32)
        specs["targets"] = meta((B, S), i32)
    elif shape.kind == "prefill":
        specs["tokens"] = meta((B, S), i32)
    else:  # decode: one new token against a seq_len cache
        specs["tokens"] = meta((B, 1), i32)

        def build(t):
            if isinstance(t, dict):
                return {k: build(v) for k, v in t.items()}
            return meta(*t)
        specs["cache"] = build(cache_shapes(cfg, B, S, cfg.dtype))
    if cfg.n_frontend_tokens and shape.kind != "decode":
        from repro_torch.models.layers import torch_dtype
        specs["frontend"] = meta((B, cfg.n_frontend_tokens, cfg.d_model),
                                 torch_dtype(cfg.dtype))
    return specs


def all_cells():
    """Yield (arch_name, shape_name, skip reason or None) for the 40-cell
    baseline grid."""
    for arch in ARCHS:
        cfg = get_config(arch)
        for sname, shape in SHAPES.items():
            yield arch, sname, cell_supported(cfg, shape)
