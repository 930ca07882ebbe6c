"""--arch registry: one exact config per architecture of the reference
package, and its reduced smoke variant.  The same names and aliases as
the reference's ``configs/registry.py``; the dry-run helpers
(``input_specs``, ``all_cells``) come with the dry-run slice."""

from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchConfig

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
