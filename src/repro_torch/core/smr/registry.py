"""Name -> SMR scheme factory, mirroring the paper's benchmark lineup.

docs/SCHEMES.md is the human-facing reference: per-scheme paper section,
guarantees, reservation mechanism, batched-session behavior, and which
benchmarks exercise each name registered here."""

from __future__ import annotations

from typing import Callable, Dict

from repro_torch.core.sim.engine import Engine
from repro_torch.core.smr.base import NoReclamation, SMRScheme
from repro_torch.core.smr.debra import DebraPlus
from repro_torch.core.smr.ebr import EBR, IBR
from repro_torch.core.smr.epoch_pop import EpochPOP
from repro_torch.core.smr.he import HazardEras
from repro_torch.core.smr.hp import HazardPointers, HazardPointersAsym, HazardPointersBroken
from repro_torch.core.smr.hyaline import Hyaline
from repro_torch.core.smr.nbr import NBR
from repro_torch.core.smr.pop import HazardEraPOP, HazardPtrPOP

SCHEMES: Dict[str, Callable[..., SMRScheme]] = {
    "NR": NoReclamation,
    "HP": HazardPointers,
    "HP-broken": HazardPointersBroken,
    "HPAsym": HazardPointersAsym,
    "HE": HazardEras,
    "EBR": EBR,
    "IBR": IBR,
    "NBR+": NBR,
    "HazardPtrPOP": HazardPtrPOP,
    "HazardEraPOP": HazardEraPOP,
    "EpochPOP": EpochPOP,
    # related-work schemes (robustness gauntlet lineup, not in the paper's
    # figures): Hyaline [1905.07903], DEBRA+ [1712.01044]
    "Hyaline": Hyaline,
    "DEBRA+": DebraPlus,
}

# the paper's headline comparison set (Figures 1-4)
PAPER_SET = [
    "NR", "HP", "HPAsym", "HE", "EBR", "IBR", "NBR+",
    "HazardPtrPOP", "HazardEraPOP", "EpochPOP",
]


def make_scheme(name: str, engine: Engine, **kw) -> SMRScheme:
    return SCHEMES[name](engine, **kw)
