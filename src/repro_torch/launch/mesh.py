"""Mesh construction.

FUNCTIONS, not module-level constants: importing this module starts no
process group and touches no device, so the dry-run can start its own
(the ``fake`` backend) first and tests can import it freely.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.parallel.sharding import AbstractMesh

PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


def production_shape(multi_pod: bool = False) -> AbstractMesh:
    """The production mesh's shape and axis names, with no devices: 16x16
    (data x model) per pod, and a leading 2-pod axis for multi-pod -- the
    reference's shapes and names, so the sharding decisions compare."""
    shape, axes = PRODUCTION[multi_pod]
    return AbstractMesh(shape, axes)


def _device_type(device_type: Optional[str]) -> str:
    if device_type is not None:
        return device_type
    return "cuda" if torch.cuda.is_available() else "cpu"


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: Optional[str] = None):
    """The production ``DeviceMesh`` over the live process group, whose
    world size must be 256 (or 512 with ``multi_pod``): the dry-run
    starts a ``fake`` group of that size."""
    from torch.distributed.device_mesh import init_device_mesh
    shape, axes = PRODUCTION[multi_pod]
    return init_device_mesh(_device_type(device_type), shape,
                            mesh_dim_names=axes)


def make_host_mesh(shape: Optional[Sequence[int]] = None,
                   axes: Sequence[str] = ("data", "model"),
                   device_type: Optional[str] = None):
    """A small mesh over the live process group's ranks (tests, examples,
    the card's ``dist`` phase); ``shape`` defaults to (world, 1)."""
    from torch.distributed.device_mesh import init_device_mesh
    n = dist.get_world_size()
    if shape is None:
        shape = (n, 1)
    return init_device_mesh(_device_type(device_type), tuple(shape),
                            mesh_dim_names=tuple(axes))
