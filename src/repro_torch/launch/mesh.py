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
    """``device_type``, else ``"cuda"``: a mesh never falls back to the
    CPU on its own (pass ``"cpu"`` for that, as the dry-run and the tests
    do)."""
    if device_type is not None:
        return device_type
    if not torch.cuda.is_available():
        raise RuntimeError(
            "a mesh runs on CUDA and no CUDA device is available; pass "
            "device_type='cpu' to build it on the CPU")
    return "cuda"


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: Optional[str] = None):
    """The production ``DeviceMesh`` over the live process group, whose
    world size must be 256 (or 512 with ``multi_pod``): the dry-run
    starts a ``fake`` group of that size."""
    from torch.distributed.device_mesh import init_device_mesh
    device_type = _device_type(device_type)
    shape, axes = PRODUCTION[multi_pod]
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_host_mesh(shape: Optional[Sequence[int]] = None,
                   axes: Sequence[str] = ("data", "model"),
                   device_type: Optional[str] = None):
    """A small mesh over the live process group's ranks (tests, examples,
    the card's ``dist`` phase); ``shape`` defaults to (world, 1)."""
    from torch.distributed.device_mesh import init_device_mesh
    device_type = _device_type(device_type)
    if shape is None:
        shape = (dist.get_world_size(), 1)
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))
