"""Weights from the reference package, as PyTorch tensors.

:func:`params_from_jax` takes the reference's parameter tree AFTER the
caller has fetched it to the host (``jax.device_get``): nested dicts of
numpy arrays, bf16 leaves as ml_dtypes ``bfloat16`` arrays.  It never
imports JAX.  The key layout is the same in both packages, so the bridge
is 1:1, leaf for leaf.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

__all__ = ["numpy_to_tensor", "params_from_jax"]


def numpy_to_tensor(a: np.ndarray, device=None) -> torch.Tensor:
    """A numpy array as a tensor with the same bits.  An ml_dtypes bfloat16
    array goes through its uint16 view, since numpy has no bfloat16 of its
    own and ``torch.from_numpy`` does not take one."""
    a = np.array(a, order="C")          # own, writable copy
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t if device is None else t.to(device)


def params_from_jax(tree: Any, device=None) -> Any:
    """Nested dicts of numpy arrays -> the same dicts of tensors."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    return numpy_to_tensor(np.asarray(tree), device)
