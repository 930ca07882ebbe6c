"""Weights from the reference package, as PyTorch tensors.

:func:`params_from_jax` takes the reference's parameter tree AFTER the
caller has fetched it to the host (``jax.device_get``): nested dicts of
numpy arrays, bf16 leaves as ml_dtypes ``bfloat16`` arrays.  It never
imports JAX.  The key layout is the same in both packages, so the bridge
is 1:1, leaf for leaf.  :func:`opt_state_from_jax` carries the
reference's AdamW state the same way, and :func:`tree_to_numpy` carries
the port's tensors back, so tests can hand state across in both
directions.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.optim.adamw import AdamWState

__all__ = ["numpy_to_tensor", "opt_state_from_jax", "params_from_jax",
           "tree_to_numpy"]


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


def opt_state_from_jax(state: Any, device=None) -> AdamWState:
    """The reference's ``AdamWState`` of numpy arrays (after
    ``jax.device_get``) -> the port's, of tensors."""
    step, m, v = state
    return AdamWState(step=numpy_to_tensor(np.asarray(step), device),
                      m=params_from_jax(m, device),
                      v=params_from_jax(v, device))


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor's bits as a numpy array on the host; bf16 through its
    ``uint16`` view, as an ml_dtypes ``bfloat16`` array."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def tree_to_numpy(tree: Any) -> Any:
    """Nested dicts (or an ``AdamWState``) of tensors -> the same of numpy
    arrays, bits unchanged."""
    if isinstance(tree, dict):
        return {k: tree_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, AdamWState):
        return AdamWState(*(tree_to_numpy(x) for x in tree))
    return tensor_to_numpy(tree)
