"""Seeded weights, made by the benchmark on the device.

One ``torch.Generator`` on the device, one draw per leaf (a layer stack is
one call), in the served type (bf16), laid out as the port's parameter
tree (``repro_torch.models.model.build_specs``): the program and the
reference are handed the same tensors.  Matrices are drawn with standard
deviation ``1 / sqrt(fan_in)``, the residual branches' output projections
with a further ``1 / sqrt(2 n_layers)`` (GPT-2's scaled init: without it
the random stream's response to a rounding grows from layer to layer, and
a bf16 forward of 40 layers departs from its f32 reference by ~2-3
logits); the norms' scales (used as ``1 + scale``) with 0.1, so a
reference that drops them differs.  Queries and keys get
twice that (with qk-norm: their scales centred on 1, a factor of 2), so
that the attention logits spread by about 4 and attention picks out
positions: with a unit spread it averages over the context, a random
model's greedy output falls into short cycles of one token's successor,
and served tokens with wide margins leave no near-tie at which a change
of precision would show.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

NORM_STD = 0.1


def shapes(model: dict) -> Dict[str, object]:
    """The parameter tree's draws, ``(shape, std[, mean])`` nested as the
    port's tree."""
    D, L = model["d_model"], model["n_layers"]
    H, Hkv, hd = model["n_heads"], model["n_kv_heads"], model["head_dim"]
    F, V = model["d_ff"], model["vocab_padded"]
    qk = 1.0 if model["qk_norm"] else 2.0
    out = 1 / math.sqrt(2 * L)          # each residual branch's share
    attn = {"wq": ((L, D, H, hd), qk / math.sqrt(D)),
            "wk": ((L, D, Hkv, hd), qk / math.sqrt(D)),
            "wv": ((L, D, Hkv, hd), 1 / math.sqrt(D)),
            "wo": ((L, H, hd, D), out / math.sqrt(H * hd))}
    if model["qk_norm"]:
        attn["q_scale"] = ((L, hd), NORM_STD, 1.0)
        attn["k_scale"] = ((L, hd), NORM_STD, 1.0)
    if model["act"] == "swiglu":
        mlp = {"wi_gate": ((L, D, F), 1 / math.sqrt(D)),
               "wi_up": ((L, D, F), 1 / math.sqrt(D)),
               "wo": ((L, F, D), out / math.sqrt(F))}
    else:
        mlp = {"wi": ((L, D, F), 1 / math.sqrt(D)),
               "wo": ((L, F, D), out / math.sqrt(F))}
    layer = {"norm1": ((L, D), NORM_STD), "attn": attn,
             "norm2": ((L, D), NORM_STD), "mlp": mlp}
    return {"embed": ((V, D), 1.0), "final_norm": ((D,), NORM_STD),
            "lm_head": ((D, V), 1 / math.sqrt(D)),
            "groups": {"g0": {"p0": layer}}}


def make_params(model: dict, seed: int, device) -> Dict[str, object]:
    """The bf16 weights of ``model`` drawn from ``seed`` on ``device``."""
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))

    def draw(tree):
        if isinstance(tree, dict):
            return {k: draw(v) for k, v in sorted(tree.items())}
        shape, std, mean = (tree + (0.0,))[:3]
        t = torch.randn(shape, generator=gen, device=device,
                        dtype=torch.bfloat16)
        return t.mul_(std).add_(mean)

    return draw(shapes(model))


def same_layout(params, port_abstract) -> None:
    """Raise unless ``params`` has the port's keys and shapes (its
    ``abstract_params`` tree of ``meta`` tensors)."""
    def walk(a, b, path):
        if isinstance(b, dict):
            if not isinstance(a, dict) or set(a) != set(b):
                raise ValueError(f"{path}: keys {sorted(a) if isinstance(a, dict) else a} "
                                 f"!= the port's {sorted(b)}")
            for k in b:
                walk(a[k], b[k], f"{path}/{k}")
        elif tuple(a.shape) != tuple(b.shape):
            raise ValueError(f"{path}: shape {tuple(a.shape)} != the "
                             f"port's {tuple(b.shape)}")
    walk(params, port_abstract, "")
