"""The plain reference forward of a dense GQA decoder, as the port's layer
equations state it (the configuration file lists where they depart from
the published model):

* RMSNorm ``x * rsqrt(mean(x^2) + eps) * (1 + scale)``, before attention,
  before the MLP and before the head; per-head RMSNorm of q and k where
  ``qk_norm``;
* RoPE on interleaved (even, odd) pairs of the first ``rope_pct`` of each
  head's features, angle ``p / theta^(2i / rot)``;
* causal softmax attention, ``1 / sqrt(head_dim)``, query head ``h`` on
  kv head ``h // (n_heads / n_kv_heads)``;
* MLP ``gelu_tanh(x Wi) Wo`` or SwiGLU ``(silu(x Wg) * x Wu) Wo``;
* sequential residuals, no biases, an untied head.

Computed in float32 with TF32 off, a layer at a time over all sequences,
and a block of query rows at a time, so that it fits beside what is left
on the card.  ``precision="fp8"`` is the control: every matrix product
takes its operands rounded to float8 e4m3 -- an activation scaled per
row, a weight per output column, q, k and v per head vector (the cache in
fp8) and the attention probabilities per row -- as an fp8 serving path
would.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

Q_ROWS = 1024                    # query rows a block of attention


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to float8 e4m3 with an absmax scale along ``dim``."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12)
    s = 448.0 / amax
    return (x * s).to(torch.float8_e4m3fn).float() / s


class Reference:
    def __init__(self, model: dict, params: Dict, precision: str = "f32"):
        if precision not in ("f32", "fp8"):
            raise ValueError(f"precision must be f32 or fp8, got {precision!r}")
        self.m = model
        self.p = params
        self.fp8 = precision == "fp8"

    def _mm(self, a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if self.fp8:
            return _fp8(a, -1) @ _fp8(w, 0)
        return a @ w

    def _norm(self, x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
        var = (x * x).mean(dim=-1, keepdim=True)
        return x * torch.rsqrt(var + self.m["norm_eps"]) * (1.0 + scale.float())

    def _rope(self, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        hd = x.shape[-1]
        rot = int(hd * self.m["rope_pct"])
        rot -= rot % 2
        if rot == 0:
            return x
        i = torch.arange(0, rot, 2, device=x.device, dtype=torch.float64)
        ang = pos.double()[:, None] / (self.m["rope_theta"] ** (i / rot))
        cos = torch.cos(ang).float()[:, None, :]
        sin = torch.sin(ang).float()[:, None, :]
        a, b = x[..., 0:rot:2], x[..., 1:rot:2]
        out = torch.stack([a * cos - b * sin, b * cos + a * sin], dim=-1)
        return torch.cat([out.flatten(-2), x[..., rot:]], dim=-1)

    def _attend(self, q, k, v):
        """Causal attention of one sequence: q (S, H, hd), k/v (S, Hkv, hd)."""
        S, H, hd = q.shape
        G = H // k.shape[1]
        k = k.repeat_interleave(G, dim=1).transpose(0, 1)     # (H, S, hd)
        v = v.repeat_interleave(G, dim=1).transpose(0, 1)
        qh = q.transpose(0, 1)                                 # (H, S, hd)
        if self.fp8:
            qh, k, v = _fp8(qh, -1), _fp8(k, -1), _fp8(v, -1)
        out = torch.empty_like(qh)
        scale = 1.0 / math.sqrt(hd)
        for lo in range(0, S, Q_ROWS):
            hi = min(S, lo + Q_ROWS)
            s = (qh[:, lo:hi] @ k[:, :hi].transpose(1, 2)) * scale
            mask = (torch.arange(hi, device=q.device)[None, :]
                    > torch.arange(lo, hi, device=q.device)[:, None])
            s.masked_fill_(mask, float("-inf"))
            p = torch.softmax(s, dim=-1)
            out[:, lo:hi] = (_fp8(p, -1) if self.fp8 else p) @ v[:, :hi]
        return out.transpose(0, 1)                             # (S, H, hd)

    def _layer(self, x: torch.Tensor, lp: Dict, pos: torch.Tensor):
        m = self.m
        H, Hkv, hd = m["n_heads"], m["n_kv_heads"], m["head_dim"]
        S = x.shape[0]
        h = self._norm(x, lp["norm1"])
        q = self._mm(h, lp["wq"]).view(S, H, hd)
        k = self._mm(h, lp["wk"]).view(S, Hkv, hd)
        v = self._mm(h, lp["wv"]).view(S, Hkv, hd)
        if m["qk_norm"]:
            q = self._norm(q, lp["q_scale"])
            k = self._norm(k, lp["k_scale"])
        q, k = self._rope(q, pos), self._rope(k, pos)
        o = self._attend(q, k, v).reshape(S, H * hd)
        x = x + self._mm(o, lp["wo"])
        h = self._norm(x, lp["norm2"])
        if "wi_gate" in lp:
            a = F.silu(self._mm(h, lp["wi_gate"])) * self._mm(h, lp["wi_up"])
        else:
            a = F.gelu(self._mm(h, lp["wi"]), approximate="tanh")
        return x + self._mm(a, lp["wo_mlp"])

    def _layer_weights(self, i: int) -> Dict[str, torch.Tensor]:
        """Layer i's weights as f32 2-D matrices (made anew each layer)."""
        g = self.p["groups"]["g0"]["p0"]
        at, mlp = g["attn"], g["mlp"]
        D = self.m["d_model"]
        lp = {"norm1": g["norm1"][i], "norm2": g["norm2"][i],
              "wq": at["wq"][i].float().reshape(D, -1),
              "wk": at["wk"][i].float().reshape(D, -1),
              "wv": at["wv"][i].float().reshape(D, -1),
              "wo": at["wo"][i].float().reshape(-1, D),
              "wo_mlp": mlp["wo"][i].float()}
        if self.m["qk_norm"]:
            lp["q_scale"], lp["k_scale"] = at["q_scale"][i], at["k_scale"][i]
        for name in ("wi", "wi_gate", "wi_up"):
            if name in mlp:
                lp[name] = mlp[name][i].float()
        return lp

    @torch.no_grad()
    def logits(self, seqs: Sequence[Sequence[int]],
               starts: Sequence[int]) -> List[torch.Tensor]:
        """For each token sequence, the f32 logits ``(S - start, vocab)`` of
        positions ``start ..`` (each sequence at positions 0..S-1)."""
        no_tf32()
        dev = self.p["embed"].device
        embed = self.p["embed"]
        xs, poss = [], []
        for s in seqs:
            t = torch.as_tensor(list(s), dtype=torch.long, device=dev)
            xs.append(embed[t].float())
            poss.append(torch.arange(len(s), device=dev))
        for i in range(self.m["n_layers"]):
            lp = self._layer_weights(i)
            xs = [self._layer(x, lp, pos) for x, pos in zip(xs, poss)]
            del lp
        head = self.p["lm_head"].float()[:, :self.m["vocab"]]
        out = []
        for x, st in zip(xs, starts):
            h = self._norm(x[st:], self.p["final_norm"])
            out.append(self._mm(h, head))
        return out
