"""Architecture configuration schema.

A model is a sequence of *groups*; each group is a layer pattern repeated R
times and executed with ``jax.lax.scan`` over the repeats (one compile of the
pattern body regardless of depth -- essential for the 512-device dry-run).
Pattern layers are :class:`LayerSpec`s; weights for each pattern position are
stacked over the repeat dimension.  Weight-tied blocks (zamba2's shared
attention) live outside the stacks and are closed over by the scan body.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class LayerSpec:
    """One position in a layer pattern."""

    mixer: str = "attn"          # attn | mamba2 | rwkv6 | none
    attn_kind: str = "full"      # full | local | mla | cross  (for mixer=attn)
    mlp: str = "dense"           # dense | moe | none
    shared_attn: bool = False    # apply the weight-tied shared attention block
    causal: bool = True          # False: bidirectional (whisper encoder)
    parallel: bool = False       # parallel residual (attn + mlp off one norm)


@dataclass(frozen=True)
class Group:
    repeats: int
    pattern: Tuple[LayerSpec, ...]

    @property
    def n_layers(self) -> int:
        return self.repeats * len(self.pattern)


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 64
    n_shared: int = 0
    top_k: int = 8
    d_ff: int = 1024             # per-expert hidden
    capacity_factor: float = 1.25
    router_z_coef: float = 1e-3
    aux_coef: float = 1e-2


@dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64           # mamba2 SSD head dim


@dataclass(frozen=True)
class ArchConfig:
    name: str = "arch"
    family: str = "dense"        # dense | moe | ssm | hybrid | vlm | audio

    d_model: int = 1024
    n_heads: int = 8
    n_kv_heads: int = 8
    head_dim: int = 0            # 0 => d_model // n_heads
    d_ff: int = 4096
    vocab: int = 32000
    groups: Tuple[Group, ...] = ()

    # attention details
    rope_theta: float = 10000.0
    rope_pct: float = 1.0        # partial rotary (stablelm)
    window: int = 4096           # sliding window for attn_kind=local
    attn_softcap: float = 0.0    # gemma2: 50.0
    logit_softcap: float = 0.0   # gemma2: 30.0
    qk_norm: bool = False
    attn_scale: Optional[float] = None  # gemma2 query_pre_attn_scalar

    # substructures
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None

    # modality frontends (stubs per spec: input_specs provides embeddings)
    encoder_groups: Tuple[Group, ...] = ()   # whisper encoder stack
    n_frontend_tokens: int = 0   # image patches / audio frames fed pre-embedded
    frontend_dim: int = 0        # embedding dim of the stub frontend output

    # norms / misc
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    post_norms: bool = False     # gemma2: extra norm after each sublayer
    embed_scale: bool = False    # gemma2/whisper: scale embeddings by sqrt(d)
    act: str = "silu"            # silu (swiglu) | gelu
    mtp: bool = False            # deepseek multi-token-prediction head
    sub_quadratic: bool = False  # eligible for long_500k
    decode_ok: bool = True       # encoder-only would be False

    # training
    dtype: str = "bfloat16"
    remat: str = "full"          # none | dots | full

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def vocab_padded(self) -> int:
        """Vocab rounded up to a TP-friendly multiple of 256 (Megatron-style);
        padded logits are masked in the model."""
        return ((self.vocab + 255) // 256) * 256

    @property
    def n_layers(self) -> int:
        return sum(g.n_layers for g in self.groups)

    def scaled(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def dense_stack(n_layers: int, attn_kind: str = "full", mlp: str = "dense",
                parallel: bool = False) -> Tuple[Group, ...]:
    return (Group(n_layers, (LayerSpec(mixer="attn", attn_kind=attn_kind,
                                       mlp=mlp, parallel=parallel),)),)
