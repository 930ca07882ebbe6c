"""whisper-small [arXiv:2212.04356]: enc-dec, 12L+12L, d=768, 12H,
d_ff=3072, vocab=51865.  Conv audio frontend is a STUB (input_specs provides
1500 pre-computed frame embeddings).  Decoder: self-attn + cross-attn + MLP.

Deviation note (DESIGN.md): decode shapes use the stated seq_len KV
mechanically; the real model caps decoder positions at 448."""

from repro_torch.configs.base import ArchConfig, Group, LayerSpec

_dec_pattern = (LayerSpec(mixer="attn", attn_kind="full", mlp="none"),
                LayerSpec(mixer="attn", attn_kind="cross", mlp="dense"))

CONFIG = ArchConfig(
    name="whisper-small", family="audio",
    d_model=768, n_heads=12, n_kv_heads=12,
    d_ff=3072, vocab=51865,
    groups=(Group(12, _dec_pattern),),
    encoder_groups=(Group(12, (LayerSpec(mixer="attn", attn_kind="full",
                                         mlp="dense", causal=False),)),),
    n_frontend_tokens=1500,
    act="gelu", embed_scale=False, tie_embeddings=True,
    sub_quadratic=False,
)

SMOKE = ArchConfig(
    name="whisper-smoke", family="audio",
    d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=256,
    groups=(Group(2, _dec_pattern),),
    encoder_groups=(Group(2, (LayerSpec(mixer="attn", attn_kind="full",
                                        mlp="dense", causal=False),)),),
    n_frontend_tokens=24, act="gelu", tie_embeddings=True, remat="none",
)
