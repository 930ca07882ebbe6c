"""llama-3.2-vision-90b [hf:meta-llama/Llama-3.2-90B-Vision]: 100L total,
d=8192, 64H (GQA kv=8), d_ff=28672, vocab=128256.  Cross-attention to image
tokens every 5th layer; the vision frontend is a STUB (input_specs provides
pre-projected patch embeddings, 1601 tokens)."""

from repro_torch.configs.base import ArchConfig, Group, LayerSpec

_pattern = tuple([LayerSpec(mixer="attn", attn_kind="full")] * 4 +
                 [LayerSpec(mixer="attn", attn_kind="cross")])

CONFIG = ArchConfig(
    name="llama-3.2-vision-90b", family="vlm",
    d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=28672, vocab=128256,
    groups=(Group(20, _pattern),),
    rope_theta=5e5, qk_norm=True,
    n_frontend_tokens=1601,
    sub_quadratic=False,
)

_smoke_pattern = tuple([LayerSpec(mixer="attn", attn_kind="full")] * 2 +
                       [LayerSpec(mixer="attn", attn_kind="cross")])

SMOKE = ArchConfig(
    name="llama-vision-smoke", family="vlm",
    d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=256,
    groups=(Group(2, _smoke_pattern),),
    qk_norm=True, n_frontend_tokens=17, remat="none",
)
