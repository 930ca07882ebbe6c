"""gemma2-27b [arXiv:2408.00118; hf]: 46L, d=4608, 32H (GQA kv=16),
d_ff=36864, vocab=256000.  Local(4096)+global alternating attention, logit
softcaps (attn 50, final 30), post-norms, embedding scaling."""

from repro_torch.configs.base import ArchConfig, Group, LayerSpec

CONFIG = ArchConfig(
    name="gemma2-27b", family="dense",
    d_model=4608, n_heads=32, n_kv_heads=16, head_dim=128,
    d_ff=36864, vocab=256000,
    groups=(Group(23, (LayerSpec(mixer="attn", attn_kind="local"),
                       LayerSpec(mixer="attn", attn_kind="full"))),),
    window=4096, attn_softcap=50.0, logit_softcap=30.0,
    attn_scale=256.0, post_norms=True, embed_scale=True,
    tie_embeddings=True, act="gelu",
    sub_quadratic=False,   # global layers are full attention -> skip long_500k
)

SMOKE = ArchConfig(
    name="gemma2-smoke", family="dense",
    d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, vocab=256,
    groups=(Group(2, (LayerSpec(mixer="attn", attn_kind="local"),
                      LayerSpec(mixer="attn", attn_kind="full"))),),
    window=8, attn_softcap=50.0, logit_softcap=30.0, attn_scale=16.0,
    post_norms=True, embed_scale=True, tie_embeddings=True, act="gelu",
    remat="none",
)
