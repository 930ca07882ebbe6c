"""olmoe-1b-7b [arXiv:2409.02060]: 16L, d=2048, 16H (GQA kv=16), MoE with
64 experts top-8, per-expert d_ff=1024, vocab=50304."""

from repro_torch.configs.base import ArchConfig, Group, LayerSpec, MoEConfig

CONFIG = ArchConfig(
    name="olmoe-1b-7b", family="moe",
    d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1024, vocab=50304,
    groups=(Group(16, (LayerSpec(mixer="attn", mlp="moe"),)),),
    moe=MoEConfig(n_experts=64, top_k=8, d_ff=1024),
    qk_norm=True,
    sub_quadratic=False,
)

SMOKE = ArchConfig(
    name="olmoe-smoke", family="moe",
    d_model=64, n_heads=4, n_kv_heads=4, d_ff=64, vocab=256,
    groups=(Group(2, (LayerSpec(mixer="attn", mlp="moe"),)),),
    moe=MoEConfig(n_experts=8, top_k=2, d_ff=64, capacity_factor=4.0),
    qk_norm=True, remat="none",
)
