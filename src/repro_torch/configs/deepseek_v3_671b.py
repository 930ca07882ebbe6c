"""deepseek-v3-671b [arXiv:2412.19437]: 61L, d=7168, 128H, MLA
(q_lora=1536, kv_lora=512, nope=128, rope=64, v=128), MoE 256 routed +
1 shared top-8 with per-expert d_ff=2048 (first 3 layers dense d_ff=18432),
vocab=129280, MTP head."""


from repro_torch.configs.base import (ArchConfig, Group, LayerSpec, MLAConfig,
                                MoEConfig)

CONFIG = ArchConfig(
    name="deepseek-v3-671b", family="moe",
    d_model=7168, n_heads=128, n_kv_heads=128,
    d_ff=18432,                     # dense layers' hidden
    vocab=129280,
    groups=(
        Group(3, (LayerSpec(mixer="attn", attn_kind="mla", mlp="dense"),)),
        Group(58, (LayerSpec(mixer="attn", attn_kind="mla", mlp="moe"),)),
    ),
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                  qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(n_experts=256, n_shared=1, top_k=8, d_ff=2048),
    mtp=True,
    sub_quadratic=False,
)

SMOKE = ArchConfig(
    name="deepseek-smoke", family="moe",
    d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=256,
    groups=(
        Group(1, (LayerSpec(mixer="attn", attn_kind="mla", mlp="dense"),)),
        Group(2, (LayerSpec(mixer="attn", attn_kind="mla", mlp="moe"),)),
    ),
    mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16,
                  qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16),
    moe=MoEConfig(n_experts=8, n_shared=1, top_k=2, d_ff=32, capacity_factor=4.0),
    mtp=True, remat="none",
)
