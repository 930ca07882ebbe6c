"""rwkv6-1.6b (Finch) [arXiv:2404.05892]: 24L, d=2048, attention-free
(data-dependent decay WKV), channel-mix d_ff=7168, vocab=65536.

POP applicability note (DESIGN.md): no per-token KV cache exists; the
recurrent state is constant-size and request-owned."""

from repro_torch.configs.base import ArchConfig, Group, LayerSpec, SSMConfig

CONFIG = ArchConfig(
    name="rwkv6-1.6b", family="ssm",
    d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=7168, vocab=65536,
    groups=(Group(24, (LayerSpec(mixer="rwkv6", mlp="none"),)),),
    ssm=SSMConfig(head_dim=64),
    sub_quadratic=True,
)

SMOKE = ArchConfig(
    name="rwkv6-smoke", family="ssm",
    d_model=64, n_heads=2, n_kv_heads=2, d_ff=128, vocab=256,
    groups=(Group(3, (LayerSpec(mixer="rwkv6", mlp="none"),)),),
    ssm=SSMConfig(head_dim=32),
    sub_quadratic=True, remat="none",
)
