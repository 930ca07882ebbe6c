"""zamba2-2.7b [arXiv:2411.15242]: 54 Mamba2 layers (d=2560, ssm_state=64)
with a weight-TIED shared attention block (32H, GQA kv=32) applied every 6th
layer.  d_ff=10240 dense MLP interleaved on shared-attn layers, vocab=32000."""

from repro_torch.configs.base import ArchConfig, Group, LayerSpec, SSMConfig

_pattern = tuple([LayerSpec(mixer="mamba2", mlp="none")] * 5 +
                 [LayerSpec(mixer="mamba2", mlp="dense", shared_attn=True)])

CONFIG = ArchConfig(
    name="zamba2-2.7b", family="hybrid",
    d_model=2560, n_heads=32, n_kv_heads=32, head_dim=80,
    d_ff=10240, vocab=32000,
    groups=(Group(9, _pattern),),
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64),
    sub_quadratic=True,            # hybrid: runs long_500k (attn KV seq-sharded)
)

_smoke_pattern = tuple([LayerSpec(mixer="mamba2", mlp="none")] * 2 +
                       [LayerSpec(mixer="mamba2", mlp="dense", shared_attn=True)])

SMOKE = ArchConfig(
    name="zamba2-smoke", family="hybrid",
    d_model=64, n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128, vocab=256,
    groups=(Group(2, _smoke_pattern),),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=32),
    sub_quadratic=True, remat="none",
)
