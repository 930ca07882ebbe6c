"""starcoder2-7b [arXiv:2402.19173]: 32L, d=4608, 36H (GQA kv=4),
d_ff=18432, vocab=49152.  GQA + RoPE, GELU MLP."""

from repro_torch.configs.base import ArchConfig, dense_stack

CONFIG = ArchConfig(
    name="starcoder2-7b", family="dense",
    d_model=4608, n_heads=36, n_kv_heads=4,
    d_ff=18432, vocab=49152,
    groups=dense_stack(32), act="gelu",
    sub_quadratic=False,
)

SMOKE = ArchConfig(
    name="starcoder2-smoke", family="dense",
    d_model=72, n_heads=6, n_kv_heads=2, d_ff=144, vocab=256,
    groups=dense_stack(3), act="gelu", remat="none",
)
