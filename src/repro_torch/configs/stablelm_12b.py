"""stablelm-12b [hf:stabilityai/stablelm-2-12b]: 40L, d=5120, 32H (GQA kv=8),
d_ff=13824, vocab=100352.  Partial rotary (25%), qk-norm per head."""

from repro_torch.configs.base import ArchConfig, dense_stack

CONFIG = ArchConfig(
    name="stablelm-12b", family="dense",
    d_model=5120, n_heads=32, n_kv_heads=8,
    d_ff=13824, vocab=100352,
    groups=dense_stack(40),
    rope_pct=0.25, qk_norm=True,
    sub_quadratic=False,
)

SMOKE = ArchConfig(
    name="stablelm-smoke", family="dense",
    d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=256,
    groups=dense_stack(3), rope_pct=0.25, qk_norm=True, remat="none",
)
