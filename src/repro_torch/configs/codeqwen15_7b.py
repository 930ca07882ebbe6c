"""codeqwen1.5-7b [hf:Qwen/CodeQwen1.5-7B]: 32L, d=4096, 32H (GQA kv=32 =
MHA), d_ff=13440, vocab=92416.  Qwen1.5 architecture (SwiGLU, RoPE)."""

from repro_torch.configs.base import ArchConfig, dense_stack

CONFIG = ArchConfig(
    name="codeqwen1.5-7b", family="dense",
    d_model=4096, n_heads=32, n_kv_heads=32,
    d_ff=13440, vocab=92416,
    groups=dense_stack(32),
    rope_theta=1e6,
    sub_quadratic=False,
)

SMOKE = ArchConfig(
    name="codeqwen-smoke", family="dense",
    d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=256,
    groups=dense_stack(3), rope_theta=1e6, remat="none",
)
