"""End-to-end training example on the PyTorch/CUDA port, the twin of
``train_tiny_lm.py``: the same tiny f32 LM on the synthetic pipeline, a few
hundred steps with checkpointing, straggler monitoring and restart.

    PYTHONPATH=src python examples/train_tiny_lm_torch.py --steps 200 [--device cpu]
"""

import argparse
import os
import tempfile

from repro_torch.configs.base import ArchConfig, dense_stack
from repro_torch.data.pipeline import DataConfig
from repro_torch.train.trainer import Trainer, TrainerConfig


def tiny_lm_config(d_model: int = 128, layers: int = 4) -> ArchConfig:
    """The tiny f32 LM (``train_tiny_lm.py``'s)."""
    return ArchConfig(
        name="tiny-lm", d_model=d_model, n_heads=8, n_kv_heads=4,
        d_ff=d_model * 4, vocab=512, groups=dense_stack(layers),
        remat="none", dtype="float32")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_tiny_lm"))
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = tiny_lm_config(args.d_model, args.layers)
    tcfg = TrainerConfig(steps=args.steps, ckpt_every=50, log_every=10,
                         ckpt_dir=args.ckpt_dir, lr_peak=1e-3)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=128, global_batch=8, seed=0)
    tr = Trainer(cfg, tcfg, dcfg, device=args.device)
    tr.install_preemption_handler()
    out = tr.run()
    first = sum(h["loss"] for h in out["history"][:10]) / 10
    last = sum(h["loss"] for h in out["history"][-10:]) / 10
    print(f"\nloss {first:.3f} -> {last:.3f} over {out['step']} steps "
          f"({len(out['straggler_events'])} straggler events)")
    print(f"checkpoints in {args.ckpt_dir}; rerun to resume from step "
          f"{out['step']}")
    return out


if __name__ == "__main__":
    main()
