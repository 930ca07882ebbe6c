"""Training launcher: ``python -m repro_torch.launch.train --arch <id>
[--full] [--steps N] [--seq-len S] [--global-batch B] [--ckpt-dir DIR]
[--device cuda|cpu]``.

Runs the reduced (smoke) config of the chosen architecture -- or with
``--full`` the full one -- through the fault-tolerant trainer on the
synthetic pipeline, and prints the reference launcher's last line.  Runs
on CUDA unless given ``--device cpu``.  A checkpoint already in
``--ckpt-dir`` is resumed, as in the reference.
"""

from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.configs.registry import ARCHS, get_config, get_smoke_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm_12b", choices=ARCHS)
    ap.add_argument("--full", action="store_true",
                    help="full config; default: smoke")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--global-batch", type=int, default=4)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch) if args.full else get_smoke_config(args.arch)
    tcfg = TrainerConfig(steps=args.steps, ckpt_every=max(args.steps // 2, 10),
                         log_every=5, ckpt_dir=args.ckpt_dir)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq_len,
                      global_batch=args.global_batch)
    tr = Trainer(cfg, tcfg, dcfg, device=args.device)
    tr.install_preemption_handler()
    out = tr.run()
    print(f"[launch.train] {cfg.name}: done at step {out['step']}, "
          f"final loss {out['history'][-1]['loss']:.4f}, "
          f"stragglers {len(out['straggler_events'])}")


if __name__ == "__main__":
    main()
