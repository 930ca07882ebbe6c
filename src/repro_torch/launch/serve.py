"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id>``.

Runs the continuous-batching engine (POP-reclaimed block pool, dense
per-request caches) on the reduced (smoke) config with a synthetic request
stream and prints pool/reclamation stats, as the reference's launcher
does.  Runs on CUDA unless given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import random
import time

import torch

from repro_torch.configs.registry import ARCHS, get_smoke_config
from repro_torch.models.model import init_params
from repro_torch.runtime.block_pool import BlockPool
from repro_torch.serve.engine import ServeEngine


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm_12b", choices=ARCHS)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    cfg = get_smoke_config(args.arch)
    gen = torch.Generator(device=args.device).manual_seed(0)
    params = init_params(cfg, gen, device=args.device)
    pool = BlockPool(256, n_engines=1, reclaim_threshold=8)
    eng = ServeEngine(cfg, params, max_batch=4, page_size=8, max_seq=64,
                      pool=pool, device=args.device)
    eng.start()
    rng = random.Random(0)
    t0 = time.time()
    reqs = [eng.submit([rng.randrange(1, cfg.vocab) for _ in range(4)],
                       max_new=args.max_new) for _ in range(args.requests)]
    done = sum(r.done.wait(timeout=600) for r in reqs)
    eng.stop()
    if eng.error is not None:
        raise SystemExit(f"engine failed: {eng.error!r}")
    s = pool.stats
    print(f"[launch.serve] {cfg.name}: {done}/{len(reqs)} requests in "
          f"{time.time()-t0:.1f}s | pool freed={s.freed} "
          f"epoch_reclaims={s.epoch_reclaims} pings={s.pings} "
          f"no_leaks={pool.check_no_leaks()}")


if __name__ == "__main__":
    main()
