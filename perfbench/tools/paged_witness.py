"""A second witness for a configuration's served logits: the port's paged
forward through the CUDA kernels and through its plain PyTorch kernels
(``impl="torch"``), on the same weights and tokens, each against the
plain reference in float32.

    python3 perfbench/tools/paged_witness.py --config stablelm-12b --seed 5 \
        [--prompt 700] [--decode 24] [--chunk 256]

Prints, for each path, the largest |logit - reference| over the prompt's
chunk rows and over the decode rows, and how many rows' argmax differ
from the reference's.  Where the CUDA path departs and the plain path
agrees, the fault is in the kernel.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(CHECKOUT / "src"), str(CHECKOUT)]


def run_path(params, cfg, page, prompt, toks, chunk, impl, dev):
    import torch
    from repro_torch.runtime.kv_store import PagedKVStore
    from repro_torch.serve.paged_model import (paged_decode_step,
                                               prefill_kv_chunked)
    n_pages = -(-(len(prompt) + len(toks) + 1) // page)
    store = PagedKVStore(cfg, n_pages + 1, page, storage="device", device=dev)
    blocks = list(range(1, n_pages + 1))
    pre = [lg.float() for _, lg in prefill_kv_chunked(
        params, cfg, store, blocks, prompt, chunk, impl=impl)]
    dec, n, last = [], len(prompt), prompt[-1]
    for t in toks:
        dec.append(paged_decode_step(params, cfg, store, [blocks], [n],
                                     [last], impl=impl).float()[0])
        n, last = n + 1, t
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return torch.cat(pre), torch.stack(dec)


def main() -> int:
    import numpy as np
    import torch
    from perfbench.bench import spec
    from perfbench.bench.cell import port_config
    from perfbench.bench.weights import make_params
    from perfbench.reference.model import Reference

    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--prompt", type=int, default=700)
    ap.add_argument("--decode", type=int, default=24)
    ap.add_argument("--chunk", type=int, default=256)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    c = (spec.load_json(Path(a.config)) if a.config.endswith(".json")
         else spec.config(a.config))
    model, cfg = c["model"], port_config(c)
    dev = torch.device(a.device)
    params = make_params(model, a.seed, dev)
    rng = np.random.default_rng(a.seed)
    prompt = rng.integers(0, model["vocab"], a.prompt).tolist()
    ref = Reference(model, params)
    # the reference's own greedy tokens, fed to both paths alike
    seq = list(prompt) + [prompt[-1]]
    toks = []
    for _ in range(a.decode):
        t = int(ref.logits([seq], [len(seq) - 1])[0][-1].argmax())
        toks.append(t)
        seq.append(t)
    full = ref.logits([seq[:-1]], [0])[0]       # positions 0..n+decode-1
    ref_pre, ref_dec = full[:a.prompt], full[a.prompt:]
    V = model["vocab"]
    for impl in (("cuda", "torch") if dev.type == "cuda" else ("torch",)):
        pre, dec = run_path(params, cfg, c["engine"]["page_size"], prompt,
                            toks, a.chunk, impl, dev)
        pre, dec = pre[:, :V], dec[:, :V]
        print(f"witness {a.config} seed {a.seed} impl={impl}: prompt rows "
              f"max|d| {float((pre - ref_pre).abs().max()):.4f}, argmax "
              f"differs {int((pre.argmax(-1) != ref_pre.argmax(-1)).sum())}"
              f" of {pre.shape[0]}; decode rows max|d| "
              f"{float((dec - ref_dec).abs().max()):.4f}, argmax differs "
              f"{int((dec.argmax(-1) != ref_dec.argmax(-1)).sum())} of "
              f"{dec.shape[0]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
