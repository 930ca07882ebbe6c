"""Paged forward: the model math of a decode step or a prefill chunk, driven
through the physically paged KV store and the paged-attention kernel.

Attention reads K/V straight out of the
:class:`~repro_torch.runtime.kv_store.PagedKVStore`'s pages through a
per-row block table, and the only per-token write is one page-scatter
launch per layer.  The projections, RoPE, norms and the MLP are plain
PyTorch (the reference leaves them to XLA); the two kernels are the
hand-written CUDA ones behind ``kernels/ops.py``.

Scope: the GQA transformer family -- every layer ``mixer="attn"`` with
``attn_kind="full"`` and a dense MLP (qk_norm / post_norms / softcaps /
partial rotary / tied embeddings honored).
:func:`~repro_torch.models.model.check_paged_support` rejects the rest.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops as kops
from repro_torch.kernels.paged_attention import to_device
from repro_torch.models import layers as L
from repro_torch.models.layers import rms_norm, rope_tables, rotate, torch_dtype
from repro_torch.models.model import check_paged_support
from repro_torch.runtime.kv_store import PagedKVStore

__all__ = ["check_paged_support", "prefill_kv_chunked", "prefill_chunk_step",
           "paged_decode_step", "paged_impl"]


def paged_impl(device) -> str:
    """Kernel implementation for a device: the CUDA kernels on a CUDA
    device, the plain PyTorch versions on the CPU."""
    return kops.resolve_impl(None, device)


def _layer_params(params, gi: int, pi: int, rep: int):
    """One physical layer's weights: views into the stacked group params."""
    def take(t):
        return {k: take(v) for k, v in t.items()} if isinstance(t, dict) \
            else t[rep]
    return take(params["groups"][f"g{gi}"][f"p{pi}"])


def _paged_forward(params, cfg: ArchConfig, store: PagedKVStore,
                   blocks, lens, tokens, *, impl, write_layer) -> torch.Tensor:
    """The transformer loop both paged entry points share: embed the fed
    tokens (one per row), and per layer project -> rope -> hand the new K/V
    to ``write_layer`` (which scatters them into the pages) -> paged
    attention through the padded block table.

    ``blocks``/``lens``/``tokens`` are per-ROW: a decode step has one row
    per request; a prefill chunk has one row per chunk position, all rows
    sharing ONE block list.  Causality is the kernel's length masking: row
    i's K/V is in the pages before any row attends (``write_layer`` runs
    first), and row i attends only to positions < lens[i] + 1.
    """
    dev = store.device
    B = len(blocks)
    dt = torch_dtype(cfg.dtype)
    lens_np = np.asarray(lens, np.int64)
    table, att_lens = store.gather_table(blocks, [n + 1 for n in lens_np])
    positions = to_device(lens_np, dev)                        # (B,)

    toks = to_device(np.asarray(list(tokens), np.int64), dev)
    x = params["embed"][toks].to(dt)                           # (B, D)
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=dt)

    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    scale = (1.0 / math.sqrt(cfg.attn_scale) if cfg.attn_scale
             else 1.0 / math.sqrt(hd))
    # one set of RoPE tables for every layer, q and k alike
    rope = rope_tables(positions, hd, cfg.rope_theta, cfg.rope_pct, dt)

    for li, (gi, pi, rep) in enumerate(store.layer_order):
        lp = _layer_params(params, gi, pi, rep)
        h = rms_norm(x, lp["norm1"], cfg.norm_eps)
        ap = lp["attn"]
        # plain 2-D products on views of the (D, heads, hd) weights:
        # torch.einsum copies a weight it decides to permute
        q = (h @ ap["wq"].to(dt).flatten(1)).view(B, H, hd)
        k = (h @ ap["wk"].to(dt).flatten(1)).view(B, Hkv, hd)
        v = (h @ ap["wv"].to(dt).flatten(1)).view(B, Hkv, hd)
        if cfg.qk_norm:
            q = rms_norm(q, ap["q_scale"], cfg.norm_eps)
            k = rms_norm(k, ap["k_scale"], cfg.norm_eps)
        q, k = rotate(q, rope), rotate(k, rope)

        # physical write: every row's K/V lands in its page BEFORE the
        # attention, so each new position attends to itself (and, in a
        # prefill chunk, to its chunk-mates) -- model dtype end to end
        with store.write_guard():
            write_layer(li, k.contiguous(), v.contiguous())    # (B, Hkv, hd)
            k_pages, v_pages = store.layer_pages(li)
            out = kops.paged_attention(
                q.float().contiguous(), k_pages, v_pages, table, att_lens,
                softcap=cfg.attn_softcap, scale=scale, impl=impl)
        out = out.to(dt)                                       # (B, H, hd)
        o = out.flatten(1) @ ap["wo"].to(dt).flatten(0, 1)
        if cfg.post_norms:
            o = rms_norm(o, lp["post_norm1"], cfg.norm_eps)
        x = x + o

        h = rms_norm(x, lp["norm2"], cfg.norm_eps)
        o = L.mlp_apply(lp["mlp"], h, cfg.act)
        if cfg.post_norms:
            o = rms_norm(o, lp["post_norm2"], cfg.norm_eps)
        x = x + o

    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = params.get("lm_head")
    if head is None:
        head = params["embed"].T
    logits = x @ head.to(dt)
    logits = L.softcap(logits, cfg.logit_softcap)
    if cfg.vocab_padded != cfg.vocab:
        pad = torch.arange(cfg.vocab_padded, device=logits.device) >= cfg.vocab
        logits = logits.masked_fill(pad, -1e30)
    return logits                                              # (B, V)


def paged_decode_step(
    params,
    cfg: ArchConfig,
    store: PagedKVStore,
    blocks: Sequence[Sequence[int]],     # per-request page lists (shared first)
    lens: Sequence[int],                 # tokens already stored per request
    last_tokens: Sequence[int],          # token fed this step, per request
    *,
    impl=None,
) -> torch.Tensor:
    """One batched decode step for a ragged batch of requests: each fed
    token's K/V is appended at page slot ``lens[b]`` (ONE scatter launch
    per layer for the whole batch), then every layer's attention reads the
    pages through the padded block table -- prefix-shared pages in place.
    Returns the ``(B, vocab_padded)`` logits of the new position."""
    page = store.page
    lens_np = np.asarray(lens, np.int64)
    blk = [blocks[b][int(p) // page] for b, p in enumerate(lens_np)]
    slot = [int(p) % page for p in lens_np]

    def write_layer(li, k_b, v_b):                            # (B, Hkv, hd)
        store.append_tokens(blk, slot, k_b, v_b, layer=li)

    return _paged_forward(params, cfg, store, blocks, lens, last_tokens,
                          impl=impl, write_layer=write_layer)


def prefill_chunk_step(
    params,
    cfg: ArchConfig,
    store: PagedKVStore,
    blocks: Sequence[int],               # the ONE request's page list
    tokens: Sequence[int],               # the chunk's prompt tokens
    start: int,                          # sequence position of tokens[0]
    *,
    impl=None,
) -> torch.Tensor:
    """One chunked-prefill forward: the chunk's positions become batch ROWS
    over one shared block table.  Row i carries prompt position
    ``start + i``; its K/V is written (one ``write_prefill`` scatter per
    layer) before any row attends, and the per-row length mask keeps
    attention causal within the chunk while earlier chunks and
    prefix-shared pages are read in place.  Returns the
    ``(chunk, vocab_padded)`` logits."""
    c = len(tokens)
    rows = [list(blocks)] * c
    lens = list(range(start, start + c))

    def write_layer(li, k_c, v_c):                            # (c, Hkv, hd)
        store.write_prefill(blocks, k_c, v_c, start=start, layer=li)

    return _paged_forward(params, cfg, store, rows, lens, tokens,
                          impl=impl, write_layer=write_layer)


def prefill_kv_chunked(
    params,
    cfg: ArchConfig,
    store: PagedKVStore,
    blocks: Sequence[int],
    prompt: Sequence[int],
    chunk: int,
    *,
    start: int = 0,
    impl=None,
):
    """Chunked paged prefill of ``prompt[start:]``: a generator issuing one
    batched forward per ``chunk`` tokens and yielding ``(end, logits)``
    after each, where ``end`` is the number of prompt tokens whose K/V now
    sits in the pages.  The caller runs its safepoint between iterations,
    so a reclaimer ping that lands mid-prefill is serviced within one
    chunk; ``start`` resumes a partial prefill."""
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    pos = start
    n = len(prompt)
    while pos < n:
        toks = list(prompt[pos:pos + chunk])
        logits = prefill_chunk_step(params, cfg, store, blocks, toks, pos,
                                    impl=impl)
        pos += len(toks)
        yield pos, logits
