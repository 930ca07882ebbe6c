"""Plain PyTorch versions of the kernels, and the plain operations the
model runs beside them.

They are the arithmetic the CUDA kernels in ``csrc/`` must reproduce: the
CPU path of :mod:`repro_torch.kernels.ops` runs them, the tests hold them
against the reference package's Pallas kernels, and ``chip_smoke.py``
holds each CUDA kernel against them on the card.

* :func:`flash_attention_ref` -- double-chunked online-softmax attention
  (causal, sliding window, logit softcap, GQA): the model's full-sequence
  attention on the CPU and the flash kernel's yardstick.
* :func:`decode_attention_ref` -- single-token attention against a
  (possibly partially filled) KV cache.
* :func:`paged_attention_ref` -- decode attention against a paged block
  pool, through a padded block table (dead entries ``-1``).
  :func:`paged_attention_split_ref` is the paged kernel's own structure
  (per-split partials, a fixed-order fold), a tool of the tests.
* :func:`paged_scatter_ref` -- the token scatter
  ``pages[layer, blk[t], slot[t]] = vals[t]`` into the K and V pools, in
  place, for one layer or all.
* :func:`linear_scan_ref` / :func:`linear_scan_exact` -- chunked gated
  linear recurrences (Mamba2 scalar decay / RWKV6 vector decay): the
  factored form the scan kernel implements, and the exact oracle.
  :func:`linear_scan_chunked_ref` is the same function in the kernel's
  three phases (chunk states, state passing, chunk outputs), a tool of
  the tests.
* :func:`linear_scan_step` -- one recurrent step (decode).

Each follows the function of the same name in the reference package's
``kernels/ref.py`` operation for operation, so the CPU path rounds where
the reference's XLA path does.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def _softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    return cap * torch.tanh(x / cap) if cap else x


def flash_attention_ref(
    q: torch.Tensor,             # (B, Sq, H, D)
    k: torch.Tensor,             # (B, Sk, Hkv, D)
    v: torch.Tensor,             # (B, Sk, Hkv, Dv)
    *,
    causal: bool = True,
    window: int = 0,             # 0 = unlimited; else sliding window size
    softcap: float = 0.0,
    scale: Optional[float] = None,
    q_offset: int = 0,           # absolute position of q[0] (prefill continuation)
    q_block: int = 512,
    kv_block: int = 1024,
) -> torch.Tensor:
    """Blocks of ``q_block`` queries against every block of ``kv_block``
    keys with an online softmax in f32; P is rounded to v's dtype before
    the PV product; masked scores are -1e30 and ``l`` is floored at 1e-30.
    Every kv block is visited, masked or not, as in the reference."""
    B, Sq, H, D = q.shape
    Sk, Hkv, Dv = k.shape[1], k.shape[2], v.shape[3]
    G = H // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    q_block = min(q_block, Sq)
    kv_block = min(kv_block, Sk)
    pad_q = (-Sq) % q_block
    pad_k = (-Sk) % kv_block
    if pad_q:
        q = F.pad(q, (0, 0, 0, 0, 0, pad_q))
    if pad_k:
        k = F.pad(k, (0, 0, 0, 0, 0, pad_k))
        v = F.pad(v, (0, 0, 0, 0, 0, pad_k))
    Sq_p, Sk_p = Sq + pad_q, Sk + pad_k
    nq, nk = Sq_p // q_block, Sk_p // kv_block
    dev = q.device

    qr = q.reshape(B, nq, q_block, Hkv, G, D).float()
    kr = k.reshape(B, nk, kv_block, Hkv, D).float()
    vr = v.reshape(B, nk, kv_block, Hkv, Dv)
    q_pos = torch.arange(Sq_p, device=dev).reshape(nq, q_block) + q_offset
    k_pos = torch.arange(Sk_p, device=dev).reshape(nk, kv_block)

    outs = []
    for qi in range(nq):
        qc, qpos = qr[:, qi], q_pos[qi]
        m = torch.full((B, Hkv, G, q_block), NEG_INF, device=dev)
        l = torch.zeros((B, Hkv, G, q_block), device=dev)
        acc = torch.zeros((B, Hkv, G, q_block, Dv), device=dev)
        for ki in range(nk):
            kc, vc, kpos = kr[:, ki], vr[:, ki], k_pos[ki]
            s = torch.einsum("bqhgd,bkhd->bhgqk", qc, kc) * scale
            s = _softcap(s, softcap)
            mask = (kpos[None, :] <= qpos[:, None]) if causal else (
                kpos[None, :] < Sk).expand(q_block, kv_block)
            if window:
                mask = mask & (kpos[None, :] > qpos[:, None] - window)
            mask = mask & (kpos[None, :] < Sk)      # kv padding
            s = torch.where(mask, s, torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhgqk,bkhd->bhgqd", p.to(vc.dtype).float(), vc.float())
            m = m_new
        out = acc / l.clamp(min=1e-30)[..., None]
        outs.append(out.to(q.dtype))                # (B,Hkv,G,q_block,Dv)
    out = torch.stack(outs).permute(1, 0, 4, 2, 3, 5)
    return out.reshape(B, Sq_p, H, Dv)[:, :Sq]


def decode_attention_ref(
    q: torch.Tensor,             # (B, 1, H, D)
    k_cache: torch.Tensor,       # (B, S, Hkv, D)
    v_cache: torch.Tensor,       # (B, S, Hkv, Dv)
    kv_len: torch.Tensor,        # (B,) number of valid cache positions
    *,
    window: int = 0,
    softcap: float = 0.0,
    scale: Optional[float] = None,
) -> torch.Tensor:
    B, _, H, D = q.shape
    S, Hkv, Dv = k_cache.shape[1], k_cache.shape[2], v_cache.shape[3]
    G = H // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qr = q.reshape(B, Hkv, G, D).float()
    s = torch.einsum("bhgd,bshd->bhgs", qr, k_cache.float()) * scale
    s = _softcap(s, softcap)
    pos = torch.arange(S, device=q.device)[None]          # (1, S)
    kv_len = kv_len.to(q.device)
    mask = pos < kv_len[:, None]
    if window:
        mask = mask & (pos > kv_len[:, None] - 1 - window)
    s = torch.where(mask[:, None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(B, 1, H, Dv).to(q.dtype)


def paged_attention_ref(
    q: torch.Tensor,             # (B, H, D)
    k_pages: torch.Tensor,       # (P, page, Hkv, D)  -- the shared block pool
    v_pages: torch.Tensor,       # (P, page, Hkv, Dv)
    block_table: torch.Tensor,   # (B, max_pages) int32 page ids (-1 pad)
    lengths: torch.Tensor,       # (B,) valid tokens per sequence
    *,
    softcap: float = 0.0,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Gather every table entry's page and attend over the positions that
    are below ``lengths[b]`` AND in a live (``>= 0``) table entry -- what
    the CUDA kernel reads.  Masked positions get weight exactly 0, so a row
    with no live position comes back as exact zeros, as the kernels' do.
    f32 throughout; the result in ``q.dtype``.  (:func:`build_block_table`
    puts -1 only past a row's live pages; a -1 inside them, which the TPU
    kernel would read as page 0, is masked here.)"""
    B, H, D = q.shape
    P, page, Hkv, _ = k_pages.shape
    Dv = v_pages.shape[-1]
    G = H // Hkv
    max_pages = block_table.shape[1]
    S = max_pages * page
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    table = block_table.long().to(k_pages.device)
    safe = table.clamp(min=0)
    k = k_pages[safe].reshape(B, S, Hkv, D).float()
    v = v_pages[safe].reshape(B, S, Hkv, Dv).float()
    s = torch.einsum("bhgd,bshd->bhgs", q.reshape(B, Hkv, G, D).float(),
                     k) * scale
    s = _softcap(s, softcap)
    pos = torch.arange(S, device=k.device)[None]
    valid = ((pos < lengths.to(k.device).long()[:, None])
             & (table >= 0).repeat_interleave(page, dim=1))[:, None, None]
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhgs,bshd->bhgd", p, v) / l.clamp(min=1e-30)
    return out.reshape(B, H, Dv).to(q.dtype)


PAGED_MAX_UNITS = 64   # partials per (row, kv head) of the paged kernel


def paged_row_units(n_live: int) -> Tuple[int, int]:
    """``(U, n_units)``: how the paged kernel cuts a row of ``n_live`` live
    pages into units of ``U`` pages, at most ``PAGED_MAX_UNITS`` of them
    (``csrc/paged_attention.cu`` ``row_units``)."""
    U = -(-n_live // PAGED_MAX_UNITS) if n_live > 0 else 1
    return U, -(-n_live // U)


def paged_attention_split_ref(
    q: torch.Tensor,             # (B, H, D)
    k_pages: torch.Tensor,       # (P, page, Hkv, D)
    v_pages: torch.Tensor,       # (P, page, Hkv, D)
    block_table: torch.Tensor,   # (B, max_pages) int32 page ids (-1 pad)
    lengths: torch.Tensor,       # (B,) valid tokens per sequence
    *,
    softcap: float = 0.0,
    scale: Optional[float] = None,
    pages_per_split: Optional[int] = None,
) -> torch.Tensor:
    """What the paged kernel computes, step for step in its structure: each
    row's live pages cut into splits of ``pages_per_split`` pages (None:
    the kernel's own rule, :func:`paged_row_units`), one partial softmax
    ``(m, l, acc)`` per split in f32 (masked positions -1e30 and weight
    exactly 0; a split with no live position m = -1e30, l = 0, acc = 0),
    then the partials folded in split order: m = max m_s, l = sum l_s
    exp(m_s - m), acc = sum acc_s exp(m_s - m), out = acc / max(l, 1e-30).
    A test tool: reads the lengths to the host, so nothing on the main
    path calls it."""
    B, H, D = q.shape
    P, page, Hkv, _ = k_pages.shape
    G = H // Hkv
    max_pages = block_table.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    table = block_table.long().cpu()
    lens = lengths.long().cpu()
    out = torch.zeros((B, Hkv, G, D), dtype=torch.float32, device=q.device)
    for b in range(B):
        n = int(lens[b])
        n_live = min(-(-n // page), max_pages) if n > 0 else 0
        U = pages_per_split or paged_row_units(n_live)[0]
        qb = q[b].reshape(Hkv, G, D).float()
        m = torch.full((Hkv, G), NEG_INF, device=q.device)
        l = torch.zeros((Hkv, G), device=q.device)
        acc = torch.zeros((Hkv, G, D), device=q.device)
        parts = []
        for p0 in range(0, n_live, U):
            pids = table[b, p0:min(p0 + U, n_live)]
            pos = (torch.arange(p0, p0 + len(pids))[:, None] * page
                   + torch.arange(page)[None]).reshape(-1)
            valid = ((pos < n) & (pids >= 0).repeat_interleave(page)
                     ).to(q.device)
            safe = pids.clamp(min=0).to(k_pages.device)
            k = k_pages[safe].reshape(-1, Hkv, D).float()
            v = v_pages[safe].reshape(-1, Hkv, D).float()
            s = _softcap(torch.einsum("hgd,shd->hgs", qb, k) * scale,
                         softcap)
            s = torch.where(valid, s, torch.full_like(s, NEG_INF))
            m_s = s.amax(dim=-1)
            p = torch.where(valid, torch.exp(s - m_s[..., None]),
                            torch.zeros_like(s))
            parts.append((m_s, p.sum(dim=-1), torch.einsum("hgs,shd->hgd", p,
                                                           v)))
        if parts:
            m = torch.stack([pm for pm, _, _ in parts]).amax(dim=0)
        for m_s, l_s, a_s in parts:          # the fold, in split order
            w = torch.exp(m_s - m)
            l = l + l_s * w
            acc = acc + a_s * w[..., None]
        out[b] = acc / l.clamp(min=1e-30)[..., None]
    return out.reshape(B, H, D).to(q.dtype)


def paged_scatter_ref(
    k_pages: torch.Tensor,       # (L, P, page, Hkv, D), written in place
    v_pages: torch.Tensor,
    block_idx: torch.Tensor,     # (T,) destination page per token
    slot_idx: torch.Tensor,      # (T,) destination slot per token
    k_vals: torch.Tensor,        # (T, Hkv, D) with a layer, else (L, T, ...)
    v_vals: torch.Tensor,
    *,
    layer: Optional[int] = None,
) -> None:
    """``pages[layer, blk[t], slot[t]] = vals[t]`` for K and V, for one
    layer or (``layer=None``) every layer, values cast to the pages'
    dtype -- the scatter kernel's function, by ``index_put_``."""
    blk = block_idx.long().to(k_pages.device)
    slot = slot_idx.long().to(k_pages.device)
    for pages, vals in ((k_pages, k_vals), (v_pages, v_vals)):
        vals = vals.to(device=pages.device, dtype=pages.dtype)
        if layer is None:
            pages[:, blk, slot] = vals
        else:
            pages[layer, blk, slot] = vals


# ----------------------------------------------------------------------------
# gated linear recurrences (Mamba2 / RWKV6)
# ----------------------------------------------------------------------------


def linear_scan_step(
    q: torch.Tensor,             # (B, H, K)
    k: torch.Tensor,             # (B, H, K)
    v: torch.Tensor,             # (B, H, Vd)
    log_decay: torch.Tensor,     # (B, H) or (B, H, K)
    state: torch.Tensor,         # (B, H, K, Vd)
    bonus: Optional[torch.Tensor] = None,   # (H, K) rwkv6 'u'
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single recurrent step (decode).  The output reads the state rounded
    to q's dtype, as in the reference."""
    a = torch.exp(log_decay.float())
    if a.dim() == 2:
        a = a[..., None]
    kv = k[..., :, None] * v[..., None, :]           # (B,H,K,Vd)
    if bonus is not None:
        cur = state + bonus[None, :, :, None] * kv
        out = torch.einsum("bhk,bhkv->bhv", q, cur.to(q.dtype))
        new_state = a[..., None] * state + kv
    else:
        new_state = a[..., None] * state + kv
        out = torch.einsum("bhk,bhkv->bhv", q, new_state.to(q.dtype))
    return out, new_state


def _scan_chunks(q, k, v, log_decay, state, chunk):
    """The padded, chunked f32 views both scans share: ``(n, B, L, H, *)``
    stacks of q, k, v and the log decay (``Kd`` = 1 for scalar decay)."""
    B, S, H, K = q.shape
    Vd = v.shape[-1]
    ld = log_decay.float()
    if ld.dim() == 3:
        ld = ld[..., None]
    pad = (-S) % chunk
    if pad:
        q, k, v, ld = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v, ld))
    n = (S + pad) // chunk

    def chunks(t):
        return t.reshape(B, n, chunk, H, t.shape[-1]).float().transpose(0, 1)

    if state is None:
        state = torch.zeros((B, H, K, Vd), device=q.device)
    return chunks(q), chunks(k), chunks(v), chunks(ld), state, n


def linear_scan_exact(q, k, v, log_decay, *, state=None, bonus=None,
                      chunk: int = 32):
    """Exact chunked scan; vector decay handled with an (L, L, K) broadcast.

    The numerical oracle for both the model path and the kernel.
    q,k: (B,S,H,K); v: (B,S,H,Vd); log_decay: (B,S,H) or (B,S,H,K).

    Semantics:
      mamba2 (bonus=None):  S_t = a_t S_{t-1} + k_t v_t ; o_t = q_t . S_t
      rwkv6  (bonus=u):     S_t = w_t S_{t-1} + k_t v_t ; o_t = q_t . (S_{t-1} + u k_t v_t)
    Returns (out (B,S,H,Vd), final_state (B,H,K,Vd)).
    """
    B, S, H, K = q.shape
    Vd = v.shape[-1]
    vec = log_decay.dim() == 4
    qs, ks, vs, lds, st, n = _scan_chunks(q, k, v, log_decay, state, chunk)
    idx = torch.arange(chunk, device=q.device)
    strict_lower = idx[:, None] > idx[None, :]
    eye = torch.eye(chunk, device=q.device)
    rwkv = bonus is not None
    ys = []
    for c in range(n):
        qc, kc, vc, ldc = qs[c], ks[c], vs[c], lds[c]   # (B,L,H,*)
        cl = torch.cumsum(ldc, dim=1)                   # inclusive
        clq = cl - ldc if rwkv else cl                  # q-side: exclusive for rwkv
        dd = clq[:, :, None] - cl[:, None, :]           # (B,L,L,H,Kd)
        wmask = strict_lower[None, :, :, None, None]
        w = torch.exp(torch.where(wmask, dd, torch.zeros_like(dd))) * wmask
        if w.shape[-1] == 1:                            # scalar decay
            qk = torch.einsum("blhk,bmhk->bhlm", qc, kc)
            scores = qk * w[..., 0].permute(0, 3, 1, 2)
        else:
            scores = torch.einsum("blhk,bmhk,blmhk->bhlm", qc, kc, w)
        if rwkv:
            dsc = torch.einsum("blhk,blhk,hk->bhl", qc, kc, bonus.float())
        else:
            dsc = torch.einsum("blhk,blhk->bhl", qc, kc)
        scores = scores + dsc[:, :, :, None] * eye[None, None]
        y_intra = torch.einsum("bhlm,bmhv->blhv", scores, vc)
        q_eff = qc * torch.exp(clq).expand(qc.shape)
        y_inter = torch.einsum("blhk,bhkv->blhv", q_eff, st)
        total = torch.exp(cl[:, -1])                    # (B,H,Kd)
        rem = torch.exp(cl[:, -1:] - cl)                # decay j -> chunk end
        k_rem = kc * rem.expand(kc.shape)
        if vec:
            st_new = st * total[..., None]
        else:
            st_new = st * total[..., 0][:, :, None, None]
        st = st_new + torch.einsum("blhk,blhv->bhkv", k_rem, vc)
        ys.append(y_intra + y_inter)
    out = torch.stack(ys, 1).reshape(B, n * chunk, H, Vd)[:, :S]
    return out.to(v.dtype), st


def linear_scan_ref(q, k, v, log_decay, *, state=None, bonus=None,
                    chunk: int = 128, clamp: float = 75.0):
    """Factored chunked scan (what the kernel implements).

    Scalar decay (mamba2): mathematically exact.  Vector decay (rwkv6):
    factored form ``(q*exp(clq)) . (k*exp(-cl))`` with amplification clamped
    at ``exp(clamp)`` -- matches the exact oracle to ~1e-3 for realistic
    decays.
    """
    B, S, H, K = q.shape
    Vd = v.shape[-1]
    vec = log_decay.dim() == 4
    qs, ks, vs, lds, st, n = _scan_chunks(q, k, v, log_decay, state, chunk)
    idx = torch.arange(chunk, device=q.device)
    strict_lower = (idx[:, None] > idx[None, :]).float()
    eye = torch.eye(chunk, device=q.device)
    rwkv = bonus is not None
    ys = []
    for c in range(n):
        qc, kc, vc, ldc = qs[c], ks[c], vs[c], lds[c]
        cl = torch.cumsum(ldc, dim=1)
        clq = cl - ldc if rwkv else cl
        q_eff = qc * torch.exp(clq).expand(qc.shape)
        k_eff = kc * torch.exp(torch.clamp(-cl, max=clamp)).expand(kc.shape)
        scores = torch.einsum("blhk,bmhk->bhlm", q_eff, k_eff)
        scores = scores * strict_lower[None, None]
        if rwkv:
            dsc = torch.einsum("blhk,blhk,hk->bhl", qc, kc, bonus.float())
        else:
            dsc = torch.einsum("blhk,blhk->bhl", qc, kc)
        scores = scores + dsc[:, :, :, None] * eye[None, None]
        y = torch.einsum("bhlm,bmhv->blhv", scores, vc)
        y = y + torch.einsum("blhk,bhkv->blhv", q_eff, st)
        total = torch.exp(cl[:, -1])
        rem = torch.exp(cl[:, -1:] - cl)
        k_rem = kc * rem.expand(kc.shape)
        if vec:
            st_new = st * total[..., None]
        else:
            st_new = st * total[..., 0][:, :, None, None]
        st = st_new + torch.einsum("blhk,blhv->bhkv", k_rem, vc)
        ys.append(y)
    out = torch.stack(ys, 1).reshape(B, n * chunk, H, Vd)[:, :S]
    return out.to(v.dtype), st


def linear_scan_chunked_ref(q, k, v, log_decay, *, bonus=None,
                            chunk: int = 128, clamp: float = 75.0):
    """:func:`linear_scan_ref`'s function in the scan kernel's three
    phases, every chunk at once where the kernel runs them in parallel:

    1. per chunk: ``cl`` = cumsum of the log decay, the total decay
       ``exp(cl_end)`` and the state contribution ``dS = k_rem^T v``;
    2. the state passed along the chunks, ``S_c = S_{c-1} exp(cl_end_c) +
       dS_c``, keeping each chunk's incoming state;
    3. per chunk: ``y = (strictly-lower q_eff k_eff^T + diag) v + q_eff
       S_in``.

    A test tool (the kernel's structure on the CPU); the model calls the
    scan through :mod:`repro_torch.kernels.ops`."""
    B, S, H, K = q.shape
    Vd = v.shape[-1]
    vec = log_decay.dim() == 4
    qs, ks, vs, lds, _, n = _scan_chunks(q, k, v, log_decay, None, chunk)
    # (n, B, L, H, *) -> every chunk at once
    cl = torch.cumsum(lds, dim=2)
    clq = cl - lds if bonus is not None else cl
    # phase 1
    total = torch.exp(cl[:, :, -1])                        # (n, B, H, Kd)
    k_rem = ks * torch.exp(cl[:, :, -1:] - cl).expand(ks.shape)
    ds = torch.einsum("nblhk,nblhv->nbhkv", k_rem, vs)
    # phase 2
    st = torch.zeros((B, H, K, Vd), device=q.device)
    s_in = []
    for c in range(n):
        s_in.append(st)
        decay = total[c][..., None] if vec else total[c][..., 0][..., None,
                                                                   None]
        st = st * decay + ds[c]
    s_in = torch.stack(s_in)                               # (n, B, H, K, Vd)
    # phase 3
    q_eff = qs * torch.exp(clq).expand(qs.shape)
    k_eff = ks * torch.exp(torch.clamp(-cl, max=clamp)).expand(ks.shape)
    idx = torch.arange(chunk, device=q.device)
    lower = (idx[:, None] > idx[None, :]).float()
    scores = torch.einsum("nblhk,nbmhk->nbhlm", q_eff, k_eff) * lower
    u = bonus.float() if bonus is not None else torch.ones(
        (H, K), device=q.device)
    diag = torch.einsum("nblhk,nblhk,hk->nbhl", qs, ks, u)
    scores = scores + torch.diag_embed(diag)
    y = torch.einsum("nbhlm,nbmhv->nblhv", scores, vs)
    y = y + torch.einsum("nblhk,nbhkv->nblhv", q_eff, s_in)
    out = y.permute(1, 0, 2, 3, 4).reshape(B, n * chunk, H, Vd)[:, :S]
    return out.to(v.dtype), st
