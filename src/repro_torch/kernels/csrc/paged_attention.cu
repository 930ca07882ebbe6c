// Ragged paged attention for Hopper (sm_90a), bound through a plain C
// interface (kernels/paged_attention.py loads it with ctypes).
//
// Replaces the Pallas TPU kernel paged_attention_pallas
// (src/repro/kernels/paged_attention.py:118, body _paged_kernel at :75):
// for each (row b, kv head h) an online softmax over the pages named by
// table[b], masking positions >= lengths[b], with the G = H / Hkv query
// heads of the kv head sharing every page load; optional logit softcap,
// f32 accumulation, exact zeros for a row with no live position.  Serves
// decode (one row per request) and chunked prefill (one row per chunk
// position, all rows over one table).
//
// What bounds it on the card: the bytes of the live K/V pages it reads
// (2 * live_tokens * D * sizeof(T) per (row, kv head)) against 3.35 TB/s;
// the arithmetic (4 * G * D flops per live token) is far below the f32
// rate.  At decode a row holds a few hundred tokens, so latency and
// occupancy, not bandwidth, separate a kernel from that bound.  The
// design (flash-decoding):
//   * a row's live pages are cut into units of U pages, U = ceil(n_live /
//     64) (one page a unit up to 64 live pages).  A unit's partial softmax
//     (m, l, acc[G, D], f32) is the unit of work: one warp computes it;
//   * the grid is (B, Hkv, n_splits), n_splits chosen on the host from
//     shapes only (kernels/paged_attention.py split_plan); block z takes a
//     contiguous range of units and its 4 warps take every 4th unit of
//     it.  Every block writes its units' partials to a scratch buffer;
//   * the last block of each (row, kv head) to arrive -- an integer atomic
//     counter, which that block resets to 0 for the next launch -- folds
//     the partials in unit order, each unit's weight exp(m_u - m) worked
//     out once per head and several units' loads in flight at once.  The
//     fold order and the units depend only on the row's length, not on
//     the table's width or n_splits, so the result is deterministic and a
//     wider table (more dead entries) gives the same bits.  No float
//     atomics;
//   * a warp walks its pages in slices of 16 positions, loads each slice's
//     K and V rows with 16-byte cp.async into its own double buffer, and
//     keeps the next slice in flight while it scores the current one; no
//     block barrier inside the loop, only __syncwarp;
//   * scores: lane (j, half) dots position j against the G query heads
//     over its half of D (4 heads at a time, q in shared memory as f32),
//     one shuffle joins the halves; the softmax of a head runs on one
//     half-warp (shuffle max and sum over 16 positions); P @ V: a lane
//     owns column pairs of the flattened (G, D) accumulator in registers;
//   * only live pages are read: a -1 entry or a page past ceil(len / page)
//     is never loaded, rows at or past len are zero-filled, not read.
// Not yet: several rows of a chunked prefill sharing one page load;
// tensor cores (the work is far below the card's flop line).
//
// The fused write (the page scatter of paged_scatter_pallas,
// src/repro/kernels/paged_attention.py:176, folded into this launch).  A
// decode step and a prefill chunk write each layer's new K/V rows into the
// pages directly before that layer's attention reads them, and the write
// is a few KB: as a launch of its own it costs its launch, not its bytes.
// With k_new != nullptr the launch takes T new rows (T, Hkv, D) in the
// pages' dtype, their destinations (blk[t], slot[t]), and two values a
// row: new_lo[b], the first position of row b that is a new row, and
// new_base[b], the new row that holds it.  Then:
//   * read: a slice row at position p >= new_lo[b] is loaded by cp.async
//     from new row new_base[b] + p - new_lo[b] (where that lies in [0, T))
//     instead of from the pool: the same bytes the pool would hold after
//     the scatter, in the same order, so scores, fold and output are those
//     of scatter-then-attend, bit for bit;
//   * write: block (b, h, 0) stores head h of new rows b, b + B, ... to
//     pages[blk, slot], in 16-byte vectors, once.  In both callers new row
//     b is row b's own token (decode: new_lo = lens, new_base = b; chunk:
//     new_lo = start, new_base = 0, row i the chunk's position start + i).
//     The caller's contract is that no row reads a written slot from the
//     pool (a decode row's tail slot is its own; chunk rows read positions
//     >= start from the new rows), so nothing in the launch orders a
//     write before a read.
//
// The launch goes on the caller's stream, allocates nothing (scratch and
// counters come from the wrapper) and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kSlice = 16;     // positions a warp scores at once
constexpr int kMaxUnits = 64;  // partials per (row, kv head) at most

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
// 16 bytes global -> shared, bypassing L1; src_bytes = 0 writes zeros
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src,
                                            int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// 16 bytes of a row in shared memory as floats
__device__ __forceinline__ void load16(const float* p, float (&x)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p,
                                       float (&x)[8]) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&w[i]);
    const float2 f = __bfloat1622float2(h);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}
// two neighbouring elements of a row as floats
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// The units of one (row, kv head): U pages each, at most kMaxUnits of them.
struct Units {
  int n_live;  // live pages: ceil(len / page), at most max_pages
  int U;       // pages a unit
  int n;       // units
};
__device__ __forceinline__ Units row_units(int len, int page, int max_pages) {
  Units r;
  r.n_live = len > 0 ? (len + page - 1) / page : 0;
  if (r.n_live > max_pages) r.n_live = max_pages;
  r.U = r.n_live > 0 ? (r.n_live + kMaxUnits - 1) / kMaxUnits : 1;
  r.n = (r.n_live + r.U - 1) / r.U;
  return r;
}

// One position slice a warp scores: slice sl of page pi of unit u.
struct Item {
  int u, pi, sl, pid;
  bool ok;
};

// NP: column pairs of the flattened (G, D) accumulator a lane holds,
// at least ceil(G * D / 64): pair t is element 2 (lane + 32 t), which for
// D = 64 DJ is head t / DJ, columns 64 (t % DJ) + 2 lane.  DJ > 0 (D =
// 128, the models' head dim, DJ = 2): P @ V reads each V pair once for
// all the heads; 0: any D, a V pair read per head.
template <typename T, int NP, int DJ>
__global__ void __launch_bounds__(kThreads) paged_attention_kernel(
    const float* __restrict__ q,          // (B, H, D) f32
    T* k_pages,                           // (P, page, Hkv, D), written at
    T* v_pages,                           //   the new rows' slots
    const int32_t* __restrict__ table,    // (B, max_pages), -1 = dead
    const int32_t* __restrict__ lengths,  // (B,)
    float* __restrict__ out,              // (B, H, D) f32
    float* __restrict__ part,             // (B, Hkv, max_units, 2G + G*D)
    int* __restrict__ counters,           // (B, Hkv), zero between launches
    const T* __restrict__ k_new,          // (T, Hkv, D), or null: no write
    const T* __restrict__ v_new,          // (T, Hkv, D)
    const int32_t* __restrict__ blk,      // (T,) destination page
    const int32_t* __restrict__ slot,     // (T,) destination slot
    const int32_t* __restrict__ new_lo,   // (B,) first new position
    const int32_t* __restrict__ new_base, // (B,) its new row
    int T_new, int H, int Hkv, int D, int P, int page, int max_pages,
    int max_units, float scale, float softcap) {
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int z = blockIdx.z;
  const int n_splits = gridDim.z;
  const int G = H / Hkv;
  const int Gp = (G + 3) & ~3;
  const int GD = G * D;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  constexpr int E = 16 / sizeof(T);  // elements in 16 bytes
  const int C = D / E;               // 16-byte chunks of a row
  const int rs = D + 16 / (int)sizeof(T);  // padded row stride, elements:
                                           // 8 rows of one chunk, 8 banks
  const size_t qoff = ((size_t)b * H + (size_t)h * G) * D;  // heads hG..

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* q_s = reinterpret_cast<float*>(smem_raw);        // (Gp, D)
  T* kv_s = reinterpret_cast<T*>(q_s + Gp * D);           // per warp: 2 x
  const int buf = kSlice * rs;                            // {K, V} slices
  T* my_kv = kv_s + (size_t)warp * 4 * buf;
  float* w_s = reinterpret_cast<float*>(kv_s + (size_t)kWarps * 4 * buf);
  const int per_warp = G * kSlice + 3 * G;
  float* p_s = w_s + warp * per_warp;  // (G, 16) scores, then weights
  float* m_s = p_s + G * kSlice;       // (G,) running max of the unit
  float* l_s = m_s + G;                // (G,) running sum
  float* c_s = l_s + G;                // (G,) this slice's correction
  __shared__ int last_s;

  const int len = lengths[b];
  // positions >= lo come from the new rows, from row nb on (none: lo past
  // every position)
  const int lo = k_new != nullptr ? new_lo[b] : INT_MAX;
  const int nb = k_new != nullptr ? new_base[b] : 0;
  const Units un = row_units(len, page, max_pages);
  const int per_split = (un.n + n_splits - 1) / n_splits;
  const int u_end = min(un.n, (z + 1) * per_split);
  const int n_sl = (page + kSlice - 1) / kSlice;
  const int32_t* trow = table + (size_t)b * max_pages;
  const size_t row_ld = (size_t)Hkv * D;  // elements between page rows
  float* my_part = part + ((size_t)b * Hkv + h) * max_units * (2 * G + GD);

  auto page_of = [&](Item& it) {
    const int pid = trow[it.pi];
    it.pid = (pid >= 0 && pid < P) ? pid : -1;
  };
  auto first_in = [&](int u) {
    Item it;
    it.u = u;
    it.pi = u * un.U;
    it.sl = 0;
    it.ok = u < u_end;
    if (it.ok) page_of(it);
    return it;
  };
  auto advance = [&](Item it) {
    if (++it.sl < n_sl) return it;
    it.sl = 0;
    if (++it.pi < min(un.n_live, (it.u + 1) * un.U)) {
      page_of(it);
      return it;
    }
    return first_in(it.u + kWarps);
  };
  // rows of the slice that hold a live position (else zero-filled)
  auto live_rows = [&](const Item& it) {
    if (it.pid < 0) return 0;
    const int r0 = it.sl * kSlice;
    return max(0, min(kSlice, min(page - r0, len - it.pi * page - r0)));
  };
  auto issue = [&](const Item& it, int stage) {
    const int n = live_rows(it);
    T* ks = my_kv + stage * 2 * buf;
    T* vs = ks + buf;
    const size_t base =
        (((size_t)max(it.pid, 0) * page + it.sl * kSlice) * Hkv + h) * D;
    const int p0 = it.pi * page + it.sl * kSlice;  // row 0's position
    for (int i = lane; i < kSlice * C; i += 32) {
      const int r = i / C;
      const int c = i - r * C;
      const bool ok = r < n;
      const T* ksrc = k_pages;
      const T* vsrc = v_pages;
      size_t off = 0;
      if (ok) {
        const int t = p0 + r >= lo ? nb + (p0 + r - lo) : -1;
        if (t >= 0 && t < T_new) {  // a new row: where the scatter's
          ksrc = k_new;             // bytes come from
          vsrc = v_new;
          off = ((size_t)t * Hkv + h) * D + c * E;
        } else {
          off = base + r * row_ld + c * E;
        }
      }
      cp_async_16(smem_u32(ks + r * rs + c * E), ksrc + off, ok ? 16 : 0);
      cp_async_16(smem_u32(vs + r * rs + c * E), vsrc + off, ok ? 16 : 0);
    }
  };

  float acc[NP][2];
#pragma unroll
  for (int t = 0; t < NP; ++t) acc[t][0] = acc[t][1] = 0.f;

  const int j = lane & 15;   // the position a lane scores
  const int hh = lane >> 4;  // which half of D, which head of a pair
  Item cur = first_in(z * per_split + warp);
  if (cur.ok) issue(cur, 0);
  cp_async_commit();
  // the fused write: head h of new rows b, b + B, ... into the pool, by
  // block (b, h, 0), K and V in 16-byte vectors (no reader of these slots
  // in this launch: see the header)
  if (k_new != nullptr && z == 0) {
    for (int t = b; t < T_new; t += gridDim.x) {
      const size_t src = ((size_t)t * Hkv + h) * D;
      const size_t dst = (((size_t)blk[t] * page + slot[t]) * Hkv + h) * D;
      for (int i = tid; i < 2 * C; i += kThreads) {
        const bool is_v = i >= C;
        const int c = is_v ? i - C : i;
        const T* from = is_v ? v_new : k_new;
        T* to = is_v ? v_pages : k_pages;
        *reinterpret_cast<uint4*>(to + dst + c * E) =
            *reinterpret_cast<const uint4*>(from + src + c * E);
      }
    }
  }
  // the query rows while the first slice is in flight
  for (int i = tid; i < Gp * D; i += kThreads)
    q_s[i] = i < GD ? q[qoff + i] : 0.f;
  for (int g = lane; g < G; g += 32) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }
  __syncthreads();

  int stage = 0;
  while (cur.ok) {
    const Item nxt = advance(cur);
    if (nxt.ok) issue(nxt, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncwarp();

    const T* ks = my_kv + stage * 2 * buf;
    const T* vs = ks + buf;
    const int n = live_rows(cur);
    const bool live = j < n;

    // scores of position j against 4 heads at a time
    for (int g0 = 0; g0 < G; g0 += 4) {
      float s[4] = {0.f, 0.f, 0.f, 0.f};
      for (int c = hh; c < C; c += 2) {
        float kf[E];
        load16(ks + j * rs + c * E, kf);
        const float* qp = q_s + g0 * D + c * E;
#pragma unroll
        for (int gi = 0; gi < 4; ++gi) {
#pragma unroll
          for (int e = 0; e < E; e += 4) {
            const float4 qv =
                *reinterpret_cast<const float4*>(qp + gi * D + e);
            s[gi] = fmaf(qv.x, kf[e], s[gi]);
            s[gi] = fmaf(qv.y, kf[e + 1], s[gi]);
            s[gi] = fmaf(qv.z, kf[e + 2], s[gi]);
            s[gi] = fmaf(qv.w, kf[e + 3], s[gi]);
          }
        }
      }
#pragma unroll
      for (int gi = 0; gi < 4; ++gi) {
        float x = s[gi] + __shfl_xor_sync(0xffffffffu, s[gi], 16);
        x *= scale;
        if (softcap != 0.f) x = softcap * tanhf(x / softcap);
        if (hh == 0 && g0 + gi < G)
          p_s[(g0 + gi) * kSlice + j] = live ? x : kNegInf;
      }
    }
    __syncwarp();

    // online softmax: half-warp hh takes head g0 + hh
    for (int g0 = 0; g0 < G; g0 += 2) {
      const int g = g0 + hh;
      const bool act = g < G;
      const float x = act ? p_s[g * kSlice + j] : kNegInf;
      float mx = x;
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = act ? m_s[g] : kNegInf;
      const float m_new = fmaxf(m_prev, mx);
      // masked positions get weight 0 explicitly, as in the TPU kernel
      const float p = (act && live) ? expf(x - m_new) : 0.f;
      float sum = p;
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      __syncwarp();
      if (act) {
        p_s[g * kSlice + j] = p;
        if (j == 0) {
          const float corr = expf(m_prev - m_new);
          m_s[g] = m_new;
          l_s[g] = l_s[g] * corr + sum;
          c_s[g] = corr;
        }
      }
    }
    __syncwarp();

    // acc = acc * corr + P @ V on the lane's column pairs
    if (DJ > 0) {
      constexpr int GM = DJ > 0 ? NP / DJ : 1;  // heads the registers hold
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        if (g < G) {
          const float corr = c_s[g];
#pragma unroll
          for (int jj = 0; jj < DJ; ++jj) {
            acc[g * DJ + jj][0] *= corr;
            acc[g * DJ + jj][1] *= corr;
          }
        }
      }
#pragma unroll 4
      for (int r = 0; r < kSlice; ++r) {
        float2 vv[DJ > 0 ? DJ : 1];
#pragma unroll
        for (int jj = 0; jj < DJ; ++jj)
          vv[jj] = load2(vs + r * rs + 64 * jj + 2 * lane);
#pragma unroll
        for (int g = 0; g < GM; ++g) {
          if (g < G) {
            const float pr = p_s[g * kSlice + r];
#pragma unroll
            for (int jj = 0; jj < DJ; ++jj) {
              acc[g * DJ + jj][0] = fmaf(pr, vv[jj].x, acc[g * DJ + jj][0]);
              acc[g * DJ + jj][1] = fmaf(pr, vv[jj].y, acc[g * DJ + jj][1]);
            }
          }
        }
      }
    } else {
#pragma unroll
      for (int t = 0; t < NP; ++t) {
        const int i = 2 * (lane + 32 * t);
        if (i < GD) {
          const int g = i / D;
          const int d = i - g * D;
          const float corr = c_s[g];
          float a0 = acc[t][0] * corr, a1 = acc[t][1] * corr;
          const float* pg = p_s + g * kSlice;
#pragma unroll
          for (int r = 0; r < kSlice; ++r) {
            const float pr = pg[r];
            const float2 vv = load2(vs + r * rs + d);
            a0 = fmaf(pr, vv.x, a0);
            a1 = fmaf(pr, vv.y, a1);
          }
          acc[t][0] = a0;
          acc[t][1] = a1;
        }
      }
    }

    // the unit's last slice: write its partial, start the next afresh
    if (!nxt.ok || nxt.u != cur.u) {
      __syncwarp();
      float* pu = my_part + (size_t)cur.u * (2 * G + GD);
      for (int g = lane; g < G; g += 32) {
        pu[g] = m_s[g];
        pu[G + g] = l_s[g];
        m_s[g] = kNegInf;
        l_s[g] = 0.f;
      }
#pragma unroll
      for (int t = 0; t < NP; ++t) {
        const int i = 2 * (lane + 32 * t);
        if (i < GD)
          *reinterpret_cast<float2*>(pu + 2 * G + i) =
              make_float2(acc[t][0], acc[t][1]);
        acc[t][0] = acc[t][1] = 0.f;
      }
    }
    __syncwarp();  // the buffer just read may be refilled next
    cur = nxt;
    stage ^= 1;
  }
  cp_async_wait<0>();

  // the last block of this (row, kv head) folds the partials in unit order
  __threadfence();  // every thread's partials before the block's arrival
  __syncthreads();
  if (tid == 0) {
    int last = 1;
    if (n_splits > 1) {
      int* ctr = counters + (size_t)b * Hkv + h;
      last = atomicAdd(ctr, 1) == n_splits - 1;
      if (last) *ctr = 0;  // ready for the next launch on this stream
    }
    last_s = last;
  }
  __syncthreads();
  if (!last_s) return;
  __threadfence();

  // the fold's scratch (past every warp's): the final max and sum of
  // each head, and each unit's weight exp(m_u - m) per head
  float* mf = w_s + kWarps * per_warp;  // (G,)
  float* lf = mf + G;                   // (G,)
  float* wu = lf + G;                   // (n_units, G)
  const size_t ustep = 2 * G + GD;
  for (int g = tid; g < G; g += kThreads) {
    constexpr int kAhead = 8;  // units whose loads are in flight at once
    float m = kNegInf;
    for (int u0 = 0; u0 < un.n; u0 += kAhead) {
      float mv[kAhead];
#pragma unroll
      for (int k = 0; k < kAhead; ++k)
        mv[k] = u0 + k < un.n ? __ldcg(my_part + (u0 + k) * ustep + g)
                              : kNegInf;
#pragma unroll
      for (int k = 0; k < kAhead; ++k) m = fmaxf(m, mv[k]);
    }
    mf[g] = m;
  }
  __syncthreads();
  for (int i = tid; i < un.n * G; i += kThreads) {
    const int u = i / G;
    const int g = i - u * G;
    wu[i] = expf(__ldcg(my_part + u * ustep + g) - mf[g]);
  }
  __syncthreads();
  for (int g = tid; g < G; g += kThreads) {
    float l = 0.f;
    for (int u = 0; u < un.n; ++u)
      l += __ldcg(my_part + u * ustep + G + g) * wu[u * G + g];
    lf[g] = l;
  }
  // each thread's NE elements, four units' loads in flight for all of them
  constexpr int NE = (NP + 1) / 2;  // ceil(G * D / kThreads) at most
  constexpr int kU = 4;
  float a[NE];
  int ge[NE];
#pragma unroll
  for (int e = 0; e < NE; ++e) {
    const int i = tid + e * kThreads;
    a[e] = 0.f;
    ge[e] = i < GD ? i / D : 0;
  }
  for (int u0 = 0; u0 < un.n; u0 += kU) {
    float x[kU][NE];
#pragma unroll
    for (int uu = 0; uu < kU; ++uu)
#pragma unroll
      for (int e = 0; e < NE; ++e) {
        const int i = tid + e * kThreads;
        x[uu][e] = (u0 + uu < un.n && i < GD)
                       ? __ldcg(my_part + (u0 + uu) * ustep + 2 * G + i)
                       : 0.f;
      }
#pragma unroll
    for (int uu = 0; uu < kU; ++uu)
      if (u0 + uu < un.n)
#pragma unroll
        for (int e = 0; e < NE; ++e)
          a[e] += x[uu][e] * wu[(u0 + uu) * G + ge[e]];
  }
  __syncthreads();
#pragma unroll
  for (int e = 0; e < NE; ++e) {
    const int i = tid + e * kThreads;
    // l == 0 (no live position) gives 0 / 1e-30 = exact zeros
    if (i < GD) out[qoff + i] = a[e] / fmaxf(lf[ge[e]], 1e-30f);
  }
}

template <typename T>
size_t smem_bytes(int G, int D) {
  const size_t Gp = (G + 3) & ~3;
  const size_t rs = D + 16 / sizeof(T);
  return sizeof(float) * Gp * D + sizeof(T) * kWarps * 4 * kSlice * rs +
         sizeof(float) * kWarps * ((size_t)G * kSlice + 3 * G) +
         sizeof(float) * (2 + kMaxUnits) * (size_t)G;
}

// The new rows of a fused write (all null: no write).
struct NewRows {
  const void* k;
  const void* v;
  const void* blk;
  const void* slot;
  const void* lo;
  const void* base;
  int rows;
};

template <typename T, int NP, int DJ>
int launch_np(const void* q, void* k, void* v, const void* table,
              const void* lengths, void* out, void* part, void* counters,
              const NewRows& nr, int B, int H, int Hkv, int D, int P,
              int page, int max_pages, int max_units, int n_splits,
              float scale, float softcap, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(H / Hkv, D);
  if (smem > 48 * 1024) {  // above the default limit only: a host call
    cudaError_t err = cudaFuncSetAttribute(
        paged_attention_kernel<T, NP, DJ>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(B, Hkv, n_splits);
  paged_attention_kernel<T, NP, DJ><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<T*>(k), static_cast<T*>(v),
      static_cast<const int32_t*>(table),
      static_cast<const int32_t*>(lengths), static_cast<float*>(out),
      static_cast<float*>(part), static_cast<int*>(counters),
      static_cast<const T*>(nr.k), static_cast<const T*>(nr.v),
      static_cast<const int32_t*>(nr.blk),
      static_cast<const int32_t*>(nr.slot),
      static_cast<const int32_t*>(nr.lo),
      static_cast<const int32_t*>(nr.base), nr.rows, H, Hkv, D, P, page,
      max_pages, max_units, scale, softcap);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, void* k, void* v, const void* table,
           const void* lengths, void* out, void* part, void* counters,
           const NewRows& nr, int B, int H, int Hkv, int D, int P, int page,
           int max_pages, int max_units, int n_splits, float scale,
           float softcap, cudaStream_t stream) {
  const int np = (H / Hkv * D + 63) / 64;
  const bool d128 = D == 128;
#define PA_LAUNCH(N)                                                          \
  if (np <= N)                                                                \
    return d128 ? launch_np<T, N, 2>(q, k, v, table, lengths, out, part,      \
                                     counters, nr, B, H, Hkv, D, P, page,     \
                                     max_pages, max_units, n_splits, scale,   \
                                     softcap, stream)                         \
                : launch_np<T, N, 0>(q, k, v, table, lengths, out, part,      \
                                     counters, nr, B, H, Hkv, D, P, page,     \
                                     max_pages, max_units, n_splits, scale,   \
                                     softcap, stream);
  PA_LAUNCH(2)
  PA_LAUNCH(4)
  PA_LAUNCH(8)
  PA_LAUNCH(12)
  PA_LAUNCH(18)
  PA_LAUNCH(24)
  PA_LAUNCH(32)
#undef PA_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32 pages, 1 = bfloat16 pages.  q and out are float32.
// part: (B, Hkv, max_units, 2G + G*D) f32 scratch; counters: (B, Hkv)
// int32, all zero (the kernel leaves them zero).  k_new, v_new: (T_new,
// Hkv, D) in the pages' dtype, written at (blk, slot) before they are read
// (see the header), or null for attention alone; blk, slot: (T_new,)
// int32; new_lo, new_base: (B,) int32.
extern "C" int paged_attention_launch(
    int dtype, const void* q, void* k, void* v, const void* table,
    const void* lengths, void* out, void* part, void* counters,
    const void* k_new, const void* v_new, const void* blk, const void* slot,
    const void* new_lo, const void* new_base, int T_new, int B, int H,
    int Hkv, int D, int P, int page, int max_pages, int max_units,
    int n_splits, float scale, float softcap, void* stream) {
  if (B == 0) return 0;
  if ((k_new == nullptr) != (v_new == nullptr) ||
      (k_new != nullptr && (blk == nullptr || slot == nullptr ||
                            new_lo == nullptr || new_base == nullptr)))
    return (int)cudaErrorInvalidValue;
  const NewRows nr{k_new, v_new, blk, slot, new_lo, new_base,
                   k_new != nullptr ? T_new : 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, table, lengths, out, part, counters, nr, B,
                         H, Hkv, D, P, page, max_pages, max_units, n_splits,
                         scale, softcap, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, table, lengths, out, part,
                                 counters, nr, B, H, Hkv, D, P, page,
                                 max_pages, max_units, n_splits, scale,
                                 softcap, s);
  return (int)cudaErrorInvalidValue;
}

// Shared memory one block needs (kernels/paged_attention.py mirrors it).
extern "C" long long paged_attention_smem_bytes(int dtype, int G, int D) {
  return dtype == 0 ? (long long)smem_bytes<float>(G, D)
                    : (long long)smem_bytes<__nv_bfloat16>(G, D);
}
