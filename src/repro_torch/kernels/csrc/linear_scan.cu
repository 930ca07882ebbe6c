// Chunked gated linear recurrence (Mamba2 / RWKV6) for Hopper (sm_90a),
// bound through a plain C interface (kernels/linear_scan.py loads it with
// ctypes).
//
// Replaces the Pallas TPU kernel linear_scan_pallas
// (src/repro/kernels/linear_scan.py:81, body _scan_kernel at :29): the
// recurrence S_t = a_t S_{t-1} + k_t v_t^T, o_t = q_t . S_t (Mamba2,
// scalar decay per head) or o_t = q_t . (S_{t-1} + u k_t v_t^T) (RWKV6,
// per-K vector decay and bonus u), in the chunked SSD form the reference
// computes (kernels/ref.py linear_scan_ref): per chunk of L steps
//   cl   = inclusive cumsum of the log decay (per K column for a vector),
//   clq  = cl - ld with a bonus, else cl,
//   q_eff = q exp(clq),  k_eff = k exp(min(-cl, 75)),
//   y    = (strictly-lower q_eff k_eff^T + diag(q.k.u)) v + q_eff S,
//   S    = S exp(cl_end) + (k exp(cl_end - cl))^T v,
// from a zero state, the (K, Vd) state carried in f32 across chunks.
//
// What bounds it on the card: per chunk of L steps and (batch, head) it
// does ~L^2 K / 2 + L^2 Vd / 2 + 2 L K Vd multiply-adds on 2 L (K + Vd)
// inputs.  The TPU kernel walks the chunks in order with the state in
// VMEM; on the card that leaves B * H blocks.  The recurrence is
// sequential only through the (K, Vd) state, and the chunk-local work --
// most of the flops -- is independent across chunks, so the design splits
// it in three launches (the SSD split of Mamba2's own GPU kernels):
//   1. scan_state_*, one block per (batch, head, chunk): the chunk's decay
//      cumsum, its total decay exp(cl_end) and its state contribution
//      dS_c = k_rem^T v, f32, to a (B, H, n_chunks, K, Vd) scratch;
//   2. scan_state_pass, parallel over (batch, head, K, Vd) and sequential
//      over the chunks: S_c = S_{c-1} exp(cl_end_c) + dS_c, writing each
//      chunk's incoming state over its dS_c, and the final state;
//   3. scan_out_*, one block per (batch, head, chunk): y = the masked
//      scores . v + the diagonal term + q_eff . S_in.
// Blocks of one (batch, chunk) and neighbouring heads are adjacent in the
// grid, so Mamba2's B and C (read through stride-0 views over the heads,
// never copied) come from L2 after the first head.
//
// bfloat16 with K, Vd, L multiples of 16 and L, K, Vd <= 128 (both main
// paths): phases 1 and 3 run their four products on the tensor cores,
// mma.sync.m16n8k16 (bf16 in, f32 accumulate), one warp per 16 rows:
//   * scalar decay: the decay factors out of the K-dot, so the raw bf16 q
//     and k go to the tensor cores unchanged, and exp(clq_r + min(-cl_c,
//     clamp)) is applied in f32 to the score registers -- the reference's
//     function, clamp included, with no e^75-scaled bf16 operand; q . S
//     likewise, scaled by exp(clq_r) after the product;
//   * vector decay: q_eff and k_eff are formed in f32, as operands of the
//     same products;
//   * the (L, L) scores stay in registers and go to the scores . v product
//     as bf16 A fragments, as in flash_attention.cu;
//   * an f32 operand -- the scores, the incoming state, k_rem, q_eff and
//     k_eff -- goes in as bf16 hi + lo (hi = bf16(x), lo = bf16(x - hi),
//     ~16 bits), two products where one bf16 rounding would put ~2^-9 of
//     every term into the outputs (more than the bf16 tolerance allows
//     where an output is near 0); q, k and v are bf16 already and exact.
// float32, and bf16 at other shapes: the same three phases on the CUDA
// cores in f32 (TF32 would not hold the f32 path's 2e-4).
// Not yet: wgmma, TMA loads, phase 2 folded into phase 3.
//
// The launches go on the caller's stream, allocate nothing (the scratch
// comes from the wrapper) and return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;       // CUDA-core phases
constexpr int kPassThreads = 256;   // phase 2

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

struct Strides {  // elements, for (batch, time, head); the last dim is dense
  long long b, t, h;
};

// The (batch, head, chunk) of a phase-1/3 block: heads fastest, so the
// blocks of one (batch, chunk) are adjacent.
struct Chunk {
  int b, h, c, t0;
};
__device__ __forceinline__ Chunk chunk_of(int H, int n, int L) {
  Chunk r;
  r.h = blockIdx.x % H;
  const int bc = blockIdx.x / H;
  r.c = bc % n;
  r.b = bc / n;
  r.t0 = r.c * L;
  return r;
}

// The chunk's log decay (L, Kd) into cl_s, every thread's loads in flight
// at once; rows past S are zeros (no decay).
__device__ __forceinline__ void load_decay(const float* lb, long long st,
                                           int t0, int S, int L, int Kd,
                                           float* cl_s) {
  constexpr int kBatch = 4;  // loads a thread has in flight
  const int n = L * Kd;
  for (int i0 = threadIdx.x; i0 < n; i0 += kBatch * blockDim.x) {
    float x[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int i = i0 + b * blockDim.x;
      const int r = i / Kd;
      x[b] = (i < n && t0 + r < S)
                 ? lb[(long long)(t0 + r) * st + (i - r * Kd)]
                 : 0.f;
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int i = i0 + b * blockDim.x;
      if (i < n) cl_s[i] = x[b];
    }
  }
}

// In place, after load_decay and a barrier: the inclusive prefix sum down
// each column of cl_s (L, Kd), a thread per column in row order -- the
// reference's order of additions, which the f32 path's 2e-4 needs (a
// shuffle scan's other order moves cl by ~1e-5 at L = 128, and the
// outputs of a few units with it); with clq_s also clq = cl - ld.
__device__ __forceinline__ void cumsum_columns(int L, int Kd, float* cl_s,
                                               float* clq_s) {
  constexpr int kBatch = 16;  // rows read before their dependent adds
  for (int kd = threadIdx.x; kd < Kd; kd += blockDim.x) {
    float acc = 0.f;
    for (int r0 = 0; r0 < L; r0 += kBatch) {
      float x[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b)
        x[b] = r0 + b < L ? cl_s[(r0 + b) * Kd + kd] : 0.f;
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        if (r0 + b < L) {
          acc += x[b];
          cl_s[(r0 + b) * Kd + kd] = acc;
          if (clq_s != nullptr) clq_s[(r0 + b) * Kd + kd] = acc - x[b];
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// phase 2: the state passed from chunk to chunk
// ---------------------------------------------------------------------------

// W elements a thread (4: Vd % 4 == 0, so the 4 share a decay column),
// eight chunks' loads in flight before their dependent updates
template <int W>
__global__ void __launch_bounds__(kPassThreads) scan_state_pass(
    float* __restrict__ ds,         // (B*H, n, K*Vd): dS_c in, S_in out
    const float* __restrict__ tot,  // (B*H, n, Kd): exp(cl_end)
    float* __restrict__ state,      // (B*H, K*Vd)
    int n, int KV, int Vd, int Kd) {
  typedef typename std::conditional<W == 4, float4, float>::type Vec;
  const int bh = blockIdx.y;
  const int e = (blockIdx.x * kPassThreads + threadIdx.x) * W;
  if (e >= KV) return;
  const int kd = Kd == 1 ? 0 : e / Vd;
  Vec* d = reinterpret_cast<Vec*>(ds + (size_t)bh * n * KV + e);
  const size_t dstep = KV / W;
  const float* a = tot + (size_t)bh * n * Kd + kd;
  float sv[W];
#pragma unroll
  for (int w = 0; w < W; ++w) sv[w] = 0.f;
  constexpr int kAhead = 8;
  for (int c0 = 0; c0 < n; c0 += kAhead) {
    Vec x[kAhead];
    float f[kAhead];
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      if (c0 + i < n) {
        x[i] = d[(c0 + i) * dstep];
        f[i] = a[(size_t)(c0 + i) * Kd];
      }
    }
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      if (c0 + i < n) {
        const float* xi = reinterpret_cast<const float*>(&x[i]);
        Vec out;
        float* o = reinterpret_cast<float*>(&out);
#pragma unroll
        for (int w = 0; w < W; ++w) {
          o[w] = sv[w];
          sv[w] = sv[w] * f[i] + xi[w];
        }
        d[(c0 + i) * dstep] = out;
      }
    }
  }
  float* so = state + (size_t)bh * KV + e;
#pragma unroll
  for (int w = 0; w < W; ++w) so[w] = sv[w];
}

// phase 2 over every (batch, head) and element of the state
cudaError_t launch_pass(float* ds, const float* tot, float* state, int BH,
                        int n, int K, int Vd, int Kd, cudaStream_t stream) {
  const int KV = K * Vd;
  if (Vd % 4 == 0) {
    const int threads = KV / 4;
    scan_state_pass<4><<<dim3((threads + kPassThreads - 1) / kPassThreads, BH),
                         kPassThreads, 0, stream>>>(ds, tot, state, n, KV, Vd,
                                                    Kd);
  } else {
    scan_state_pass<1><<<dim3((KV + kPassThreads - 1) / kPassThreads, BH),
                         kPassThreads, 0, stream>>>(ds, tot, state, n, KV, Vd,
                                                    Kd);
  }
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// phases 1 and 3 on the CUDA cores (float32; bf16 at other shapes)
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads) scan_state_f32(
    const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ ld, float* __restrict__ ds,
    float* __restrict__ tot, int S, int H, int n, int K, int Vd, int Kd,
    int L, Strides sk, Strides sv, Strides sl) {
  const Chunk ch = chunk_of(H, n, L);
  const int tid = threadIdx.x;
  const int Kp = K | 1;  // odd stride: one column of 32 rows in 32 banks
  extern __shared__ float smem[];
  float* k_s = smem;             // (L, Kp) k, then k_rem
  float* v_s = k_s + L * Kp;     // (L, Vd)
  float* cl_s = v_s + L * Vd;    // (L, Kd)
  const T* kb = k + ch.b * sk.b + ch.h * sk.h;
  const T* vb = v + ch.b * sv.b + ch.h * sv.h;
  const float* lb = ld + ch.b * sl.b + ch.h * sl.h;

  for (int i = tid; i < L * K; i += kThreads) {
    const int j = i / K;
    const int kk = i - j * K;
    const int t = ch.t0 + j;
    k_s[j * Kp + kk] = t < S ? to_f32(kb[t * sk.t + kk]) : 0.f;
  }
  for (int i = tid; i < L * Vd; i += kThreads) {
    const int j = i / Vd;
    const int t = ch.t0 + j;
    v_s[i] = t < S ? to_f32(vb[t * sv.t + (i - j * Vd)]) : 0.f;
  }
  load_decay(lb, sl.t, ch.t0, S, L, Kd, cl_s);
  __syncthreads();
  cumsum_columns(L, Kd, cl_s, nullptr);
  __syncthreads();

  const float* cl_end = cl_s + (L - 1) * Kd;
  for (int i = tid; i < L * K; i += kThreads) {
    const int j = i / K;
    const int kk = i - j * K;
    const int kd = Kd == 1 ? 0 : kk;
    k_s[j * Kp + kk] *= expf(cl_end[kd] - cl_s[j * Kd + kd]);
  }
  const size_t bhc = ((size_t)ch.b * H + ch.h) * n + ch.c;
  for (int i = tid; i < Kd; i += kThreads) tot[bhc * Kd + i] = expf(cl_end[i]);
  __syncthreads();

  float* dsb = ds + bhc * K * Vd;
  for (int i = tid; i < K * Vd; i += kThreads) {
    const int kk = i / Vd;
    const int dv = i - kk * Vd;
    float x = 0.f;
    for (int j = 0; j < L; ++j) x = fmaf(k_s[j * Kp + kk], v_s[j * Vd + dv], x);
    dsb[i] = x;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) scan_out_f32(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const float* __restrict__ ld,
    const float* __restrict__ bonus,  // (H, K) or null
    const float* __restrict__ s_in,   // (B, H, n, K, Vd)
    T* __restrict__ out,              // (B, S, H, Vd)
    int S, int H, int n, int K, int Vd, int Kd, int L, float clamp,
    Strides sq, Strides sk, Strides sv, Strides sl) {
  const Chunk ch = chunk_of(H, n, L);
  const int tid = threadIdx.x;
  const int Kp = K | 1;
  const bool has_bonus = bonus != nullptr;

  extern __shared__ float smem[];
  float* q_s = smem;              // (L, Kp) q, then q_eff
  float* k_s = q_s + L * Kp;      // (L, Kp) k, then k_eff
  float* v_s = k_s + L * Kp;      // (L, Vd)
  float* cl_s = v_s + L * Vd;     // (L, Kd) cumsum of the log decay
  float* clq_s = cl_s + L * Kd;   // (L, Kd) with a bonus: cl - ld
  float* sc_s = has_bonus ? clq_s + L * Kd : clq_s;  // (L, L) scores
  if (!has_bonus) clq_s = cl_s;
  float* dg_s = sc_s + L * L;     // (L,)    the diagonal q.k.u
  float* st_s = dg_s + L;         // (K, Vd) the incoming state
  float* u_s = st_s + K * Vd;     // (K,)    the bonus (ones without)

  const T* qb = q + ch.b * sq.b + ch.h * sq.h;
  const T* kb = k + ch.b * sk.b + ch.h * sk.h;
  const T* vb = v + ch.b * sv.b + ch.h * sv.h;
  const float* lb = ld + ch.b * sl.b + ch.h * sl.h;
  T* ob = out + ((size_t)ch.b * S * H + ch.h) * Vd;  // time stride H * Vd
  const float* sb = s_in + (((size_t)ch.b * H + ch.h) * n + ch.c) * K * Vd;

  for (int i = tid; i < K * Vd; i += kThreads) st_s[i] = sb[i];
  for (int i = tid; i < K; i += kThreads)
    u_s[i] = has_bonus ? bonus[(size_t)ch.h * K + i] : 1.f;
  // steps past S are zeros (no decay, no input)
  for (int i = tid; i < L * K; i += kThreads) {
    const int j = i / K;
    const int kk = i - j * K;
    const int t = ch.t0 + j;
    const bool live = t < S;
    q_s[j * Kp + kk] = live ? to_f32(qb[t * sq.t + kk]) : 0.f;
    k_s[j * Kp + kk] = live ? to_f32(kb[t * sk.t + kk]) : 0.f;
  }
  for (int i = tid; i < L * Vd; i += kThreads) {
    const int j = i / Vd;
    const int t = ch.t0 + j;
    v_s[i] = t < S ? to_f32(vb[t * sv.t + (i - j * Vd)]) : 0.f;
  }
  load_decay(lb, sl.t, ch.t0, S, L, Kd, cl_s);
  __syncthreads();
  cumsum_columns(L, Kd, cl_s, has_bonus ? clq_s : nullptr);
  __syncthreads();

  // the diagonal from the raw q and k
  for (int i = tid; i < L; i += kThreads) {
    float d = 0.f;
    for (int kk = 0; kk < K; ++kk)
      d += q_s[i * Kp + kk] * k_s[i * Kp + kk] * u_s[kk];
    dg_s[i] = d;
  }
  __syncthreads();

  // q_eff and k_eff in place
  for (int i = tid; i < L * K; i += kThreads) {
    const int j = i / K;
    const int kk = i - j * K;
    const int kd = Kd == 1 ? 0 : kk;
    q_s[j * Kp + kk] *= expf(clq_s[j * Kd + kd]);
    k_s[j * Kp + kk] *= expf(fminf(-cl_s[j * Kd + kd], clamp));
  }
  __syncthreads();

  // scores: strictly lower q_eff . k_eff, the diagonal term, zeros
  for (int i = tid; i < L * L; i += kThreads) {
    const int r = i / L;
    const int cc = i - r * L;
    float x = 0.f;
    if (cc < r) {
      for (int kk = 0; kk < K; ++kk)
        x = fmaf(q_s[r * Kp + kk], k_s[cc * Kp + kk], x);
    } else if (cc == r) {
      x = dg_s[r];
    }
    sc_s[i] = x;
  }
  __syncthreads();

  // y = scores . v + q_eff . S_in
  for (int i = tid; i < L * Vd; i += kThreads) {
    const int r = i / Vd;
    const int dv = i - r * Vd;
    const int t = ch.t0 + r;
    if (t >= S) continue;
    float y_intra = 0.f;
    for (int j = 0; j <= r; ++j)
      y_intra = fmaf(sc_s[r * L + j], v_s[j * Vd + dv], y_intra);
    float y_inter = 0.f;
    for (int kk = 0; kk < K; ++kk)
      y_inter = fmaf(q_s[r * Kp + kk], st_s[kk * Vd + dv], y_inter);
    store(ob + (size_t)t * H * Vd + dv, y_intra + y_inter);
  }
}

// ---------------------------------------------------------------------------
// phases 1 and 3 on the tensor cores (bfloat16)
// ---------------------------------------------------------------------------

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t& r0,
                                            uint32_t& r1, uint32_t& r2,
                                            uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t addr, uint32_t& r0,
                                                  uint32_t& r1, uint32_t& r2,
                                                  uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}
// c += a (16 x 16, row) . b (16 x 8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&x);
}

// x as bf16 hi + lo, hi = bf16(x), lo = bf16(x - hi): about 16 bits of
// mantissa, through two products on the tensor cores
__device__ __forceinline__ void split_pack(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 f = __bfloat1622float2(h);
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = pack_bf16(a - f.x, b - f.y);
}

// 16 bytes global -> shared, bypassing L1; src_bytes = 0 writes zeros
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src,
                                            int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// dst_hi/dst_lo[0..8) = split(src[0..8) * f[0..8)): 8 bf16 at 16-byte
// aligned addresses, one 16-byte load and two stores
__device__ __forceinline__ void scale_split8(const bf16* src, const float* f,
                                             bf16* dst_hi, bf16* dst_lo) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
  uint32_t hi[4], lo[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    split_pack(x.x * f[2 * i], x.y * f[2 * i + 1], hi[i], lo[i]);
  }
  *reinterpret_cast<uint4*>(dst_hi) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
  *reinterpret_cast<uint4*>(dst_lo) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
}

// rows [0, L) of a (L, cols) bf16 tile at row stride `stride` from the
// chunk's time steps (zeros past S).  vec (cols % 8 == 0, 16-byte aligned
// rows): 16-byte cp.async, every copy in flight at once, complete after
// cp_async_wait_all and a barrier; else element loads, a few in flight
// per thread, complete after a barrier.
__device__ __forceinline__ void load_rows(bf16* dst, int stride,
                                          const bf16* src, long long st,
                                          int cols, int t0, int S, int L,
                                          bool vec) {
  if (vec) {
    const int per = cols / 8;
    for (int i = threadIdx.x; i < L * per; i += blockDim.x) {
      const int r = i / per;
      const int c = (i - r * per) * 8;
      const bool live = t0 + r < S;
      cp_async_16(smem_u32(dst + r * stride + c),
                  live ? src + (t0 + r) * st + c : src, live ? 16 : 0);
    }
    return;
  }
  constexpr int kBatch = 8;
  const int n = L * cols;
  for (int i0 = threadIdx.x; i0 < n; i0 += kBatch * blockDim.x) {
    bf16 x[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int i = i0 + b * blockDim.x;
      const int r = i / cols;
      x[b] = (i < n && t0 + r < S) ? src[(t0 + r) * st + (i - r * cols)]
                                   : __float2bfloat16(0.f);
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int i = i0 + b * blockDim.x;
      const int r = i / cols;
      if (i < n) dst[r * stride + (i - r * cols)] = x[b];
    }
  }
}

// Phase 1: dS = k_rem^T v, (K x L) . (L x Vd), on (16 x 16) output tiles
// shared out over the block's L / 16 warps.  k_rem goes in as bf16 hi + lo
// (two products), v as it is.  KS = K / 16, VS = Vd / 16 at most; EXACT:
// exactly.
template <int KS, int VS, bool EXACT>
__global__ void __launch_bounds__(256) scan_state_mma(
    const bf16* __restrict__ k, const bf16* __restrict__ v,
    const float* __restrict__ ld, float* __restrict__ ds,
    float* __restrict__ tot, int S, int H, int n, int K, int Vd, int Kd,
    int L, Strides sk, Strides sv, Strides sl, int vec) {
  const Chunk ch = chunk_of(H, n, L);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int nw = blockDim.x >> 5;
  const int ks_ = K + 8;  // rows padded by 16 bytes: ldmatrix conflict-free
  const int vs_ = Vd + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* kr_s = reinterpret_cast<bf16*>(smem_raw);  // (L, K+8) k, then k_rem hi
  bf16* krl_s = kr_s + L * ks_;                    // (L, K+8) k_rem lo
  bf16* v_s = krl_s + L * ks_;                     // (L, Vd+8)
  float* cl_s = reinterpret_cast<float*>(v_s + L * vs_);  // (L, Kd)

  load_rows(kr_s, ks_, k + ch.b * sk.b + ch.h * sk.h, sk.t, K, ch.t0, S, L,
            vec);
  load_rows(v_s, vs_, v + ch.b * sv.b + ch.h * sv.h, sv.t, Vd, ch.t0, S, L,
            vec);
  load_decay(ld + ch.b * sl.b + ch.h * sl.h, sl.t, ch.t0, S, L, Kd, cl_s);
  cp_async_wait_all();
  __syncthreads();
  cumsum_columns(L, Kd, cl_s, nullptr);
  __syncthreads();

  // k_rem = k exp(cl_end - cl), 8 columns a step (the exponentials in
  // the SFU's fast form: hi + lo keeps ~16 bits, far inside bf16's needs)
  const float* cl_end = cl_s + (L - 1) * Kd;
  const int kc = K / 8;
  for (int i = tid; i < L * kc; i += blockDim.x) {
    const int j = i / kc;
    const int c = (i - j * kc) * 8;
    float f[8];
#pragma unroll
    for (int x = 0; x < 8; ++x) {
      const int kd = Kd == 1 ? 0 : c + x;
      f[x] = __expf(cl_end[kd] - cl_s[j * Kd + kd]);
    }
    scale_split8(kr_s + j * ks_ + c, f, kr_s + j * ks_ + c,
                 krl_s + j * ks_ + c);
  }
  const size_t bhc = ((size_t)ch.b * H + ch.h) * n + ch.c;
  for (int i = tid; i < Kd; i += blockDim.x)
    tot[bhc * Kd + i] = expf(cl_end[i]);
  __syncthreads();

  const int nk = EXACT ? KS : K / 16;
  const int nv = EXACT ? VS : Vd / 16;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  float* dsb = ds + bhc * K * Vd;
  for (int tile = warp; tile < nk * nv; tile += nw) {
    const int mt = tile / nv;
    const int jp = tile - mt * nv;
    float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    for (int js = 0; js < L / 16; ++js) {
      uint32_t a[4], al[4], b0, b1, b2, b3;
      // A = k_rem^T: k_rem is stored (L, K), so A comes transposed
      const int off = (js * 16 + (lane & 7) + ((lane >> 4) << 3)) * ks_ +
                      mt * 16 + ((lane >> 3) & 1) * 8;
      ldmatrix_x4_trans(smem_u32(kr_s + off), a[0], a[1], a[2], a[3]);
      ldmatrix_x4_trans(smem_u32(krl_s + off), al[0], al[1], al[2], al[3]);
      ldmatrix_x4_trans(
          smem_u32(v_s + (js * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * vs_ +
                   jp * 16 + (lane >> 4) * 8),
          b0, b1, b2, b3);
      mma_bf16(acc[0], a, b0, b1);
      mma_bf16(acc[1], a, b2, b3);
      mma_bf16(acc[0], al, b0, b1);
      mma_bf16(acc[1], al, b2, b3);
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int col = jp * 16 + nt * 8 + 2 * tig;
      float* r0 = dsb + (size_t)(mt * 16 + gid) * Vd + col;
      *reinterpret_cast<float2*>(r0) = make_float2(acc[nt][0], acc[nt][1]);
      *reinterpret_cast<float2*>(r0 + 8 * Vd) =
          make_float2(acc[nt][2], acc[nt][3]);
    }
  }
}

// Phase 3: one warp per 16 rows of the chunk (L / 16 warps).  LT = L / 16,
// KS = K / 16, VS = Vd / 16 at most; EXACT: exactly; VEC: vector decay
// (q_eff, k_eff as bf16 hi + lo, three products for each of their dots).
// The incoming state and the scores go in as hi + lo (two products).
template <int LT, int KS, int VS, bool EXACT, bool VEC>
__global__ void __launch_bounds__(256, 2) scan_out_mma(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const float* __restrict__ ld,
    const float* __restrict__ bonus, const float* __restrict__ s_in,
    bf16* __restrict__ out, int S, int H, int n, int K, int Vd, int Kd,
    int L, float clamp, Strides sq, Strides sk, Strides sv, Strides sl,
    int vec) {
  const Chunk ch = chunk_of(H, n, L);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const bool has_bonus = bonus != nullptr;
  const int ks_ = K + 8;
  const int vs_ = Vd + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // (L, K+8) q (q_eff hi)
  bf16* k_s = q_s + L * ks_;                      // (L, K+8) k (k_eff hi)
  bf16* v_s = k_s + L * ks_;                      // (L, Vd+8)
  bf16* st_s = v_s + L * vs_;                     // (K, Vd+8) S_in hi
  bf16* stl_s = st_s + K * vs_;                   // (K, Vd+8) S_in lo
  bf16* ql_s = stl_s + K * vs_;                   // VEC: (L, K+8) q_eff lo
  bf16* kl_s = ql_s + (VEC ? L * ks_ : 0);        // VEC: (L, K+8) k_eff lo
  float* cl_s =
      reinterpret_cast<float*>(kl_s + (VEC ? L * ks_ : 0));  // (L, Kd)
  float* clq_s = cl_s + L * Kd;  // (L, Kd) with a bonus: cl - ld
  float* dg_s = (has_bonus ? clq_s + L * Kd : clq_s);      // (L,)
  if (!has_bonus) clq_s = cl_s;

  load_rows(q_s, ks_, q + ch.b * sq.b + ch.h * sq.h, sq.t, K, ch.t0, S, L,
            vec);
  load_rows(k_s, ks_, k + ch.b * sk.b + ch.h * sk.h, sk.t, K, ch.t0, S, L,
            vec);
  load_rows(v_s, vs_, v + ch.b * sv.b + ch.h * sv.h, sv.t, Vd, ch.t0, S, L,
            vec);
  load_decay(ld + ch.b * sl.b + ch.h * sl.h, sl.t, ch.t0, S, L, Kd, cl_s);
  const float4* sb = reinterpret_cast<const float4*>(
      s_in + (((size_t)ch.b * H + ch.h) * n + ch.c) * K * Vd);
  constexpr int kBatch = 4;  // float4 loads a thread has in flight
  const int n4 = K * Vd / 4;
  for (int i0 = tid; i0 < n4; i0 += kBatch * blockDim.x) {
    float4 x[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int i = i0 + b * blockDim.x;
      if (i < n4) x[b] = sb[i];
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int i = i0 + b * blockDim.x;
      if (i >= n4) continue;
      const int kk = (4 * i) / Vd;
      const int dv = 4 * i - kk * Vd;
      uint2 hi, lo;
      split_pack(x[b].x, x[b].y, hi.x, lo.x);
      split_pack(x[b].z, x[b].w, hi.y, lo.y);
      *reinterpret_cast<uint2*>(st_s + kk * vs_ + dv) = hi;
      *reinterpret_cast<uint2*>(stl_s + kk * vs_ + dv) = lo;
    }
  }
  cp_async_wait_all();
  __syncthreads();
  cumsum_columns(L, Kd, cl_s, has_bonus ? clq_s : nullptr);
  // the diagonal q.k.u from the raw q and k, in f32, two threads a row
  // (without a bonus and with a scalar decay it is the raw score q.k the
  // tensor cores give, taken from there)
  const bool own_diag = VEC || has_bonus;
  if (own_diag) {
    const int r = tid >> 1;
    float d = 0.f;
#pragma unroll 8
    for (int kk = tid & 1; kk < K; kk += 2) {
      const float u = has_bonus ? bonus[(size_t)ch.h * K + kk] : 1.f;
      d += __bfloat162float(q_s[r * ks_ + kk]) *
           __bfloat162float(k_s[r * ks_ + kk]) * u;
    }
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    if ((tid & 1) == 0) dg_s[r] = d;
  }
  if (VEC) {  // q_eff, k_eff formed in f32, kept as bf16 hi + lo
    __syncthreads();
    const int kc = K / 8;
    for (int i = tid; i < L * kc; i += blockDim.x) {
      const int j = i / kc;
      const int c = (i - j * kc) * 8;
      const int o = j * ks_ + c;
      float fq[8], fk[8];
#pragma unroll
      for (int x = 0; x < 8; ++x) {
        fq[x] = __expf(clq_s[j * Kd + c + x]);
        fk[x] = __expf(fminf(-cl_s[j * Kd + c + x], clamp));
      }
      scale_split8(q_s + o, fq, q_s + o, ql_s + o);
      scale_split8(k_s + o, fk, k_s + o, kl_s + o);
    }
  }
  __syncthreads();

  const int nk = EXACT ? KS : K / 16;
  const int nv = EXACT ? VS : Vd / 16;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int row0 = warp * 16;
  const int ra = row0 + gid;  // the two rows a thread holds
  const int rb = ra + 8;

  uint32_t qf[KS][4], qfl[VEC ? KS : 1][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    if (!EXACT && kk >= nk) continue;
    const int off = (row0 + (lane & 15)) * ks_ + kk * 16 + (lane >> 4) * 8;
    ldmatrix_x4(smem_u32(q_s + off), qf[kk][0], qf[kk][1], qf[kk][2],
                qf[kk][3]);
    if (VEC)
      ldmatrix_x4(smem_u32(ql_s + off), qfl[VEC ? kk : 0][0],
                  qfl[VEC ? kk : 0][1], qfl[VEC ? kk : 0][2],
                  qfl[VEC ? kk : 0][3]);
  }

  // y = q . S_in (scalar decay: then scaled by exp(clq_r))
  float y[2 * VS][4];
#pragma unroll
  for (int j = 0; j < 2 * VS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) y[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    if (!EXACT && kk >= nk) continue;
#pragma unroll
    for (int jp = 0; jp < VS; ++jp) {
      if (!EXACT && jp >= nv) continue;
      const int off = (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * vs_ +
                      jp * 16 + (lane >> 4) * 8;
      uint32_t b0, b1, b2, b3, c0, c1, c2, c3;
      ldmatrix_x4_trans(smem_u32(st_s + off), b0, b1, b2, b3);
      ldmatrix_x4_trans(smem_u32(stl_s + off), c0, c1, c2, c3);
      mma_bf16(y[2 * jp], qf[kk], b0, b1);
      mma_bf16(y[2 * jp + 1], qf[kk], b2, b3);
      mma_bf16(y[2 * jp], qf[kk], c0, c1);
      mma_bf16(y[2 * jp + 1], qf[kk], c2, c3);
      if (VEC) {
        mma_bf16(y[2 * jp], qfl[VEC ? kk : 0], b0, b1);
        mma_bf16(y[2 * jp + 1], qfl[VEC ? kk : 0], b2, b3);
      }
    }
  }
  float cqa = 0.f, cqb = 0.f;
  if (!VEC) {
    cqa = clq_s[ra];
    cqb = clq_s[rb];
    const float fa = expf(cqa), fb = expf(cqb);
#pragma unroll
    for (int j = 0; j < 2 * VS; ++j) {
      y[j][0] *= fa;
      y[j][1] *= fa;
      y[j][2] *= fb;
      y[j][3] *= fb;
    }
  }

  // scores of this warp's rows against columns 0 .. row0 + 15
  float s[2 * LT][4];
#pragma unroll
  for (int j = 0; j < 2 * LT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    if (!EXACT && kk >= nk) continue;
#pragma unroll
    for (int jp = 0; jp < LT; ++jp) {
      if (jp > warp) continue;
      const int off = (jp * 16 + ((lane >> 4) << 3) + (lane & 7)) * ks_ +
                      kk * 16 + ((lane >> 3) & 1) * 8;
      uint32_t b0, b1, b2, b3;
      ldmatrix_x4(smem_u32(k_s + off), b0, b1, b2, b3);
      mma_bf16(s[2 * jp], qf[kk], b0, b1);
      mma_bf16(s[2 * jp + 1], qf[kk], b2, b3);
      if (VEC) {
        mma_bf16(s[2 * jp], qfl[VEC ? kk : 0], b0, b1);
        mma_bf16(s[2 * jp + 1], qfl[VEC ? kk : 0], b2, b3);
        ldmatrix_x4(smem_u32(kl_s + off), b0, b1, b2, b3);
        mma_bf16(s[2 * jp], qf[kk], b0, b1);
        mma_bf16(s[2 * jp + 1], qf[kk], b2, b3);
      }
    }
  }
  // strictly lower: the decay factor (scalar: exp(clq_r + min(-cl_c,
  // clamp)), vector: inside the operands); the diagonal; zeros above
  const float dga = own_diag ? dg_s[ra] : 0.f;
  const float dgb = own_diag ? dg_s[rb] : 0.f;
#pragma unroll
  for (int j = 0; j < 2 * LT; ++j) {
    if ((j >> 1) > warp) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = j * 8 + 2 * tig + (e & 1);
      const int r = e < 2 ? ra : rb;
      float x = s[j][e];
      if (col < r) {
        if (!VEC) x *= __expf((e < 2 ? cqa : cqb) + fminf(-cl_s[col], clamp));
      } else if (col > r) {
        x = 0.f;
      } else if (own_diag) {
        x = e < 2 ? dga : dgb;
      }
      s[j][e] = x;
    }
  }

  // y += scores . v, the scores as bf16 hi + lo A fragments from registers
#pragma unroll
  for (int ks = 0; ks < LT; ++ks) {
    if (ks > warp) continue;
    uint32_t pa[4], pl[4];
    split_pack(s[2 * ks][0], s[2 * ks][1], pa[0], pl[0]);
    split_pack(s[2 * ks][2], s[2 * ks][3], pa[1], pl[1]);
    split_pack(s[2 * ks + 1][0], s[2 * ks + 1][1], pa[2], pl[2]);
    split_pack(s[2 * ks + 1][2], s[2 * ks + 1][3], pa[3], pl[3]);
#pragma unroll
    for (int jp = 0; jp < VS; ++jp) {
      if (!EXACT && jp >= nv) continue;
      uint32_t b0, b1, b2, b3;
      ldmatrix_x4_trans(
          smem_u32(v_s + (ks * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * vs_ +
                   jp * 16 + (lane >> 4) * 8),
          b0, b1, b2, b3);
      mma_bf16(y[2 * jp], pa, b0, b1);
      mma_bf16(y[2 * jp + 1], pa, b2, b3);
      mma_bf16(y[2 * jp], pl, b0, b1);
      mma_bf16(y[2 * jp + 1], pl, b2, b3);
    }
  }

  // out rows t0 + ra and t0 + rb, two columns a store
  bf16* ob = out + ((size_t)ch.b * S * H + ch.h) * Vd;
  const int ta = ch.t0 + ra;
  const int tb = ch.t0 + rb;
#pragma unroll
  for (int j = 0; j < 2 * VS; ++j) {
    if (!EXACT && (j >> 1) >= nv) continue;
    const int col = j * 8 + 2 * tig;
    if (ta < S)
      *reinterpret_cast<uint32_t*>(ob + (size_t)ta * H * Vd + col) =
          pack_bf16(y[j][0], y[j][1]);
    if (tb < S)
      *reinterpret_cast<uint32_t*>(ob + (size_t)tb * H * Vd + col) =
          pack_bf16(y[j][2], y[j][3]);
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// the bf16 tensor-core phases take these shapes
bool mma_shape(int K, int Vd, int L) {
  return L % 16 == 0 && L >= 16 && L <= 128 && K % 16 == 0 && K <= 128 &&
         Vd % 16 == 0 && Vd <= 128;
}

size_t smem_state_f32(int K, int Vd, int Kd, int L) {
  return sizeof(float) *
         ((size_t)L * (K | 1) + (size_t)L * Vd + (size_t)L * Kd);
}
size_t smem_out_f32(int K, int Vd, int Kd, int L, bool has_bonus) {
  const size_t Kp = K | 1;
  return sizeof(float) *
         (2 * L * Kp + (size_t)L * Vd + (has_bonus ? 2 : 1) * (size_t)L * Kd +
          (size_t)L * L + L + (size_t)K * Vd + K);
}
size_t smem_state_mma(int K, int Vd, int Kd, int L) {
  return sizeof(bf16) * (2 * (size_t)L * (K + 8) + (size_t)L * (Vd + 8)) +
         sizeof(float) * (size_t)L * Kd;
}
size_t smem_out_mma(int K, int Vd, int Kd, int L, bool has_bonus) {
  const size_t q_k = (Kd > 1 ? 4 : 2) * (size_t)L * (K + 8);
  return sizeof(bf16) *
             (q_k + (size_t)L * (Vd + 8) + 2 * (size_t)K * (Vd + 8)) +
         sizeof(float) * ((has_bonus ? 2 : 1) * (size_t)L * Kd + L);
}

// Shared memory of the largest block the launch runs, in bytes
// (kernels/linear_scan.py checks the same against the card's limit).
size_t smem_bytes(int dtype, int K, int Vd, int Kd, int L, bool has_bonus) {
  size_t a, b;
  if (dtype == 1 && mma_shape(K, Vd, L)) {
    a = smem_state_mma(K, Vd, Kd, L);
    b = smem_out_mma(K, Vd, Kd, L, has_bonus);
  } else {
    a = smem_state_f32(K, Vd, Kd, L);
    b = smem_out_f32(K, Vd, Kd, L, has_bonus);
  }
  return a > b ? a : b;
}

template <typename Kern>
cudaError_t allow_smem(Kern kern, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;  // the default limit
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

#define SCAN_CHECK(x)                      \
  do {                                     \
    cudaError_t e_ = (x);                  \
    if (e_ != cudaSuccess) return (int)e_; \
  } while (0)

template <typename T>
int launch_f32(const void* q, const void* k, const void* v, const float* ld,
               const float* bonus, void* out, float* state, float* ds,
               float* tot, int B, int S, int H, int K, int Vd, int Kd, int L,
               int n, float clamp, Strides sq, Strides sk, Strides sv,
               Strides sl, cudaStream_t stream) {
  const size_t s1 = smem_state_f32(K, Vd, Kd, L);
  const size_t s3 = smem_out_f32(K, Vd, Kd, L, bonus != nullptr);
  SCAN_CHECK(allow_smem(scan_state_f32<T>, s1));
  SCAN_CHECK(allow_smem(scan_out_f32<T>, s3));
  const unsigned blocks = (unsigned)B * H * n;
  scan_state_f32<T><<<blocks, kThreads, s1, stream>>>(
      static_cast<const T*>(k), static_cast<const T*>(v), ld, ds, tot, S, H,
      n, K, Vd, Kd, L, sk, sv, sl);
  SCAN_CHECK(cudaGetLastError());
  SCAN_CHECK(launch_pass(ds, tot, state, B * H, n, K, Vd, Kd, stream));
  scan_out_f32<T><<<blocks, kThreads, s3, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), ld, bonus, ds, static_cast<T*>(out), S, H, n,
      K, Vd, Kd, L, clamp, sq, sk, sv, sl);
  return (int)cudaGetLastError();
}

template <int LT, int KS, int VS, bool EXACT, bool VEC>
int launch_mma(const void* q, const void* k, const void* v, const float* ld,
               const float* bonus, void* out, float* state, float* ds,
               float* tot, int B, int S, int H, int K, int Vd, int Kd, int L,
               int n, float clamp, Strides sq, Strides sk, Strides sv,
               Strides sl, int vec, cudaStream_t stream) {
  const size_t s1 = smem_state_mma(K, Vd, Kd, L);
  const size_t s3 = smem_out_mma(K, Vd, Kd, L, bonus != nullptr);
  SCAN_CHECK(allow_smem(scan_state_mma<KS, VS, EXACT>, s1));
  SCAN_CHECK(allow_smem(scan_out_mma<LT, KS, VS, EXACT, VEC>, s3));
  const unsigned blocks = (unsigned)B * H * n;
  const int threads = 32 * (L / 16);
  scan_state_mma<KS, VS, EXACT><<<blocks, threads, s1, stream>>>(
      static_cast<const bf16*>(k), static_cast<const bf16*>(v), ld, ds, tot,
      S, H, n, K, Vd, Kd, L, sk, sv, sl, vec);
  SCAN_CHECK(cudaGetLastError());
  SCAN_CHECK(launch_pass(ds, tot, state, B * H, n, K, Vd, Kd, stream));
  scan_out_mma<LT, KS, VS, EXACT, VEC><<<blocks, threads, s3, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), ld, bonus, ds, static_cast<bf16*>(out), S,
      H, n, K, Vd, Kd, L, clamp, sq, sk, sv, sl, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out); ld and bonus are
// float32, bonus may be null; strides are in elements.  ds: (B, H,
// n_chunks, K, Vd) f32 scratch; tot: (B, H, n_chunks, Kd) f32 scratch.
// vec: q, k and v rows may be read 16 bytes at a time.
extern "C" int linear_scan_launch(
    int dtype, const void* q, const void* k, const void* v, const void* ld,
    const void* bonus, void* out, void* state, void* ds, void* tot, int B,
    int S, int H, int K, int Vd, int Kd, int L, float clamp, long long sqb,
    long long sqt, long long sqh, long long skb, long long skt, long long skh,
    long long svb, long long svt, long long svh, long long slb,
    long long slt, long long slh, int vec, void* stream) {
  if (B == 0 || H == 0) return 0;
  const int n = (S + L - 1) / L;
  const Strides sq{sqb, sqt, sqh}, sk{skb, skt, skh}, sv{svb, svt, svh},
      sl{slb, slt, slh};
  const float* ldf = static_cast<const float*>(ld);
  const float* uf = static_cast<const float*>(bonus);
  float* st = static_cast<float*>(state);
  float* dsf = static_cast<float*>(ds);
  float* tf = static_cast<float*>(tot);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_f32<float>(q, k, v, ldf, uf, out, st, dsf, tf, B, S, H, K,
                             Vd, Kd, L, n, clamp, sq, sk, sv, sl, s);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  if (!mma_shape(K, Vd, L))
    return launch_f32<bf16>(q, k, v, ldf, uf, out, st, dsf, tf, B, S, H, K,
                            Vd, Kd, L, n, clamp, sq, sk, sv, sl, s);
  if (L == 128 && K == 64 && Vd == 64 && Kd == 1)  // Mamba2's chunk, head
    return launch_mma<8, 4, 4, true, false>(q, k, v, ldf, uf, out, st, dsf, tf,
                                            B, S, H, K, Vd, Kd, L, n, clamp,
                                            sq, sk, sv, sl, vec, s);
  if (L == 32 && K == 64 && Vd == 64 && Kd > 1)  // RWKV6's
    return launch_mma<2, 4, 4, true, true>(q, k, v, ldf, uf, out, st, dsf, tf,
                                           B, S, H, K, Vd, Kd, L, n, clamp,
                                           sq, sk, sv, sl, vec, s);
  if (Kd > 1)
    return launch_mma<8, 8, 8, false, true>(q, k, v, ldf, uf, out, st, dsf,
                                            tf, B, S, H, K, Vd, Kd, L, n,
                                            clamp, sq, sk, sv, sl, vec, s);
  return launch_mma<8, 8, 8, false, false>(q, k, v, ldf, uf, out, st, dsf, tf,
                                           B, S, H, K, Vd, Kd, L, n, clamp, sq,
                                           sk, sv, sl, vec, s);
}

extern "C" long long linear_scan_smem_bytes(int dtype, int K, int Vd, int Kd,
                                            int L, int has_bonus) {
  return (long long)smem_bytes(dtype, K, Vd, Kd, L, has_bonus != 0);
}
