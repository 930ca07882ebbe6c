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
// the arithmetic (4 * G * D flops per live token, in f32 on the CUDA
// cores) is far below the f32 rate.  What the design does about it:
//   * one block per (row, kv head) loads each live K/V page row of its kv
//     head ONCE into shared memory and scores all G query heads against
//     it, so a page is read G times less than per-query-head attention;
//   * the block walks only the pages covering lengths[b]: it never reads
//     a -1 entry or a page past ceil(len / page) (the TPU kernel
//     redirects those DMAs to page 0 and masks them; skipping is cheaper);
//   * the G query vectors and the f32 m / l / acc state stay on chip;
//     only the (G, D) result is written.
// Still simple on purpose: one page at a time, no split over pages for
// long rows, no cp.async/TMA double buffering, CUDA-core dot products
// instead of wgmma.  Those are later work.
//
// The launch goes on the caller's stream, allocates nothing and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) paged_attention_kernel(
    const float* __restrict__ q,          // (B, H, D) f32
    const T* __restrict__ k_pages,        // (P, page, Hkv, D)
    const T* __restrict__ v_pages,        // (P, page, Hkv, D)
    const int32_t* __restrict__ table,    // (B, max_pages), -1 = dead
    const int32_t* __restrict__ lengths,  // (B,)
    float* __restrict__ out,              // (B, H, D) f32
    int H, int Hkv, int D, int P, int page, int max_pages, float scale,
    float softcap) {
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int G = H / Hkv;
  const int tid = threadIdx.x;
  const int Dp = D + 1;  // padded K rows: a warp reading one column of
                         // 32 different rows hits 32 different banks

  extern __shared__ float smem[];
  float* q_s = smem;              // (G, D)     the block's query heads
  float* k_s = q_s + G * D;       // (page, D+1)
  float* v_s = k_s + page * Dp;   // (page, D)
  float* s_s = v_s + page * D;    // (G, page)  scores, then weights
  float* acc = s_s + G * page;    // (G, D)     f32 accumulator
  float* m_s = acc + G * D;       // (G,)       running max
  float* l_s = m_s + G;           // (G,)       running denominator
  float* c_s = l_s + G;           // (G,)       this page's correction

  // query heads h*G .. h*G+G-1 of row b are contiguous in q and out
  const size_t qoff = ((size_t)b * H + (size_t)h * G) * D;
  for (int i = tid; i < G * D; i += blockDim.x) {
    q_s[i] = q[qoff + i];
    acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += blockDim.x) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }

  const int len = lengths[b];
  int n_live = len > 0 ? (len + page - 1) / page : 0;
  if (n_live > max_pages) n_live = max_pages;
  __syncthreads();

  for (int pi = 0; pi < n_live; ++pi) {
    const int pid = table[(size_t)b * max_pages + pi];
    // the same value for every thread: the whole block skips together
    if (pid < 0 || pid >= P) continue;

    for (int i = tid; i < page * D; i += blockDim.x) {
      const int j = i / D;
      const int d = i - j * D;
      const size_t off = (((size_t)pid * page + j) * Hkv + h) * D + d;
      k_s[j * Dp + d] = to_f32(k_pages[off]);
      v_s[i] = to_f32(v_pages[off]);
    }
    __syncthreads();

    for (int i = tid; i < G * page; i += blockDim.x) {
      const int g = i / page;
      const int j = i - g * page;
      const float* qg = q_s + g * D;
      const float* kj = k_s + j * Dp;
      float s = 0.f;
      for (int d = 0; d < D; ++d) s = fmaf(qg[d], kj[d], s);
      s *= scale;
      if (softcap != 0.f) s = softcap * tanhf(s / softcap);
      s_s[i] = (pi * page + j < len) ? s : kNegInf;
    }
    __syncthreads();

    for (int g = tid; g < G; g += blockDim.x) {
      float* sg = s_s + g * page;
      const float m_prev = m_s[g];
      float m_new = m_prev;
      for (int j = 0; j < page; ++j) m_new = fmaxf(m_new, sg[j]);
      float sum = 0.f;
      for (int j = 0; j < page; ++j) {
        // masked positions get weight 0 explicitly, as in the TPU kernel
        const float p = (pi * page + j < len) ? expf(sg[j] - m_new) : 0.f;
        sg[j] = p;
        sum += p;
      }
      const float corr = expf(m_prev - m_new);
      m_s[g] = m_new;
      l_s[g] = l_s[g] * corr + sum;
      c_s[g] = corr;
    }
    __syncthreads();

    for (int i = tid; i < G * D; i += blockDim.x) {
      const int g = i / D;
      const int d = i - g * D;
      const float* pg = s_s + g * page;
      float a = acc[i] * c_s[g];
      for (int j = 0; j < page; ++j) a = fmaf(pg[j], v_s[j * D + d], a);
      acc[i] = a;
    }
    __syncthreads();
  }

  // l == 0 (no live position) gives 0 / 1e-30 = exact zeros
  for (int i = tid; i < G * D; i += blockDim.x) {
    out[qoff + i] = acc[i] / fmaxf(l_s[i / D], 1e-30f);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* table,
           const void* lengths, void* out, int B, int H, int Hkv, int D, int P,
           int page, int max_pages, float scale, float softcap,
           cudaStream_t stream) {
  const int G = H / Hkv;
  const size_t smem =
      sizeof(float) * ((size_t)2 * G * D + (size_t)page * (D + 1) +
                       (size_t)page * D + (size_t)G * page + 3 * (size_t)G);
  if (smem > 48 * 1024) {  // above the default limit only: a host call
    cudaError_t err = cudaFuncSetAttribute(
        paged_attention_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(B, Hkv);
  paged_attention_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int32_t*>(table),
      static_cast<const int32_t*>(lengths), static_cast<float*>(out), H, Hkv,
      D, P, page, max_pages, scale, softcap);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 pages, 1 = bfloat16 pages.  q and out are float32.
extern "C" int paged_attention_launch(int dtype, const void* q, const void* k,
                                      const void* v, const void* table,
                                      const void* lengths, void* out, int B,
                                      int H, int Hkv, int D, int P, int page,
                                      int max_pages, float scale,
                                      float softcap, void* stream) {
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, table, lengths, out, B, H, Hkv, D, P, page,
                         max_pages, scale, softcap, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, table, lengths, out, B, H, Hkv, D,
                                 P, page, max_pages, scale, softcap, s);
  return (int)cudaErrorInvalidValue;
}
