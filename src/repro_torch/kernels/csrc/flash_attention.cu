// Blocked forward flash attention for Hopper (sm_90a), bound through a
// plain C interface (kernels/flash_attention.py loads it with ctypes).
//
// Replaces the Pallas TPU kernel flash_attention_pallas
// (src/repro/kernels/flash_attention.py:94, body _flash_kernel at :34):
// softmax(q k^T * scale) v over the full sequence with an online softmax
// in f32, causal or bidirectional, an optional sliding window
// (col > row - window) and logit softcap, GQA with the G query heads of a
// kv head packed as rows (packed row r = s * G + g, as the TPU kernel
// packs them), masked scores -1e30, P rounded to v's dtype before the PV
// product, l floored at 1e-30, output in q's dtype.
//
// What bounds it on the card: at prefill lengths the work is
// 2 * (D + Dv) flops per unmasked (query, key, head) triple -- far above
// the card's bytes-per-flop line -- so the operations bound it; the bytes
// (q, k, v, out once) are a few milliseconds' worth less.  What the design
// does about it, simply for now:
//   * one block per (batch x kv head, 64 packed rows): a K/V tile is
//     loaded once into shared memory for all G query heads of its kv
//     head and all 64 rows, so K/V are re-read Sq * G / 64 times, not
//     Sq * H times;
//   * tiles wholly above the diagonal (causal) or wholly below the window
//     are never loaded (the TPU kernel visits and skips them);
//   * 256 threads each hold a 4 x 4 block of scores and 4 rows of the
//     f32 accumulator in registers; rows and columns are strided by 16 so
//     that the shared-memory reads of one warp hit distinct banks (odd
//     row stride for Q and K);
//   * the row max and row sum reduce across the 16 threads of a row with
//     warp shuffles, and m / l live in registers.
// Still simple on purpose: CUDA-core f32 FMAs instead of wgmma, no
// cp.async/TMA double buffering.  Those are later work.
//
// The launch goes on the caller's stream, allocates nothing and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kRows = 64;       // packed (query, head) rows per block
constexpr int kCols = 64;       // keys per kv tile
constexpr int kThreads = 256;   // 16 x 16: tx over columns, ty over rows
constexpr int kMaxDv = 128;     // 8 accumulator columns of 16 per row
constexpr int kPs = kCols + 16; // P row stride: rows ty and ty + 1 of a
                                // warp land 16 banks apart

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ float round_as(float x);
template <>
__device__ __forceinline__ float round_as<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float round_as<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(
    const T* __restrict__ q,   // (B, Sq, H, D)
    const T* __restrict__ k,   // (B, Sk, Hkv, D)
    const T* __restrict__ v,   // (B, Sk, Hkv, Dv)
    T* __restrict__ out,       // (B, Sq, H, Dv)
    int Sq, int Sk, int H, int Hkv, int D, int Dv, float scale,
    float softcap, int causal, int window) {
  const int G = H / Hkv;
  const int b = blockIdx.y / Hkv;
  const int h = blockIdx.y - b * Hkv;
  const int r0 = blockIdx.x * kRows;
  const int n_rows = Sq * G;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int Dp = D | 1;  // odd stride: 16 rows of one column in 16 banks

  extern __shared__ float smem[];
  float* q_s = smem;               // (kRows, Dp)
  float* k_s = q_s + kRows * Dp;   // (kCols, Dp)
  float* v_s = k_s + kCols * Dp;   // (kCols, Dv)
  float* p_s = v_s + kCols * Dv;   // (kRows, kPs)

  for (int i = tid; i < kRows * D; i += kThreads) {
    const int rr = i / D;
    const int d = i - rr * D;
    const int row = r0 + rr;
    float x = 0.f;
    if (row < n_rows) {
      const int s = row / G;
      const int g = row - s * G;
      x = to_f32(q[(((size_t)b * Sq + s) * H + h * G + g) * D + d]);
    }
    q_s[rr * Dp + d] = x;
  }

  // the kv tiles some row of this block can see
  const int q_first = r0 / G;
  const int q_last = min(Sq - 1, (r0 + kRows - 1) / G);
  int t_lo = 0;
  int t_hi = (Sk + kCols - 1) / kCols - 1;
  if (causal) t_hi = min(t_hi, q_last / kCols);
  if (window > 0 && q_first - window + 1 > 0)
    t_lo = (q_first - window + 1) / kCols;

  float m[4], l[4], acc[4][kMaxDv / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kMaxDv / 16; ++c) acc[i][c] = 0.f;
  }
  const int nc = (Dv + 15) / 16;

  for (int t = t_lo; t <= t_hi; ++t) {
    const int c0 = t * kCols;
    __syncthreads();  // the previous tile's P and V are consumed
    for (int i = tid; i < kCols * D; i += kThreads) {
      const int j = i / D;
      const int d = i - j * D;
      const int key = c0 + j;
      k_s[j * Dp + d] =
          key < Sk ? to_f32(k[(((size_t)b * Sk + key) * Hkv + h) * D + d])
                   : 0.f;
    }
    for (int i = tid; i < kCols * Dv; i += kThreads) {
      const int j = i / Dv;
      const int d = i - j * Dv;
      const int key = c0 + j;
      v_s[i] =
          key < Sk ? to_f32(v[(((size_t)b * Sk + key) * Hkv + h) * Dv + d])
                   : 0.f;
    }
    __syncthreads();

    // scores of rows ty + 16 i against keys tx + 16 j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = q_s[(ty + 16 * i) * Dp + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = k_s[(tx + 16 * j) * Dp + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // scale, softcap, mask, online softmax (every thread of the warp
    // takes part in the shuffles, padded rows included)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = (r0 + ty + 16 * i) / G;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = c0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (softcap != 0.f) x = softcap * tanhf(x / softcap);
        bool ok = col < Sk;
        if (causal) ok = ok && col <= qpos;
        if (window > 0) ok = ok && col > qpos - window;
        x = ok ? x : kNegInf;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        p_s[(ty + 16 * i) * kPs + tx + 16 * j] = round_as<T>(p);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kMaxDv / 16; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

    // acc[row][tx + 16 c] += P[row][:] . V[:][tx + 16 c]
    for (int j = 0; j < kCols; ++j) {
      float pj[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pj[i] = p_s[(ty + 16 * i) * kPs + j];
#pragma unroll
      for (int c = 0; c < kMaxDv / 16; ++c) {
        const int dv = tx + 16 * c;
        if (c < nc && dv < Dv) {
          const float vv = v_s[j * Dv + dv];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pj[i], vv, acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + ty + 16 * i;
    if (row >= n_rows) continue;
    const int s = row / G;
    const int g = row - s * G;
    T* o = out + (((size_t)b * Sq + s) * H + h * G + g) * Dv;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < kMaxDv / 16; ++c) {
      const int dv = tx + 16 * c;
      if (c < nc && dv < Dv) store(o + dv, acc[i][c] / denom);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Sk, int H, int Hkv, int D, int Dv, float scale,
           float softcap, int causal, int window, cudaStream_t stream) {
  const int Dp = D | 1;
  const size_t smem =
      sizeof(float) * ((size_t)kRows * Dp + (size_t)kCols * Dp +
                       (size_t)kCols * Dv + (size_t)kRows * kPs);
  if (smem > 48 * 1024) {  // above the default limit only: a host call
    cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int G = H / Hkv;
  dim3 grid((Sq * G + kRows - 1) / kRows, B * Hkv);
  flash_attention_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Sq, Sk, H, Hkv, D, Dv,
      scale, softcap, causal, window);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out alike).
extern "C" int flash_attention_launch(int dtype, const void* q, const void* k,
                                      const void* v, void* out, int B, int Sq,
                                      int Sk, int H, int Hkv, int D, int Dv,
                                      float scale, float softcap, int causal,
                                      int window, void* stream) {
  if (B == 0 || Sq == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, out, B, Sq, Sk, H, Hkv, D, Dv, scale,
                         softcap, causal, window, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, out, B, Sq, Sk, H, Hkv, D, Dv,
                                 scale, softcap, causal, window, s);
  return (int)cudaErrorInvalidValue;
}
