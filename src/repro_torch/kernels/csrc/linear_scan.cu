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
// inputs, so at L = 128, K = Vd = 64 the arithmetic outweighs the bytes;
// the sequential dependence through S leaves only B * H blocks of
// parallelism.  What the design does about it, simply for now:
//   * one block per (batch, head) loops over the chunks in order with the
//     state in shared memory (the TPU kernel's sequential grid axis), so
//     no state ever goes to device memory between chunks;
//   * a chunk's q, k, v, decays and the (L, L) scores stay in shared
//     memory (~183 KB at L = 128, K = Vd = 64); the scores are never
//     written out;
//   * inputs are read through strides: Mamba2's B and C, shared by every
//     head, come in as stride-0 views over the heads and are never copied
//     per head;
//   * rows of q and k are padded to an odd stride so that one warp's
//     column reads hit distinct banks.
// Still simple on purpose: CUDA-core f32 FMAs, one output element per
// thread and loop step, no wgmma, no overlap of the next chunk's loads.
// Those are later work.
//
// The launch goes on the caller's stream, allocates nothing and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

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

template <typename T>
__global__ void __launch_bounds__(kThreads) linear_scan_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const float* __restrict__ ld,
    const float* __restrict__ bonus,  // (H, K) or null
    T* __restrict__ out,              // (B, S, H, Vd)
    float* __restrict__ state_out,    // (B, H, K, Vd)
    int S, int H, int K, int Vd, int Kd, int L, float clamp, Strides sq,
    Strides sk, Strides sv, Strides sl) {
  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  const int tid = threadIdx.x;
  const int Kp = K | 1;
  const bool has_bonus = bonus != nullptr;

  extern __shared__ float smem[];
  float* q_s = smem;              // (L, Kp) q, then q_eff
  float* k_s = q_s + L * Kp;      // (L, Kp) k, then k_eff, then k_rem
  float* v_s = k_s + L * Kp;      // (L, Vd)
  float* cl_s = v_s + L * Vd;     // (L, Kd) the log decay, then its cumsum
  float* clq_s = cl_s + L * Kd;   // (L, Kd) with a bonus: cl - ld
  float* sc_s = has_bonus ? clq_s + L * Kd : clq_s;  // (L, L) scores
  if (!has_bonus) clq_s = cl_s;
  float* dg_s = sc_s + L * L;     // (L,)    the diagonal q.k.u
  float* st_s = dg_s + L;         // (K, Vd) the state
  float* u_s = st_s + K * Vd;     // (K,)    the bonus (ones without)

  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;
  const float* lb = ld + b * sl.b + h * sl.h;
  T* ob = out + ((size_t)b * S * H + h) * Vd;  // time stride H * Vd

  for (int i = tid; i < K * Vd; i += kThreads) st_s[i] = 0.f;
  for (int i = tid; i < K; i += kThreads)
    u_s[i] = has_bonus ? bonus[(size_t)h * K + i] : 1.f;

  const int n_chunks = (S + L - 1) / L;
  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * L;
    __syncthreads();  // the previous chunk's state update is done

    // 1. load the chunk; steps past S are zeros (no decay, no input)
    for (int i = tid; i < L * K; i += kThreads) {
      const int j = i / K;
      const int kk = i - j * K;
      const int t = t0 + j;
      const bool live = t < S;
      q_s[j * Kp + kk] = live ? to_f32(qb[t * sq.t + kk]) : 0.f;
      k_s[j * Kp + kk] = live ? to_f32(kb[t * sk.t + kk]) : 0.f;
    }
    for (int i = tid; i < L * Vd; i += kThreads) {
      const int j = i / Vd;
      const int t = t0 + j;
      v_s[i] = t < S ? to_f32(vb[t * sv.t + (i - j * Vd)]) : 0.f;
    }
    for (int i = tid; i < L * Kd; i += kThreads) {
      const int j = i / Kd;
      const int t = t0 + j;
      cl_s[i] = t < S ? lb[t * sl.t + (i - j * Kd)] : 0.f;
    }
    __syncthreads();

    // 2. inclusive cumsum down each decay column; 3. the diagonal from
    // the raw q and k
    for (int kd = tid; kd < Kd; kd += kThreads) {
      float acc = 0.f;
      for (int j = 0; j < L; ++j) {
        const float x = cl_s[j * Kd + kd];
        acc += x;
        cl_s[j * Kd + kd] = acc;
        if (has_bonus) clq_s[j * Kd + kd] = acc - x;
      }
    }
    for (int i = tid; i < L; i += kThreads) {
      float d = 0.f;
      for (int kk = 0; kk < K; ++kk)
        d += q_s[i * Kp + kk] * k_s[i * Kp + kk] * u_s[kk];
      dg_s[i] = d;
    }
    __syncthreads();

    // 4. q_eff and k_eff in place
    for (int i = tid; i < L * K; i += kThreads) {
      const int j = i / K;
      const int kk = i - j * K;
      const int kd = Kd == 1 ? 0 : kk;
      q_s[j * Kp + kk] *= expf(clq_s[j * Kd + kd]);
      k_s[j * Kp + kk] *= expf(fminf(-cl_s[j * Kd + kd], clamp));
    }
    __syncthreads();

    // 5. scores: strictly lower q_eff . k_eff, the diagonal term, zeros
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

    // 6. y = scores . v + q_eff . S; k_s (free since 5) takes k_rem
    for (int i = tid; i < L * Vd; i += kThreads) {
      const int r = i / Vd;
      const int dv = i - r * Vd;
      const int t = t0 + r;
      float y_intra = 0.f;
      for (int j = 0; j <= r; ++j)
        y_intra = fmaf(sc_s[r * L + j], v_s[j * Vd + dv], y_intra);
      float y_inter = 0.f;
      for (int kk = 0; kk < K; ++kk)
        y_inter = fmaf(q_s[r * Kp + kk], st_s[kk * Vd + dv], y_inter);
      if (t < S) store(ob + (size_t)t * H * Vd + dv, y_intra + y_inter);
    }
    for (int i = tid; i < L * K; i += kThreads) {
      const int j = i / K;
      const int kk = i - j * K;
      const int kd = Kd == 1 ? 0 : kk;
      const int t = t0 + j;
      const float kraw = t < S ? to_f32(kb[t * sk.t + kk]) : 0.f;
      k_s[j * Kp + kk] =
          kraw * expf(cl_s[(L - 1) * Kd + kd] - cl_s[j * Kd + kd]);
    }
    __syncthreads();

    // 7. S = S exp(cl_end) + k_rem^T v
    for (int i = tid; i < K * Vd; i += kThreads) {
      const int kk = i / Vd;
      const int dv = i - kk * Vd;
      const int kd = Kd == 1 ? 0 : kk;
      float x = 0.f;
      for (int j = 0; j < L; ++j)
        x = fmaf(k_s[j * Kp + kk], v_s[j * Vd + dv], x);
      st_s[i] = st_s[i] * expf(cl_s[(L - 1) * Kd + kd]) + x;
    }
  }
  __syncthreads();
  float* so = state_out + (size_t)blockIdx.x * K * Vd;
  for (int i = tid; i < K * Vd; i += kThreads) so[i] = st_s[i];
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const float* ld,
           const float* bonus, void* out, float* state, int B, int S, int H,
           int K, int Vd, int Kd, int L, float clamp, Strides sq, Strides sk,
           Strides sv, Strides sl, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {  // above the default limit only: a host call
    cudaError_t err = cudaFuncSetAttribute(
        linear_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  linear_scan_kernel<T><<<B * H, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), ld, bonus, static_cast<T*>(out), state, S, H,
      K, Vd, Kd, L, clamp, sq, sk, sv, sl);
  return (int)cudaGetLastError();
}

// Shared memory one block needs, in bytes (kernels/linear_scan.py checks
// the same sum against the card's limit before it launches).
size_t smem_bytes(int K, int Vd, int Kd, int L, bool has_bonus) {
  const size_t Kp = K | 1;
  return sizeof(float) *
         (2 * L * Kp + (size_t)L * Vd + (has_bonus ? 2 : 1) * (size_t)L * Kd +
          (size_t)L * L + L + (size_t)K * Vd + K);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out); ld and bonus are
// float32, bonus may be null; strides are in elements.
extern "C" int linear_scan_launch(
    int dtype, const void* q, const void* k, const void* v, const void* ld,
    const void* bonus, void* out, void* state, int B, int S, int H, int K,
    int Vd, int Kd, int L, float clamp, long long sqb, long long sqt,
    long long sqh, long long skb, long long skt, long long skh, long long svb,
    long long svt, long long svh, long long slb, long long slt,
    long long slh, void* stream) {
  if (B == 0 || H == 0) return 0;
  const size_t smem = smem_bytes(K, Vd, Kd, L, bonus != nullptr);
  const Strides sq{sqb, sqt, sqh}, sk{skb, skt, skh}, sv{svb, svt, svh},
      sl{slb, slt, slh};
  const float* ldf = static_cast<const float*>(ld);
  const float* uf = static_cast<const float*>(bonus);
  float* st = static_cast<float*>(state);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, ldf, uf, out, st, B, S, H, K, Vd, Kd, L,
                         clamp, sq, sk, sv, sl, smem, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, ldf, uf, out, st, B, S, H, K, Vd,
                                 Kd, L, clamp, sq, sk, sv, sl, smem, s);
  return (int)cudaErrorInvalidValue;
}
