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
// product with l summing the unrounded P, l floored at 1e-30, output
// rounded once to q's dtype.
//
// What bounds it on the card: at prefill lengths the work is
// 2 * (D + Dv) flops per unmasked (query, key, head) triple -- far above
// the card's bytes-per-flop line -- so the operations bound it.
//
// bf16 (flash_bf16_kernel): FlashAttention-2 on the tensor cores.
//   * one block of 4 warps per (batch x kv head, 64 or 128 packed rows),
//     each warp owning 16 or 32 rows (one or two m-tiles: two where the
//     registers allow, so each K / V fragment read from shared memory feeds
//     two products); the row blocks of one (batch, kv head) are launched
//     together, so its K / V come from L2 after the first read, heaviest
//     first (the last rows under causal masking);
//   * Q is copied once into shared memory and kept in registers as the A
//     fragments of mma.sync.m16n8k16 (bf16 in, f32 accumulate), read with
//     ldmatrix;
//   * K and V tiles of 64 keys are double-buffered in shared memory with
//     cp.async: tile t + 1 is in flight while tile t is computed, and one
//     __syncthreads a tile both publishes tile t and frees the buffer the
//     next copy overwrites;
//   * rows are padded by 16 bytes (stride = an odd number of 16-byte
//     units), so the 8 rows of each ldmatrix phase hit distinct banks for
//     any D; D and Dv are padded to multiples of 16 with zeros, which add
//     nothing to either product;
//   * S = Q K^T in f32 registers; scale, softcap and the mask run on the
//     accumulator fragments, the mask only on tiles that cross the
//     diagonal, the window edge or the end of the keys; scores are kept in
//     log2 units so each exponential is one ex2; the softcap's tanh is
//     taken through one ex2 as well; the row max and sum reduce over the 4
//     threads of a quad with shuffles;
//   * P is rounded to bf16 in registers straight into the A fragments of
//     the P V product (the S accumulator layout of m16n8k16 is the A
//     layout of the next k-step), V read through ldmatrix.trans: P never
//     touches shared memory;
//   * tiles wholly above the diagonal or wholly below the window are never
//     loaded; a warp skips the products of a tile that masks all its rows.
//   The fragment arrays are sized by template (m-tiles, D / 16 and
//   Dv / 16 steps).  The head dims the repo's models use (64, 80, 128,
//   192 / 128) get exact instantiations, whose steps are unguarded so the
//   compiler can hoist each step's ldmatrix above the previous step's
//   mma; any other D up to 256 and Dv up to 128 takes a guarded one.  Blocks copy their K / V rows
//   with a per-thread walk worked out once, a few adds per copy.
//   Not yet: wgmma with TMA and a producer warp (the card's full rate).
//
// float32 (flash_f32_kernel): the TPU kernel's f32 products are full f32,
// which TF32 tensor cores would not reproduce within 2e-5, so f32 stays on
// the CUDA cores: 256 threads each hold a 4 x 4 block of scores and 4 rows
// of the accumulator; Q, K, V and P go through shared memory.
//
// q_offset: the absolute position of q's first row, so query row s sits at
// s + q_offset against keys 0..Sk-1 in the causal and window masks (a
// context-parallel shard's slice of the sequence); 0 aligns q[0] with k[0].
//
// The launch goes on the caller's stream, allocates nothing and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kRows = 64;  // f32: packed (query, head) rows per block
constexpr int kCols = 64;  // keys per kv tile

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kF32Threads = 256;  // 16 x 16: tx over columns, ty over rows
constexpr int kMaxDv = 128;       // 8 accumulator columns of 16 per row
constexpr int kPs = kCols + 16;   // P row stride: rows ty and ty + 1 of a
                                  // warp land 16 banks apart

__global__ void __launch_bounds__(kF32Threads) flash_f32_kernel(
    const float* __restrict__ q,  // (B, Sq, H, D)
    const float* __restrict__ k,  // (B, Sk, Hkv, D)
    const float* __restrict__ v,  // (B, Sk, Hkv, Dv)
    float* __restrict__ out,      // (B, Sq, H, Dv)
    int Sq, int Sk, int H, int Hkv, int D, int Dv, float scale,
    float softcap, int causal, int window, int q_offset) {
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
  float* q_s = smem;              // (kRows, Dp)
  float* k_s = q_s + kRows * Dp;  // (kCols, Dp)
  float* v_s = k_s + kCols * Dp;  // (kCols, Dv)
  float* p_s = v_s + kCols * Dv;  // (kRows, kPs)

  for (int i = tid; i < kRows * D; i += kF32Threads) {
    const int rr = i / D;
    const int d = i - rr * D;
    const int row = r0 + rr;
    float x = 0.f;
    if (row < n_rows) {
      const int s = row / G;
      const int g = row - s * G;
      x = q[(((size_t)b * Sq + s) * H + h * G + g) * D + d];
    }
    q_s[rr * Dp + d] = x;
  }

  // the kv tiles some row of this block can see (absolute positions)
  const int q_first = r0 / G + q_offset;
  const int q_last = min(Sq - 1, (r0 + kRows - 1) / G) + q_offset;
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
    for (int i = tid; i < kCols * D; i += kF32Threads) {
      const int j = i / D;
      const int d = i - j * D;
      const int key = c0 + j;
      k_s[j * Dp + d] =
          key < Sk ? k[(((size_t)b * Sk + key) * Hkv + h) * D + d] : 0.f;
    }
    for (int i = tid; i < kCols * Dv; i += kF32Threads) {
      const int j = i / Dv;
      const int d = i - j * Dv;
      const int key = c0 + j;
      v_s[i] = key < Sk ? v[(((size_t)b * Sk + key) * Hkv + h) * Dv + d]
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
      const int qpos = (r0 + ty + 16 * i) / G + q_offset;
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
        p_s[(ty + 16 * i) * kPs + tx + 16 * j] = p;
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
    float* o = out + (((size_t)b * Sq + s) * H + h * G + g) * Dv;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < kMaxDv / 16; ++c) {
      const int dv = tx + 16 * c;
      if (c < nc && dv < Dv) o[dv] = acc[i][c] / denom;
    }
  }
}

int launch_f32(const float* q, const float* k, const float* v, float* out,
               int B, int Sq, int Sk, int H, int Hkv, int D, int Dv,
               float scale, float softcap, int causal, int window,
               int q_offset, cudaStream_t stream) {
  const int Dp = D | 1;
  const size_t smem =
      sizeof(float) * ((size_t)kRows * Dp + (size_t)kCols * Dp +
                       (size_t)kCols * Dv + (size_t)kRows * kPs);
  if (smem > 48 * 1024) {  // above the default limit only: a host call
    cudaError_t err = cudaFuncSetAttribute(
        flash_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int G = H / Hkv;
  dim3 grid((Sq * G + kRows - 1) / kRows, B * Hkv);
  flash_f32_kernel<<<grid, kF32Threads, smem, stream>>>(
      q, k, v, out, Sq, Sk, H, Hkv, D, Dv, scale, softcap, causal, window,
      q_offset);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores (mma.sync), cp.async double buffering
// ---------------------------------------------------------------------------

constexpr int kWarps = 4;  // 16 packed rows each
constexpr int kBf16Threads = 32 * kWarps;
// K / V tiles in shared memory: tile t + 1 lands while tile t is computed
// (a third stage measured slower: it costs a block of occupancy)
constexpr int kStages = 2;

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
// wait until at most N of this thread's copy groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
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

// Fill the n rows of a (n, stride) bf16 tile in shared memory, columns
// [0, cols_p) (cols_p a multiple of 16), from source rows of `cols`
// elements; src(r) gives row r's start or nullptr for a zero row.  vec:
// 16-byte cp.async (cols % 8 == 0, 16-byte aligned rows), where a zero
// chunk names `base`, a valid global address it does not read; else plain
// element copies, which the caller's barrier orders.  The thread's (row,
// column) walk steps without a division.
template <typename Src>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, int stride,
                                          int n, int cols, int cols_p,
                                          bool vec,
                                          const __nv_bfloat16* base, Src src) {
  const int unit = vec ? 8 : 1;        // elements a copy moves
  const int per_row = cols_p / unit;
  const int dr = kBf16Threads / per_row;
  const int dc = (kBf16Threads - dr * per_row) * unit;
  int r = threadIdx.x / per_row;
  int c = (threadIdx.x - r * per_row) * unit;
  for (; r < n; r += dr, c += dc) {
    if (c >= cols_p) {
      c -= cols_p;
      ++r;
      if (r >= n) break;
    }
    const __nv_bfloat16* row = src(r);
    const bool ok = row != nullptr && c < cols;
    if (vec)
      cp_async_16(smem_u32(dst + r * stride + c), ok ? row + c : base,
                  ok ? 16 : 0);
    else
      dst[r * stride + c] = ok ? row[c] : __float2bfloat16(0.f);
  }
}

// One thread's share of a K or V tile copy with 16-byte cp.async: the
// lanes of a row (a power of two of them, at least its 16-byte chunks)
// take one chunk each, and a thread steps down the tile by the rows the
// block covers at once.  Worked out once per block, so a tile costs each
// thread a few adds per copy.
struct TileCopy {
  int chunk;      // the thread's 16-byte chunk of a row
  int row;        // its first row of the tile
  int rows_step;  // rows between its copies
  bool active;    // chunk < cols_p / 8
  bool data;      // chunk < cols / 8; else a chunk of zero padding
};

__device__ __forceinline__ TileCopy make_copy(int cols, int cols_p) {
  const int per_row = cols_p / 8;
  int lanes = 1;
  while (lanes < per_row) lanes <<= 1;
  TileCopy c;
  c.chunk = threadIdx.x & (lanes - 1);
  c.row = threadIdx.x / lanes;
  c.rows_step = kBf16Threads / lanes;
  c.active = c.chunk < per_row;
  c.data = c.chunk * 8 < cols;
  return c;
}

// rows [0, kCols) of a tile whose row 0 starts at src, rows `ld` elements
// apart; rows from n_valid on and padding chunks are zero-filled (their
// copies name `base`, a valid address they do not read)
__device__ __forceinline__ void copy_tile(const TileCopy& c,
                                          __nv_bfloat16* dst, int stride,
                                          const __nv_bfloat16* src, size_t ld,
                                          int n_valid,
                                          const __nv_bfloat16* base) {
  if (!c.active) return;
  uint32_t d = smem_u32(dst + c.row * stride + c.chunk * 8);
  const uint32_t d_step = c.rows_step * stride * sizeof(__nv_bfloat16);
  const __nv_bfloat16* s = src + c.row * ld + c.chunk * 8;
  const size_t s_step = c.rows_step * ld;
  for (int r = c.row; r < kCols; r += c.rows_step, d += d_step, s += s_step) {
    const bool ok = c.data && r < n_valid;
    cp_async_16(d, ok ? s : base, ok ? 16 : 0);
  }
}

// 2^x on the special-function unit (flushes results below 2^-126 to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// cap * tanh(x / cap) through one ex2 and a fast divide: within ~1e-6 of
// tanhf relative to cap, far inside bf16's 2e-2 (the f32 kernel keeps tanhf)
__device__ __forceinline__ float softcap_fast(float x, float cap) {
  const float e = ex2(x * (2.f * kLog2e / cap));
  return cap - __fdividef(2.f * cap, 1.f + e);
}

// MT: 16-row m-tiles per warp (a block holds 4 * 16 * MT packed rows);
// KD: D / 16 steps of the Q K^T product held in registers (at most);
// KV: Dv / 16 column pairs of the accumulator (at most);
// EXACT: D and Dv pad to exactly KD and KV steps, so no step is guarded and
// the compiler may hoist the next step's ldmatrix above this step's mma.
template <int MT, int KD, int KV, bool EXACT>
__global__ void __launch_bounds__(kBf16Threads) flash_bf16_kernel(
    const __nv_bfloat16* __restrict__ q,  // (B, Sq, H, D)
    const __nv_bfloat16* __restrict__ k,  // (B, Sk, Hkv, D)
    const __nv_bfloat16* __restrict__ v,  // (B, Sk, Hkv, Dv)
    __nv_bfloat16* __restrict__ out,      // (B, Sq, H, Dv)
    int Sq, int Sk, int H, int Hkv, int D, int Dv, float scale,
    float softcap, int causal, int window, int q_offset, int vec) {
  constexpr int kBlockRows = kWarps * 16 * MT;
  const int G = H / Hkv;
  const int b = blockIdx.y / Hkv;
  const int h = blockIdx.y - b * Hkv;
  // the row blocks of one (batch, kv head) run together, so its K / V
  // tiles are read from device memory about once and then from L2; among
  // them the heaviest go first (under causal masking the last rows see the
  // most tiles)
  const int rb = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int r0 = rb * kBlockRows;
  const int n_rows = Sq * G;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gid = lane >> 2;  // the fragment row of this thread
  const int tig = lane & 3;   // its column pair
  const int Dp = (D + 15) & ~15;
  const int Dvp = (Dv + 15) & ~15;
  const int nkd = EXACT ? KD : Dp / 16;
  const int nvd = EXACT ? KV : Dvp / 16;
  const int qs = Dp + 8;  // row strides: an odd number of 16-byte units
  const int vs = Dvp + 8;
  // scores are kept in log2 units: s * scale * log2(e), or the softcapped
  // score times log2(e); masked -1e30 either way
  const float s_mul = scale * kLog2e;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* k_s = q_s + kBlockRows * qs;  // q: (kBlockRows, qs)
  __nv_bfloat16* v_s = k_s + kStages * kCols * qs;  // k: stages x (kCols, qs)
                                                    // v: stages x (kCols, vs)

  // the kv tiles some row of this block can see (absolute positions)
  const int q_first = r0 / G + q_offset;
  const int q_last = min(Sq - 1, (r0 + kBlockRows - 1) / G) + q_offset;
  int t_lo = 0;
  int t_hi = (Sk + kCols - 1) / kCols - 1;
  if (causal) t_hi = min(t_hi, q_last / kCols);
  if (window > 0 && q_first - window + 1 > 0)
    t_lo = (q_first - window + 1) / kCols;

  // this warp's rows, and the positions of this thread's rows: m-tile mt,
  // fragment row gid (i = 0) and gid + 8 (i = 1)
  const int wr0 = r0 + warp * 16 * MT;
  const int w_first = wr0 / G + q_offset;
  const int w_last = min(Sq - 1, (wr0 + 16 * MT - 1) / G) + q_offset;
  int pos[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      pos[mt][i] = (wr0 + 16 * mt + gid + 8 * i) / G + q_offset;

  const size_t kv_row = (size_t)Hkv;  // rows of k / v between two keys
  const __nv_bfloat16* k_bh = k + ((size_t)b * Sk * Hkv + h) * D;
  const __nv_bfloat16* v_bh = v + ((size_t)b * Sk * Hkv + h) * Dv;

  const TileCopy k_copy = make_copy(D, Dp);
  const TileCopy v_copy = make_copy(Dv, Dvp);
  auto load_kv = [&](int t, int buf) {
    const int c0 = t * kCols;
    if (vec) {
      copy_tile(k_copy, k_s + buf * kCols * qs, qs, k_bh + c0 * kv_row * D,
                kv_row * D, Sk - c0, k);
      copy_tile(v_copy, v_s + buf * kCols * vs, vs, v_bh + c0 * kv_row * Dv,
                kv_row * Dv, Sk - c0, v);
      return;
    }
    load_tile(k_s + buf * kCols * qs, qs, kCols, D, Dp, vec, k,
              [&](int r) -> const __nv_bfloat16* {
                const int key = c0 + r;
                return key < Sk ? k_bh + key * kv_row * D : nullptr;
              });
    load_tile(v_s + buf * kCols * vs, vs, kCols, Dv, Dvp, vec, v,
              [&](int r) -> const __nv_bfloat16* {
                const int key = c0 + r;
                return key < Sk ? v_bh + key * kv_row * Dv : nullptr;
              });
  };

  load_tile(q_s, qs, kBlockRows, D, Dp, vec, q,
            [&](int r) -> const __nv_bfloat16* {
              const int row = r0 + r;
              if (row >= n_rows) return nullptr;
              const int s = row / G;
              return q + (((size_t)b * Sq + s) * H + h * G + (row - s * G)) *
                             D;
            });
  // Q and the first kStages - 1 tiles, one copy group each
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (t_lo + st <= t_hi) load_kv(t_lo + st, st);
    cp_async_commit();
  }

  uint32_t qf[MT][KD][4];
  float acc[MT][2 * KV][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 2 * KV; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;
  float m[MT][2], l[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m[mt][i] = kNegInf;
      l[mt][i] = 0.f;
    }

  for (int t = t_lo; t <= t_hi; ++t) {
    const int buf = (t - t_lo) % kStages;
    const int c0 = t * kCols;
    cp_async_wait<kStages - 2>();
    // tile t is visible to all, and every warp is done with tile t - 1,
    // whose buffer the next copy overwrites
    __syncthreads();
    if (t + kStages - 1 <= t_hi)
      load_kv(t + kStages - 1, (t - t_lo + kStages - 1) % kStages);
    cp_async_commit();
    if (t == t_lo) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const __nv_bfloat16* qw =
            q_s + (warp * 16 * MT + 16 * mt + (lane & 15)) * qs +
            (lane >> 4) * 8;
#pragma unroll
        for (int kk = 0; kk < KD; ++kk)
          if (kk < nkd)
            ldmatrix_x4(smem_u32(qw + kk * 16), qf[mt][kk][0],
                        qf[mt][kk][1], qf[mt][kk][2], qf[mt][kk][3]);
      }
    }
    // a tile that masks every row of this warp adds exactly nothing once
    // a live tile has set the row max (the row's own key is in a live tile)
    if (causal && c0 > w_last) continue;
    if (window > 0 && c0 + kCols - 1 <= w_first - window) continue;

    // S = Q K^T: 8 n-tiles of 8 keys, 4 f32 each (rows gid / gid + 8)
    float s[MT][8][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][j][e] = 0.f;
    const __nv_bfloat16* kt = k_s + buf * kCols * qs;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      if (kk < nkd) {
#pragma unroll
        for (int jp = 0; jp < 4; ++jp) {
          uint32_t b0, b1, b2, b3;
          ldmatrix_x4(smem_u32(kt + (jp * 16 + ((lane >> 4) << 3) +
                                     (lane & 7)) * qs +
                               kk * 16 + ((lane >> 3) & 1) * 8),
                      b0, b1, b2, b3);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16(s[mt][2 * jp], qf[mt][kk], b0, b1);
            mma_bf16(s[mt][2 * jp + 1], qf[mt][kk], b2, b3);
          }
        }
      }
    }

    const bool need_mask =
        c0 + kCols > Sk || (causal && c0 + kCols - 1 > w_first) ||
        (window > 0 && c0 <= w_last - window);
    if (softcap != 0.f) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[mt][j][e] = softcap_fast(s[mt][j][e] * scale, softcap) * kLog2e;
    } else {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[mt][j][e] *= s_mul;
    }
    if (need_mask) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = c0 + 8 * j + 2 * tig + (e & 1);
            const int p = pos[mt][e >> 1];
            bool ok = col < Sk;
            if (causal) ok = ok && col <= p;
            if (window > 0) ok = ok && col > p - window;
            if (!ok) s[mt][j][e] = kNegInf;
          }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      // online softmax over the quad that shares each row
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = kNegInf;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          mx = fmaxf(mx, fmaxf(s[mt][j][2 * i], s[mt][j][2 * i + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[mt][i], mx);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 2 * i; e < 2 * i + 2; ++e) {
            const float p = ex2(s[mt][j][e] - m_new);
            s[mt][j][e] = p;
            sum += p;
          }
        }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        const float corr = ex2(m[mt][i] - m_new);
        l[mt][i] = l[mt][i] * corr + sum;
        m[mt][i] = m_new;
#pragma unroll
        for (int j = 0; j < 2 * KV; ++j) {
          acc[mt][j][2 * i] *= corr;
          acc[mt][j][2 * i + 1] *= corr;
        }
      }
    }

    // acc += P V: P's bf16 A fragments straight from the S registers
    const __nv_bfloat16* vt = v_s + buf * kCols * vs;
#pragma unroll
    for (int ks = 0; ks < kCols / 16; ++ks) {
      uint32_t pa[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        pa[mt][0] = pack_bf16(s[mt][2 * ks][0], s[mt][2 * ks][1]);
        pa[mt][1] = pack_bf16(s[mt][2 * ks][2], s[mt][2 * ks][3]);
        pa[mt][2] = pack_bf16(s[mt][2 * ks + 1][0], s[mt][2 * ks + 1][1]);
        pa[mt][3] = pack_bf16(s[mt][2 * ks + 1][2], s[mt][2 * ks + 1][3]);
      }
#pragma unroll
      for (int jp = 0; jp < KV; ++jp) {
        if (jp < nvd) {
          uint32_t b0, b1, b2, b3;
          ldmatrix_x4_trans(
              smem_u32(vt + (ks * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) *
                                vs +
                       jp * 16 + (lane >> 4) * 8),
              b0, b1, b2, b3);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16(acc[mt][2 * jp], pa[mt], b0, b1);
            mma_bf16(acc[mt][2 * jp + 1], pa[mt], b2, b3);
          }
        }
      }
    }
  }
  cp_async_wait<0>();  // nothing of ours is in flight at exit

  // out = acc / l, rounded once
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = wr0 + 16 * mt + gid + 8 * i;
      if (row >= n_rows) continue;
      const int s = row / G;
      __nv_bfloat16* o =
          out + (((size_t)b * Sq + s) * H + h * G + (row - s * G)) * Dv;
      const float denom = fmaxf(l[mt][i], 1e-30f);
#pragma unroll
      for (int j = 0; j < 2 * KV; ++j) {
        const int dv = 8 * j + 2 * tig;
        if (j < 2 * nvd && dv < Dv) {
          const float x0 = acc[mt][j][2 * i] / denom;
          const float x1 = acc[mt][j][2 * i + 1] / denom;
          if (vec) {  // Dv % 8 == 0: dv + 1 < Dv, 4-byte aligned
            *reinterpret_cast<__nv_bfloat162*>(o + dv) =
                __floats2bfloat162_rn(x0, x1);
          } else {
            o[dv] = __float2bfloat16(x0);
            if (dv + 1 < Dv) o[dv + 1] = __float2bfloat16(x1);
          }
        }
      }
    }
  }
}

template <int MT, int KD, int KV, bool EXACT>
int launch_bf16_as(const __nv_bfloat16* q, const __nv_bfloat16* k,
                   const __nv_bfloat16* v, __nv_bfloat16* out, int B, int Sq,
                   int Sk, int H, int Hkv, int D, int Dv, float scale,
                   float softcap, int causal, int window, int q_offset,
                   int vec, cudaStream_t stream) {
  constexpr int kBlockRows = kWarps * 16 * MT;
  // the most this instantiation can ask for, set once (a host call)
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_bf16_kernel<MT, KD, KV, EXACT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(sizeof(__nv_bfloat16) *
            ((kBlockRows + kStages * kCols) * (16 * KD + 8) +
             kStages * kCols * (16 * KV + 8))));
  if (attr != cudaSuccess) return (int)attr;
  const int qs = ((D + 15) & ~15) + 8;
  const int vs = ((Dv + 15) & ~15) + 8;
  const size_t smem =
      sizeof(__nv_bfloat16) * ((size_t)(kBlockRows + kStages * kCols) * qs +
                               (size_t)kStages * kCols * vs);
  const int G = H / Hkv;
  dim3 grid((Sq * G + kBlockRows - 1) / kBlockRows, B * Hkv);
  flash_bf16_kernel<MT, KD, KV, EXACT>
      <<<grid, kBf16Threads, smem, stream>>>(
      q, k, v, out, Sq, Sk, H, Hkv, D, Dv, scale, softcap, causal, window,
      q_offset, vec);
  return (int)cudaGetLastError();
}

int launch_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                const __nv_bfloat16* v, __nv_bfloat16* out, int B, int Sq,
                int Sk, int H, int Hkv, int D, int Dv, float scale,
                float softcap, int causal, int window, int q_offset,
                cudaStream_t stream) {
  const int nkd = (D + 15) / 16;
  const int nvd = (Dv + 15) / 16;
  const uintptr_t bases = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v |
                          (uintptr_t)out;
  const int vec = D % 8 == 0 && Dv % 8 == 0 && bases % 16 == 0;
#define FLASH_BF16(MT, KD, KV, EXACT)                                      \
  return launch_bf16_as<MT, KD, KV, EXACT>(q, k, v, out, B, Sq, Sk, H, Hkv, \
                                           D, Dv, scale, softcap, causal,   \
                                           window, q_offset, vec, stream)
  // exact shapes of the configurations the repo runs: zamba2 (80), most
  // models (64, 128), MLA (192 / 128); two m-tiles a warp where the
  // registers allow it, so each K / V fragment read from shared memory
  // feeds two products
  if (nkd == 4 && nvd == 4) FLASH_BF16(2, 4, 4, true);
  if (nkd == 5 && nvd == 5) FLASH_BF16(2, 5, 5, true);
  if (nkd == 8 && nvd == 8) FLASH_BF16(1, 8, 8, true);
  if (nkd == 12 && nvd == 8) FLASH_BF16(1, 12, 8, true);
  // the rest, guarded
  if (nkd <= 4 && nvd <= 4) FLASH_BF16(2, 4, 4, false);
  if (nkd <= 8 && nvd <= 8) FLASH_BF16(1, 8, 8, false);
  if (nkd <= 16 && nvd <= 8) FLASH_BF16(1, 16, 8, false);
#undef FLASH_BF16
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out alike).
extern "C" int flash_attention_launch(int dtype, const void* q, const void* k,
                                      const void* v, void* out, int B, int Sq,
                                      int Sk, int H, int Hkv, int D, int Dv,
                                      float scale, float softcap, int causal,
                                      int window, int q_offset, void* stream) {
  if (B == 0 || Sq == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_f32(static_cast<const float*>(q),
                      static_cast<const float*>(k),
                      static_cast<const float*>(v), static_cast<float*>(out),
                      B, Sq, Sk, H, Hkv, D, Dv, scale, softcap, causal,
                      window, q_offset, s);
  if (dtype == 1)
    return launch_bf16(static_cast<const __nv_bfloat16*>(q),
                       static_cast<const __nv_bfloat16*>(k),
                       static_cast<const __nv_bfloat16*>(v),
                       static_cast<__nv_bfloat16*>(out), B, Sq, Sk, H, Hkv,
                       D, Dv, scale, softcap, causal, window, q_offset, s);
  return (int)cudaErrorInvalidValue;
}
