// Token scatter into the paged K/V pool for Hopper (sm_90a), bound through
// a plain C interface (kernels/paged_attention.py loads it with ctypes).
//
// Replaces the Pallas TPU kernel paged_scatter_pallas
// (src/repro/kernels/paged_attention.py:176, body _scatter_kernel at :170):
// pages[blk[t], slot[t]] = vals[t], in place, O(tokens) moved.  One launch
// writes K and V together, for one layer or for all L layers of the
// store's (L, P, page, Hkv, D) tensors.
//
// What bounds it on the card: bytes.  It reads 2 * nL * T rows of
// Hkv * D elements and writes as many, against 3.35 TB/s.  What the design
// does about it: one block per (token, layer), whose threads copy the row
// in 16-byte vectors, neighbouring threads on neighbouring addresses, so
// every load and store is a full coalesced transaction.  The copy is of
// bytes, so the result is bit-identical to index_put_ for any element
// type; the caller casts the values to the pages' dtype first.
//
// Where it runs: every write that no attention follows -- write_prefill
// with layer=None after a full-sequence prefill, append_token(s), and the
// plain paths of the tests.  A decode step's and a prefill chunk's
// per-layer write on device storage is not this kernel's: it is folded
// into that layer's paged attention launch (csrc/paged_attention.cu), which
// removes the launch.  No further device change serves what stays here:
// the copy is already coalesced 16-byte vectors, a few KB a token, and
// its cost on the card is the launch, not the bytes.
//
// The wrapper checks on the host what the kernel relies on: contiguous
// tensors, 16-byte aligned base pointers, a row size that is a multiple of
// 16 bytes, block ids in [0, P) and slots in [0, page).  The launch goes
// on the caller's stream, allocates nothing and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;

__global__ void __launch_bounds__(kThreads) paged_scatter_kernel(
    uint4* __restrict__ k_pages,          // (L, P, page, Hkv, D)
    uint4* __restrict__ v_pages,
    const uint4* __restrict__ k_vals,     // (nL, T, Hkv, D)
    const uint4* __restrict__ v_vals,
    const int32_t* __restrict__ blk,      // (T,)
    const int32_t* __restrict__ slot,     // (T,)
    int layer0, int P, int page, int T, int row_vecs) {
  const int t = blockIdx.x;
  const int l = blockIdx.y;
  const size_t dst =
      (((size_t)(layer0 + l) * P + blk[t]) * page + slot[t]) * row_vecs;
  const size_t src = ((size_t)l * T + t) * row_vecs;
  for (int i = threadIdx.x; i < row_vecs; i += blockDim.x) {
    k_pages[dst + i] = k_vals[src + i];
    v_pages[dst + i] = v_vals[src + i];
  }
}

}  // namespace

// Writes layers layer0 .. layer0 + n_layers - 1; row_bytes = Hkv * D *
// element size.
extern "C" int paged_scatter_launch(void* k_pages, void* v_pages,
                                    const void* k_vals, const void* v_vals,
                                    const void* blk, const void* slot,
                                    int layer0, int n_layers, int P, int page,
                                    int T, int row_bytes, void* stream) {
  if (T == 0 || n_layers == 0) return 0;
  if (row_bytes % 16 != 0) return (int)cudaErrorInvalidValue;
  dim3 grid(T, n_layers);
  paged_scatter_kernel<<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint4*>(k_pages), static_cast<uint4*>(v_pages),
      static_cast<const uint4*>(k_vals), static_cast<const uint4*>(v_vals),
      static_cast<const int32_t*>(blk), static_cast<const int32_t*>(slot),
      layer0, P, page, T, row_bytes / 16);
  return (int)cudaGetLastError();
}
