// Shared declarations for the DTM kernels.
//
// Each .cu file under csrc/ is built by nvcc into its own shared library
// with a plain C interface (no PyTorch headers) and loaded with ctypes.
// Every entry point launches on the stream it is given, allocates nothing,
// and returns cudaGetLastError() so the Python wrapper can raise on a
// refused launch.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

extern "C" const char* dtm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Bits of word w that hold real literals when a row has n_bits of them:
// include bits past n_bits are masked so they never veto a clause or make
// an empty clause look nonempty (the JAX package's ref.tail_mask_words).
__device__ __forceinline__ uint32_t dtm_tail_mask(int w, int n_bits) {
  const int keep = n_bits - 32 * w;
  if (keep >= 32) return 0xffffffffu;
  if (keep <= 0) return 0u;
  return (1u << keep) - 1u;
}

// cp.async copies of 4 or 16 bytes into shared memory; src_bytes < size
// zero-fills the rest (0: nothing is read).  4-byte copies go through L1
// (.ca), 16-byte copies bypass it (.cg).
__device__ __forceinline__ void dtm_cp_async4(void* dst, const void* src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void dtm_cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void dtm_cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most N of this thread's latest copy groups are pending
template <int N>
__device__ __forceinline__ void dtm_cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t dtm_warp_or(uint32_t v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v |= __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ int32_t dtm_warp_sum(int32_t v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}
