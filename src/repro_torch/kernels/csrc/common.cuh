// Shared helpers of the attention kernels: element loads/stores for the
// two storage types the wrappers pass (float32, bfloat16) and warp-wide
// reductions.  Every kernel computes in float32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// Storage type codes shared with the Python wrappers (kernels/ops.py).
#define DTYPE_F32 0
#define DTYPE_BF16 1

// The reference kernels' masking constants: masked scores are -1e30 and
// the softmax denominator is clamped at 1e-30, so a row with no valid
// slot normalizes 0 / 1e-30 = 0 instead of NaN.
#define NEG_INF_F (-1e30f)
#define L_MIN_F (1e-30f)

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Asynchronous 16-byte global -> shared copies (sm_80+).  `src_bytes`
// below 16 zero-fills the rest of the destination (0 = all zeros, the
// source is then not read).  Both addresses must be 16-byte aligned.
__device__ __forceinline__ void cp_async16(void* smem_dst, const void* src,
                                           int src_bytes = 16) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem_dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Raise the dynamic shared-memory cap of `kernel` when a launch needs
// more than the default 48 KB.
template <typename K>
static cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// Every kernel library exports the runtime's message for an error code,
// so the wrappers can raise with it.
extern "C" const char* cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
