// Shared helpers of the attention kernels: element stores for the
// two storage types the wrappers pass (float32, bfloat16), products
// over 16-byte chunks and async copies.  Every kernel computes in
// float32.
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

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// d[0..3] += the products of one 16-byte chunk of a K row with the same
// chunk of q (four independent partial sums).
__device__ __forceinline__ void dot16(float (&d)[4], const uint4 k,
                                      const uint4 q, float) {
  d[0] = fmaf(__uint_as_float(k.x), __uint_as_float(q.x), d[0]);
  d[1] = fmaf(__uint_as_float(k.y), __uint_as_float(q.y), d[1]);
  d[2] = fmaf(__uint_as_float(k.z), __uint_as_float(q.z), d[2]);
  d[3] = fmaf(__uint_as_float(k.w), __uint_as_float(q.w), d[3]);
}
__device__ __forceinline__ void dot16(float (&d)[4], const uint4 k,
                                      const uint4 q, __nv_bfloat16) {
  const unsigned kw[4] = {k.x, k.y, k.z, k.w}, qw[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 kf = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&kw[i]));
    const float2 qf = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&qw[i]));
    d[i] = fmaf(kf.x, qf.x, fmaf(kf.y, qf.y, d[i]));
  }
}
// a[0 .. n) += p * one 16-byte chunk of a V row.
__device__ __forceinline__ void axpy16(float (&a)[4], const uint4 raw,
                                       float p) {
  a[0] = fmaf(p, __uint_as_float(raw.x), a[0]);
  a[1] = fmaf(p, __uint_as_float(raw.y), a[1]);
  a[2] = fmaf(p, __uint_as_float(raw.z), a[2]);
  a[3] = fmaf(p, __uint_as_float(raw.w), a[3]);
}
__device__ __forceinline__ void axpy16(float (&a)[8], const uint4 raw,
                                       float p) {
  const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    a[2 * i] = fmaf(p, f.x, a[2 * i]);
    a[2 * i + 1] = fmaf(p, f.y, a[2 * i + 1]);
  }
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

// The card's opt-in cap on dynamic shared memory per block, queried
// once per library.
static inline cudaError_t smem_optin(size_t* cap) {
  static int optin = 0;
  if (optin == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(
          &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e != cudaSuccess) return e;
  }
  *cap = (size_t)optin;
  return cudaSuccess;
}

// Combine pass of the split (flash-decoding) kernels, one warp per (row,
// query head): merges the row's non-empty splits in split order with
// log-sum-exp rescaling, no atomics, so two launches on the same inputs
// are bitwise equal; writes acc / max(l, 1e-30), zeros for a row with no
// non-empty split.  Partials: part_acc (n_splits, B, H, hd) and part_ml
// (n_splits, B, H, 2) in fp32.  A split is non-empty for row b where
// part_hit (n_splits, B) is non-zero, or, when part_hit is null, where
// its l is positive.  With n_live non-null only the first
// ceil(*n_live / pps) splits are merged (the split pass's CTAs past the
// device-side live count wrote nothing).  Lane t holds output dims t,
// t + 32, ... (hd <= 256).
#define COMBINE_WARPS 8

template <typename T>
__global__ void __launch_bounds__(COMBINE_WARPS * 32) split_combine_kernel(
    const float* __restrict__ part_acc, const float* __restrict__ part_ml,
    const unsigned char* __restrict__ part_hit, T* __restrict__ out, int B,
    int H, int hd, int n_splits, const int* __restrict__ n_live, int pps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int pair = blockIdx.x * COMBINE_WARPS + warp;   // b * H + h
  if (pair >= B * H) return;
  const int b = pair / H;
  if (n_live != nullptr)
    n_splits = min(n_splits, (max(*n_live, 0) + pps - 1) / pps);
  float m = NEG_INF_F, l = 0.f, a[8];
#pragma unroll
  for (int t = 0; t < 8; ++t) a[t] = 0.f;
  for (int sb = 0; sb < n_splits; sb += 32) {
    const int s = sb + lane;
    bool on = false;
    if (s < n_splits)
      on = part_hit ? part_hit[(size_t)s * B + b] != 0
                    : part_ml[((size_t)s * B * H + pair) * 2 + 1] > 0.f;
    unsigned bits = __ballot_sync(0xffffffffu, on);
    while (bits) {
      const size_t base = (size_t)(sb + __ffs(bits) - 1) * B * H + pair;
      bits &= bits - 1u;
      const float m_s = part_ml[base * 2], l_s = part_ml[base * 2 + 1];
      const float m_new = fmaxf(m, m_s);
      const float c_old = expf(m - m_new), c_new = expf(m_s - m_new);
      l = l * c_old + l_s * c_new;
      const float* src = part_acc + base * hd;
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int d = lane + 32 * t;
        if (d < hd) a[t] = a[t] * c_old + src[d] * c_new;
      }
      m = m_new;
    }
  }
  const float denom = fmaxf(l, L_MIN_F);
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    const int d = lane + 32 * t;
    if (d < hd) out[(size_t)pair * hd + d] = from_float<T>(a[t] / denom);
  }
}

template <typename T>
static cudaError_t launch_combine(const void* part_acc, const void* part_ml,
                                  const void* part_hit, void* out, int B,
                                  int H, int hd, int n_splits,
                                  cudaStream_t stream,
                                  const void* n_live = nullptr,
                                  int pps = 1) {
  split_combine_kernel<T><<<(B * H + COMBINE_WARPS - 1) / COMBINE_WARPS,
                            COMBINE_WARPS * 32, 0, stream>>>(
      (const float*)part_acc, (const float*)part_ml,
      (const unsigned char*)part_hit, (T*)out, B, H, hd, n_splits,
      (const int*)n_live, pps);
  return cudaGetLastError();
}

// Every kernel library exports the runtime's message for an error code,
// so the wrappers can raise with it.
extern "C" const char* cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
