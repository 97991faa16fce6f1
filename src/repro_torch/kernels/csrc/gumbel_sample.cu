// Gumbel-max sampling of one decode iteration: for each row r,
//   tok[r] = argmax_j ( logits[r, j] / T + gumbel(key[r], j) ),
// with nothing of size rows x vocab ever written to device memory.
//
// Replaces the sampler's device part, which the JAX package leaves to XLA
// (no Pallas kernel):
//   src/repro/serving/sampler.py::sample_tokens_rowwise
// (jax.random.categorical per row key, fused by XLA).  The port's plain
// version is serving/sampler.py's gumbel_argmax, and this kernel gives
// its tokens bit for bit: the same threefry2x32 bits (key words of row r,
// counters (0, j), bits y0 ^ y1), the same uniform
// (bitcast((bits >> 9) | 0x3f800000) - 1, plus tiny, clamped at tiny),
// the same noise -log(-log(u)) with each log taken as the plain version's
// _log takes it (frexp, then log1p(m - 1) + e * ln 2 in float64, rounded
// once to float32), and the logit scaled as torch scales a float32 CUDA
// tensor by a Python scalar (times the float32 reciprocal 1 / T, which
// the wrapper passes).  Every operation the plain version rounds on its
// own is written with an explicit rounding intrinsic (__fmul_rn,
// __fadd_rn, __dmul_rn, __dadd_rn), so nvcc cannot contract two of them
// into one FMA.  The argmax is torch.argmax's: NaN counts as the largest
// value, and of equal values the lowest column wins.
//
// Bound on the H100: the ALU, not the bytes.  Per element the kernel
// reads 2 (bf16) or 4 (fp32) bytes once and runs ~75 int32 operations of
// threefry (20 rounds of add, funnel-shift rotate and xor, 5 key
// injections) and two float64 log1p's with their frexp, conversions and
// float64 multiply-add; at 256 x 152064 bf16 the 78 MB of logits take
// 0.023 ms at 3.35 TB/s and the integer and float64 pipes ~0.2 ms each.
//
// Design (two launches on one stream):
//
//  1. Draw pass, grid (column chunk, row).  The wrapper picks the chunk
//     (a multiple of 8 columns, at most 4096) from the rows and the vocab
//     so that the grid holds several CTAs per SM whether 256 rows, 128
//     rows or the few rows of a window's end are sampled.  Each thread
//     keeps a running (value, column) in registers: it reads its
//     columns as 16-byte vectors (8 bf16 or 4 fp32 logits) and the
//     ragged columns before the chunk's first 16-byte boundary and after
//     its last one one at a time, and for every element computes the
//     bits, the noise and the perturbed logit in registers.  A warp
//     shuffle and one shared-memory step reduce the CTA's 256 threads to
//     one (value, column), written to scratch the wrapper allocated (or
//     straight to the output when the row is one chunk).
//  2. Merge pass, one warp per row: the row's chunk partials reduced to
//     its token, written as int32.
//  The comparison is a total order on (value, column) pairs, so the
//  result does not depend on the order of the reductions: two launches
//  on the same inputs agree bit for bit, and no atomics are used.
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

#define GS_THREADS 256
#define GS_WARPS (GS_THREADS / 32)
#define MERGE_WARPS 8

// the plain version's constants: jax's key parity, float32 tiny (the
// uniform's lower end) and Python's float(np.log(2.0))
#define KEY_PARITY 0x1BD11BDAu
#define TINY_F 1.17549435082228750797e-38f
#define LN2_D 0x1.62e42fefa39efp-1

// threefry2x32 under key (k0, k1, k2 = k0 ^ k1 ^ parity) of counters
// (0, j), returned as y0 ^ y1 (jax.random.bits).
#define TF_MIX(r)                         \
  x0 += x1;                               \
  x1 = __funnelshift_l(x1, x1, r) ^ x0;
#define TF_FOUR(a, b, c, d) TF_MIX(a) TF_MIX(b) TF_MIX(c) TF_MIX(d)

__device__ __forceinline__ unsigned threefry_bits(unsigned k0, unsigned k1,
                                                  unsigned k2, unsigned j) {
  unsigned x0 = k0, x1 = j + k1;
  TF_FOUR(13, 15, 26, 6)
  x0 += k1; x1 += k2 + 1u;
  TF_FOUR(17, 29, 16, 24)
  x0 += k2; x1 += k0 + 2u;
  TF_FOUR(13, 15, 26, 6)
  x0 += k0; x1 += k1 + 3u;
  TF_FOUR(17, 29, 16, 24)
  x0 += k1; x1 += k2 + 4u;
  TF_FOUR(13, 15, 26, 6)
  x0 += k2; x1 += k0 + 5u;
  return x0 ^ x1;
}

// sampler._log: x = m * 2**e with m in [0.5, 1); log1p(m - 1) + e * ln 2
// summed in float64 (each step rounded, as the plain version's separate
// kernels round), then rounded once to float32.
__device__ __forceinline__ float log_f64(float x) {
  int e;
  const float m = frexpf(x, &e);
  const double l = __dadd_rn(log1p(__dsub_rn((double)m, 1.0)),
                             __dmul_rn((double)e, LN2_D));
  return __double2float_rn(l);
}

// logits[r, j] / T + gumbel(key[r], j), as the plain version rounds it.
__device__ __forceinline__ float perturbed(float x, unsigned k0, unsigned k1,
                                           unsigned k2, unsigned j,
                                           float inv_t) {
  const unsigned bits = threefry_bits(k0, k1, k2, j);
  const float f = __fsub_rn(__uint_as_float((bits >> 9) | 0x3f800000u), 1.f);
  // u * (1 - tiny) + tiny: (1 - tiny) rounds to 1, so the product is u
  const float u = fmaxf(__fadd_rn(f, TINY_F), TINY_F);
  const float g = -log_f64(-log_f64(u));
  return __fadd_rn(__fmul_rn(x, inv_t), g);
}

// (va, ia) comes before (vb, ib) in torch.argmax's order: NaN above every
// number, then the larger value, then the lower column.
__device__ __forceinline__ bool beats(float va, int ia, float vb, int ib) {
  if (isnan(va)) return !isnan(vb) || ia < ib;
  if (isnan(vb)) return false;
  return va == vb ? ia < ib : va > vb;
}

__device__ __forceinline__ void warp_best(float& v, int& i) {
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, v, o);
    const int oi = __shfl_down_sync(0xffffffffu, i, o);
    if (beats(ov, oi, v, i)) { v = ov; i = oi; }
  }
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// the E logits of one 16-byte vector, widened exactly to float32
__device__ __forceinline__ void unpack(const uint4 raw, float (&x)[4]) {
  x[0] = __uint_as_float(raw.x);
  x[1] = __uint_as_float(raw.y);
  x[2] = __uint_as_float(raw.z);
  x[3] = __uint_as_float(raw.w);
}
__device__ __forceinline__ void unpack(const uint4 raw, float (&x)[8]) {
  const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

template <typename T>
__global__ void __launch_bounds__(GS_THREADS) gumbel_sample_kernel(
    const T* __restrict__ logits,          // (R, V)
    const unsigned* __restrict__ keys,     // (R, 2) key words
    float* __restrict__ part_val,          // (R, n_chunks)
    int* __restrict__ part_idx,            // (R, n_chunks)
    int* __restrict__ out,                 // (R,) when n_chunks == 1
    int V, int chunk, int n_chunks, float inv_t) {
  constexpr int E = 16 / (int)sizeof(T);   // logits per 16-byte vector
  const int c = blockIdx.x, r = blockIdx.y, tid = threadIdx.x;
  const unsigned k0 = keys[2 * r], k1 = keys[2 * r + 1];
  const unsigned k2 = k0 ^ k1 ^ KEY_PARITY;
  const T* row = logits + (size_t)r * V;
  const int c0 = c * chunk, c1 = min(V, c0 + chunk);
  // [c0, a) before the first 16-byte boundary, [a, b) whole vectors,
  // [b, c1) after the last one
  const int mis = (int)(((uintptr_t)(row + c0) & 15) / sizeof(T));
  const int a = min(c1, c0 + (mis ? E - mis : 0));
  const int b = a + (c1 - a) / E * E;
  float best = -INFINITY;
  int bi = INT_MAX;
  for (int j = c0 + tid; j < a; j += GS_THREADS) {
    const float v = perturbed(to_f32(row[j]), k0, k1, k2, j, inv_t);
    if (beats(v, j, best, bi)) { best = v; bi = j; }
  }
  for (int j0 = a + tid * E; j0 < b; j0 += GS_THREADS * E) {
    float x[E];
    unpack(*reinterpret_cast<const uint4*>(row + j0), x);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const float v = perturbed(x[e], k0, k1, k2, j0 + e, inv_t);
      if (beats(v, j0 + e, best, bi)) { best = v; bi = j0 + e; }
    }
  }
  for (int j = b + tid; j < c1; j += GS_THREADS) {
    const float v = perturbed(to_f32(row[j]), k0, k1, k2, j, inv_t);
    if (beats(v, j, best, bi)) { best = v; bi = j; }
  }
  __shared__ float s_val[GS_WARPS];
  __shared__ int s_idx[GS_WARPS];
  const int warp = tid >> 5, lane = tid & 31;
  warp_best(best, bi);
  if (lane == 0) { s_val[warp] = best; s_idx[warp] = bi; }
  __syncthreads();
  if (warp == 0) {
    best = lane < GS_WARPS ? s_val[lane] : -INFINITY;
    bi = lane < GS_WARPS ? s_idx[lane] : INT_MAX;
    warp_best(best, bi);
    if (lane == 0) {
      if (n_chunks == 1) {
        out[r] = bi;
      } else {
        part_val[(size_t)r * n_chunks + c] = best;
        part_idx[(size_t)r * n_chunks + c] = bi;
      }
    }
  }
}

__global__ void __launch_bounds__(MERGE_WARPS * 32) gumbel_merge_kernel(
    const float* __restrict__ part_val, const int* __restrict__ part_idx,
    int* __restrict__ out, int R, int n_chunks) {
  const int r = blockIdx.x * MERGE_WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= R) return;
  float best = -INFINITY;
  int bi = INT_MAX;
  for (int c = lane; c < n_chunks; c += 32) {
    const float v = part_val[(size_t)r * n_chunks + c];
    const int i = part_idx[(size_t)r * n_chunks + c];
    if (beats(v, i, best, bi)) { best = v; bi = i; }
  }
  warp_best(best, bi);
  if (lane == 0) out[r] = bi;
}

template <typename T>
static int launch(const void* logits, const void* keys, void* out,
                  void* part_val, void* part_idx, int R, int V, int chunk,
                  int n_chunks, float inv_t, cudaStream_t st) {
  gumbel_sample_kernel<T><<<dim3(n_chunks, R), GS_THREADS, 0, st>>>(
      (const T*)logits, (const unsigned*)keys, (float*)part_val,
      (int*)part_idx, (int*)out, V, chunk, n_chunks, inv_t);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || n_chunks == 1) return (int)e;
  gumbel_merge_kernel<<<(R + MERGE_WARPS - 1) / MERGE_WARPS,
                        MERGE_WARPS * 32, 0, st>>>(
      (const float*)part_val, (const int*)part_idx, (int*)out, R, n_chunks);
  return (int)cudaGetLastError();
}

// logits (R, V) float32 or bfloat16, keys (R, 2) uint32 words, out (R,)
// int32; part_val / part_idx (R, n_chunks) scratch, unused when
// n_chunks is 1.  chunk must be a positive multiple of 8 with
// n_chunks = ceil(V / chunk); inv_t is the float32 1 / T.
extern "C" int gumbel_sample_launch(const void* logits, const void* keys,
                                    void* out, void* part_val,
                                    void* part_idx, int R, int V, int chunk,
                                    int n_chunks, float inv_t, int dtype,
                                    void* stream) {
  if (R == 0) return 0;
  if (R < 0 || R > 65535 || V < 1 || chunk < 8 || chunk % 8 ||
      n_chunks != (V + chunk - 1) / chunk)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == DTYPE_BF16)
    return launch<__nv_bfloat16>(logits, keys, out, part_val, part_idx, R, V,
                                 chunk, n_chunks, inv_t, st);
  return launch<float>(logits, keys, out, part_val, part_idx, R, V, chunk,
                       n_chunks, inv_t, st);
}
