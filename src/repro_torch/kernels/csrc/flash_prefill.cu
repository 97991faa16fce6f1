// Causal flash attention for prefill (optional sliding window) over a
// right-padded prompt bucket.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_prefill.py::flash_prefill (body _kernel).
// Same contract: no length operand — prompts are right-padded, so with
// causal=1 every padded key lies in the future of every valid query;
// padded query rows compute finite values the caller discards.  The G
// query heads of a kv head are packed into the tile's rows, tiles wholly
// in the future or wholly before the window are skipped, and the
// softmax is an fp32 online softmax with masked scores at -1e30.
//
// Bound on the H100: the causal FLOPs, 4 * B * H * hd * S(S+1)/2 for
// the two products (fewer under a window), against the fp32 or bf16
// peak of the input type.
//
// Design: one CTA per (query tile, kv head, batch row).  Each of the
// CTA's threads owns one (query position, query head) row of the packed
// tile: its query and its output accumulator live in registers (hd
// floats each), and a tile of BK keys and values is staged in shared
// memory, read by all threads at the same address (a broadcast, no bank
// conflict); each row's scores for the tile sit in a shared column
// (ps[j][row], conflict-free), so only the hd-long loops unroll and the
// build stays seconds long.  The key loop starts at the window's first
// tile and ends at the tile holding the tile's last query.  This is a
// CUDA-core kernel; a wgmma/TMA version with bf16 operands is later
// work.  hd is 32 or 64 (the served models): at hd = 128 the two
// register rows would exceed the 255-register budget.
#include "common.cuh"

#define BK 32
#define ROWS 128

template <typename T, int HD>
__global__ void __launch_bounds__(ROWS) flash_prefill_kernel(
    const T* __restrict__ q,      // (B, S, H, hd)
    const T* __restrict__ k,      // (B, S, K, hd)
    const T* __restrict__ v,      // (B, S, K, hd)
    T* __restrict__ out,          // (B, S, H, hd)
    int S, int K, int G, int bq, int causal, int window, float scale) {
  const int qt = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int H = K * G;
  const int q_start = qt * bq;
  const int q_last = min(q_start + bq, S) - 1;
  __shared__ float ks[BK][HD];
  __shared__ float vs[BK][HD];
  __shared__ float ps[BK][ROWS];      // row r's scores, then probabilities

  const int r = threadIdx.x;
  const int qpos = q_start + r / G, g = r % G;
  const bool active = r < bq * G && qpos < S;
  float qr[HD], acc[HD];
  if (active) {
    const size_t off = (((size_t)b * S + qpos) * H + (size_t)kh * G + g) * HD;
#pragma unroll
    for (int d = 0; d < HD; ++d) qr[d] = to_float(q[off + d]);
  }
#pragma unroll
  for (int d = 0; d < HD; ++d) acc[d] = 0.f;
  float m = NEG_INF_F, l = 0.f;

  // key tiles: skip those wholly before the window / wholly in the future
  int k_begin = 0;
  if (window) k_begin = max(0, q_start - window + 1) / BK * BK;
  const int k_end = causal ? q_last + 1 : S;
  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    const int nk = min(BK, S - k0);
    for (int i = threadIdx.x; i < nk * HD; i += blockDim.x) {
      const int j = i / HD, d = i - j * HD;
      const size_t off = (((size_t)b * S + k0 + j) * K + kh) * HD + d;
      ks[j][d] = to_float(k[off]);
      vs[j][d] = to_float(v[off]);
    }
    __syncthreads();
    if (active) {
      unsigned ok_bits = 0u;                // bit j: key k0 + j is visible
      float m_cur = NEG_INF_F;
      for (int j = 0; j < nk; ++j) {
        const int kpos = k0 + j;
        bool ok = true;
        if (causal) ok = kpos <= qpos;
        if (window) ok = ok && kpos > qpos - window;
        float sc = NEG_INF_F;
        if (ok) {
          float dot = 0.f;
#pragma unroll
          for (int d = 0; d < HD; ++d) dot = fmaf(qr[d], ks[j][d], dot);
          sc = dot * scale;
          ok_bits |= 1u << j;
        }
        ps[j][r] = sc;
        m_cur = fmaxf(m_cur, sc);
      }
      const float m_new = fmaxf(m, m_cur);
      const float alpha = expf(m - m_new);
      float psum = 0.f;
      for (int j = 0; j < nk; ++j) {
        const float p = (ok_bits >> j) & 1u ? expf(ps[j][r] - m_new) : 0.f;
        ps[j][r] = p;
        psum += p;
      }
      l = alpha * l + psum;
#pragma unroll
      for (int d = 0; d < HD; ++d) acc[d] *= alpha;
      for (int j = 0; j < nk; ++j) {
        const float p = ps[j][r];
#pragma unroll
        for (int d = 0; d < HD; ++d) acc[d] = fmaf(p, vs[j][d], acc[d]);
      }
      m = m_new;
    }
    __syncthreads();
  }
  if (active) {
    const float denom = fmaxf(l, L_MIN_F);
    const size_t off = (((size_t)b * S + qpos) * H + (size_t)kh * G + g) * HD;
#pragma unroll
    for (int d = 0; d < HD; ++d) out[off + d] = from_float<T>(acc[d] / denom);
  }
}

template <typename T, int HD>
static int launch(const void* q, const void* k, const void* v, void* out,
                  int B, int S, int K, int G, int causal, int window,
                  float scale, cudaStream_t stream) {
  int bq = ROWS / G;
  if (bq > S) bq = S;
  dim3 grid((S + bq - 1) / bq, K, B);
  flash_prefill_kernel<T, HD><<<grid, ROWS, 0, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, S, K, G, bq, causal,
      window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
static int dispatch(const void* q, const void* k, const void* v, void* out,
                    int B, int S, int K, int G, int hd, int causal,
                    int window, float scale, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<T, 32>(q, k, v, out, B, S, K, G, causal, window, scale, stream);
    case 64: return launch<T, 64>(q, k, v, out, B, S, K, G, causal, window, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// C entry point (loaded with ctypes).  The Python wrapper checks shapes
// (hd in {32, 64}, 1 <= G <= 128), types and contiguity.  Returns
// the launch's cudaError_t (0 = success).
extern "C" int flash_prefill_launch(const void* q, const void* k,
                                    const void* v, void* out, int B, int S,
                                    int K, int G, int hd, int causal,
                                    int window, float scale, int dtype,
                                    void* stream) {
  if (B == 0 || S == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == DTYPE_BF16)
    return dispatch<__nv_bfloat16>(q, k, v, out, B, S, K, G, hd, causal,
                                   window, scale, st);
  return dispatch<float>(q, k, v, out, B, S, K, G, hd, causal, window,
                         scale, st);
}
