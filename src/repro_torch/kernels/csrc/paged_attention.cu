// Paged decode attention: one query token per row attends over the
// row's block table of KV pages.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/paged_attention.py::paged_attention (body _kernel).
// Same contract: GQA regroups the H query heads as (K, G); each page
// contributes n_valid = clip(len - t*S, 0, S) slots to an fp32 online
// softmax with masked scores at -1e30; the output is acc / max(l, 1e-30),
// so a zero-length row gives zeros.  Table entries < 0 are skipped.
//
// Bound on the H100: the bytes of KV each row streams — every row reads
// its own pages (a page shared by k rows is read k times), a few FLOPs
// per byte, far below the card's ~20 FLOP/byte fp32 ridge.
//
// Design: one CTA per (row, kv head), so the K/V slice of a page
// (S x hd for that head) is read from device memory once per CTA and
// serves all G query heads of the group from shared memory.  Warp g owns
// query head g: lane s scores slot s against the page (rows of the tile
// are padded to hd+1 floats so the 32 lanes hit 32 banks), the warp
// reduces the page max/sum with shuffles, and lane j accumulates output
// dims j, j+32, ... in registers.  The page walk is a loop inside the
// CTA (the TPU grid's sequential page axis); it stops at the last page
// that holds a valid slot.  Later work: split-K over pages for long
// contexts, cp.async double-buffering, vector loads.
#include "common.cuh"

template <typename T, int DPL>
__global__ void paged_attention_kernel(
    const T* __restrict__ q,             // (B, H, hd)
    const T* __restrict__ k_pool,        // (P, S, K, hd)
    const T* __restrict__ v_pool,        // (P, S, K, hd)
    const int* __restrict__ tables,      // (B, T)   -1 padded
    const int* __restrict__ lengths,     // (B,)
    T* __restrict__ out,                 // (B, H, hd)
    int T_, int S, int K, int G, int hd, float scale) {
  const int b = blockIdx.x, kh = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int H = K * G, ld = hd + 1;
  extern __shared__ float smem[];
  float* ks = smem;                      // S * ld
  float* vs = ks + S * ld;               // S * ld
  float* qs = vs + S * ld;               // G * hd
  float* ps = qs + G * hd;               // G * S  (per-warp probabilities)

  const size_t qoff = ((size_t)b * H + (size_t)kh * G) * hd;
  for (int i = threadIdx.x; i < G * hd; i += blockDim.x)
    qs[i] = to_float(q[qoff + i]);

  float m = NEG_INF_F, l = 0.f;
  float acc[DPL];
#pragma unroll
  for (int j = 0; j < DPL; ++j) acc[j] = 0.f;

  const int len = lengths[b];
  const int n_pages = len > 0 ? min(T_, (len + S - 1) / S) : 0;
  __syncthreads();
  for (int t = 0; t < n_pages; ++t) {
    const int page = tables[(size_t)b * T_ + t];
    const int n_valid = min(max(len - t * S, 0), S);
    if (page < 0 || n_valid <= 0) continue;          // uniform per CTA
    for (int i = threadIdx.x; i < n_valid * hd; i += blockDim.x) {
      const int s = i / hd, d = i - s * hd;
      const size_t off = (((size_t)page * S + s) * K + kh) * hd + d;
      ks[s * ld + d] = to_float(k_pool[off]);
      vs[s * ld + d] = to_float(v_pool[off]);
    }
    __syncthreads();
    if (warp < G) {
      const float* qg = qs + warp * hd;
      float* pw = ps + warp * S;
      float m_cur = NEG_INF_F;
      for (int s = lane; s < n_valid; s += 32) {
        float dot = 0.f;
        for (int d = 0; d < hd; ++d) dot = fmaf(qg[d], ks[s * ld + d], dot);
        const float sc = dot * scale;
        pw[s] = sc;
        m_cur = fmaxf(m_cur, sc);
      }
      m_cur = warp_max(m_cur);
      const float m_new = fmaxf(m, m_cur);
      const float alpha = expf(m - m_new);
      float psum = 0.f;
      for (int s = lane; s < n_valid; s += 32) {
        const float p = expf(pw[s] - m_new);
        pw[s] = p;
        psum += p;
      }
      psum = warp_sum(psum);
      l = alpha * l + psum;
      __syncwarp();
#pragma unroll
      for (int j = 0; j < DPL; ++j) {
        const int d = lane + 32 * j;
        if (d < hd) {
          float a = 0.f;
          for (int s = 0; s < n_valid; ++s) a = fmaf(pw[s], vs[s * ld + d], a);
          acc[j] = acc[j] * alpha + a;
        }
      }
      m = m_new;
    }
    __syncthreads();
  }
  if (warp < G) {
    const float denom = fmaxf(l, L_MIN_F);
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      const int d = lane + 32 * j;
      if (d < hd) out[qoff + (size_t)warp * hd + d] = from_float<T>(acc[j] / denom);
    }
  }
}

template <typename T, int DPL>
static int launch(const void* q, const void* k, const void* v,
                  const void* tables, const void* lengths, void* out,
                  int B, int K, int G, int hd, int S, int T_, float scale,
                  cudaStream_t stream) {
  const int warps = G < 4 ? 4 : G;
  const size_t smem = sizeof(float) * (2 * (size_t)S * (hd + 1)
                                       + (size_t)G * hd + (size_t)G * S);
  auto kern = paged_attention_kernel<T, DPL>;
  cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(B, K);
  kern<<<grid, warps * 32, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int*)tables,
      (const int*)lengths, (T*)out, T_, S, K, G, hd, scale);
  return (int)cudaGetLastError();
}

template <typename T>
static int dispatch(const void* q, const void* k, const void* v,
                    const void* tables, const void* lengths, void* out,
                    int B, int K, int G, int hd, int S, int T_, float scale,
                    cudaStream_t stream) {
  if (hd <= 32)
    return launch<T, 1>(q, k, v, tables, lengths, out, B, K, G, hd, S, T_, scale, stream);
  if (hd <= 64)
    return launch<T, 2>(q, k, v, tables, lengths, out, B, K, G, hd, S, T_, scale, stream);
  if (hd <= 128)
    return launch<T, 4>(q, k, v, tables, lengths, out, B, K, G, hd, S, T_, scale, stream);
  return launch<T, 8>(q, k, v, tables, lengths, out, B, K, G, hd, S, T_, scale, stream);
}

// C entry point (loaded with ctypes).  Shapes are checked by the Python
// wrapper: hd <= 256, 1 <= G <= 32, all tensors contiguous on `stream`'s
// device.  Returns the launch's cudaError_t (0 = success).
extern "C" int paged_attention_launch(
    const void* q, const void* k_pool, const void* v_pool,
    const void* block_tables, const void* lengths, void* out,
    int B, int K, int G, int hd, int S, int T_, float scale, int dtype,
    void* stream) {
  if (B == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == DTYPE_BF16)
    return dispatch<__nv_bfloat16>(q, k_pool, v_pool, block_tables, lengths,
                                   out, B, K, G, hd, S, T_, scale, st);
  return dispatch<float>(q, k_pool, v_pool, block_tables, lengths, out, B,
                         K, G, hd, S, T_, scale, st);
}
