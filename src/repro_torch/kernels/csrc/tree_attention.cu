// Tree decode attention (DeFT-style): the tree's unique live pages are
// the unit of work; each page is read once per leaf tile and attended
// against every leaf of the tile that descends from it.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/tree_attention.py::tree_attention (body _kernel).
// Same contract: page_list (N,) of unique pages, page_mask (N, B) int8
// descendant bitmap, page_lens (N,) valid slots; zero-length (dump)
// entries and leaves with no mask bit are inert, and a fully masked row
// outputs zeros (acc / max(l, 1e-30)), never NaN.
//
// Bound on the H100: the bytes of the tree's unique pages — this is
// where ETS's KV sharing becomes device-memory traffic saved: a prefix
// page shared by k leaves is read once per leaf tile, not k times.
//
// Design: one CTA per (leaf tile, kv head).  On the TPU the page axis
// is a sequential grid axis carrying (m, l, acc) across grid steps; GPU
// blocks run in parallel, so here the page walk is a loop inside the
// CTA and every (leaf, query head) pair of the tile keeps its running
// (m, l, acc) in shared memory for the whole walk.  Per page, the CTA
// first asks whether any leaf of the tile descends from it
// (__syncthreads_or) and skips the load otherwise, then stages the
// page's S x hd slice for its kv head in shared memory once; warp w
// serves pairs w, w + W, ...: lane s scores slot s, the warp reduces
// max/sum with shuffles, lane j updates output dims j, j+32, ....
// Later work: split the page walk across CTAs (DeFT's KV-guided
// grouping) with a second reduction pass, and cp.async double-buffering.
#include "common.cuh"

template <typename T>
__global__ void tree_attention_kernel(
    const T* __restrict__ q,               // (B, H, hd)
    const T* __restrict__ k_pool,          // (P, S, K, hd)
    const T* __restrict__ v_pool,          // (P, S, K, hd)
    const int* __restrict__ page_list,     // (N,)
    const signed char* __restrict__ page_mask,  // (N, B)
    const int* __restrict__ page_lens,     // (N,)
    T* __restrict__ out,                   // (B, H, hd)
    int B, int N, int S, int K, int G, int hd, int block_b, float scale) {
  const int tile = blockIdx.x, kh = blockIdx.y;
  const int b0 = tile * block_b;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  const int H = K * G, ld = hd + 1;
  const int pairs = block_b * G;         // (leaf, query head) pairs
  extern __shared__ float smem[];
  float* ks = smem;                      // S * ld
  float* vs = ks + S * ld;               // S * ld
  float* qs = vs + S * ld;               // pairs * hd
  float* accs = qs + pairs * hd;         // pairs * hd
  float* ms = accs + pairs * hd;         // pairs
  float* lsum = ms + pairs;              // pairs
  float* ps = lsum + pairs;              // n_warps * S

  for (int i = threadIdx.x; i < pairs * hd; i += blockDim.x) {
    const int p = i / hd, d = i - p * hd;
    const int b = b0 + p / G, g = p % G;
    qs[i] = b < B ? to_float(q[((size_t)b * H + (size_t)kh * G + g) * hd + d])
                  : 0.f;
    accs[i] = 0.f;
  }
  for (int p = threadIdx.x; p < pairs; p += blockDim.x) {
    ms[p] = NEG_INF_F;
    lsum[p] = 0.f;
  }
  __syncthreads();

  float* pw = ps + warp * S;
  for (int n = 0; n < N; ++n) {
    const int n_valid = min(page_lens[n], S);
    if (n_valid <= 0) continue;                      // dump entry: inert
    int mine = 0;
    for (int bi = threadIdx.x; bi < block_b; bi += blockDim.x) {
      const int b = b0 + bi;
      if (b < B && page_mask[(size_t)n * B + b]) mine = 1;
    }
    if (!__syncthreads_or(mine)) continue;          // no leaf of the tile
    const int page = page_list[n];
    for (int i = threadIdx.x; i < n_valid * hd; i += blockDim.x) {
      const int s = i / hd, d = i - s * hd;
      const size_t off = (((size_t)page * S + s) * K + kh) * hd + d;
      ks[s * ld + d] = to_float(k_pool[off]);
      vs[s * ld + d] = to_float(v_pool[off]);
    }
    __syncthreads();
    for (int p = warp; p < pairs; p += n_warps) {
      const int b = b0 + p / G;
      if (b >= B || !page_mask[(size_t)n * B + b]) continue;   // warp-uniform
      const float* qp = qs + p * hd;
      float m_cur = NEG_INF_F;
      for (int s = lane; s < n_valid; s += 32) {
        float dot = 0.f;
        for (int d = 0; d < hd; ++d) dot = fmaf(qp[d], ks[s * ld + d], dot);
        const float sc = dot * scale;
        pw[s] = sc;
        m_cur = fmaxf(m_cur, sc);
      }
      m_cur = warp_max(m_cur);
      const float m_prev = ms[p];
      const float m_new = fmaxf(m_prev, m_cur);
      const float alpha = expf(m_prev - m_new);
      float psum = 0.f;
      for (int s = lane; s < n_valid; s += 32) {
        const float e = expf(pw[s] - m_new);
        pw[s] = e;
        psum += e;
      }
      psum = warp_sum(psum);
      __syncwarp();
      float* ap = accs + p * hd;
      for (int d = lane; d < hd; d += 32) {
        float a = 0.f;
        for (int s = 0; s < n_valid; ++s) a = fmaf(pw[s], vs[s * ld + d], a);
        ap[d] = ap[d] * alpha + a;
      }
      if (lane == 0) {
        ms[p] = m_new;
        lsum[p] = alpha * lsum[p] + psum;
      }
      __syncwarp();
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < pairs * hd; i += blockDim.x) {
    const int p = i / hd, d = i - p * hd;
    const int b = b0 + p / G, g = p % G;
    if (b < B)
      out[((size_t)b * H + (size_t)kh * G + g) * hd + d] =
          from_float<T>(accs[i] / fmaxf(lsum[p], L_MIN_F));
  }
}

template <typename T>
static int launch(const void* q, const void* k, const void* v,
                  const void* page_list, const void* page_mask,
                  const void* page_lens, void* out, int B, int N, int S,
                  int K, int G, int hd, int block_b, float scale,
                  cudaStream_t stream) {
  const int pairs = block_b * G;
  const int warps = pairs < 16 ? (pairs < 4 ? 4 : pairs) : 16;
  const size_t smem = sizeof(float) * (2 * (size_t)S * (hd + 1)
                                       + 2 * (size_t)pairs * hd
                                       + 2 * (size_t)pairs
                                       + (size_t)warps * S);
  auto kern = tree_attention_kernel<T>;
  cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((B + block_b - 1) / block_b, K);
  kern<<<grid, warps * 32, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int*)page_list,
      (const signed char*)page_mask, (const int*)page_lens, (T*)out, B, N,
      S, K, G, hd, block_b, scale);
  return (int)cudaGetLastError();
}

// C entry point (loaded with ctypes).  The Python wrapper checks shapes,
// types and contiguity.  Returns the launch's cudaError_t (0 = success).
extern "C" int tree_attention_launch(
    const void* q, const void* k_pool, const void* v_pool,
    const void* page_list, const void* page_mask, const void* page_lens,
    void* out, int B, int N, int S, int K, int G, int hd, int block_b,
    float scale, int dtype, void* stream) {
  if (B == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == DTYPE_BF16)
    return launch<__nv_bfloat16>(q, k_pool, v_pool, page_list, page_mask,
                                 page_lens, out, B, N, S, K, G, hd, block_b,
                                 scale, st);
  return launch<float>(q, k_pool, v_pool, page_list, page_mask, page_lens,
                       out, B, N, S, K, G, hd, block_b, scale, st);
}
