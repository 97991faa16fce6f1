// Paged decode attention (flash-decoding over each row's block table):
// one query token per row attends over the row's pages of KV.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/paged_attention.py::paged_attention (body _kernel).
// Same contract: GQA regroups the H query heads as (K, G); page t of a
// row contributes n_valid = clip(len - t*S, 0, S) slots to an fp32
// online softmax (masked scores at -1e30 in the reference); the output
// is acc / max(l, 1e-30), so a zero-length row gives zeros.  Table
// entries < 0 are skipped.
//
// Bound on the H100: the bytes of KV the rows read.  Every row streams
// its own pages, so a prefix page shared by k rows is requested k times;
// the unique bytes (each page once) are the floor when L2 serves the
// re-reads, the logical bytes (each page once per row) when it does not.
// A few FLOPs per byte, far below the fp32 ridge: the products run on
// the CUDA cores.
//
// Design (two launches on one stream):
//
//  1. Split pass, grid (row, kv head, split), rows fastest so that CTAs
//     of neighbouring rows (which share prefix pages at the same table
//     positions) run close in time.  Split s walks the block-table
//     entries [s * pages_per_split, (s + 1) * pages_per_split) of its
//     row; all G query heads of the kv head share each staged K/V tile.
//     A CTA past the row's last valid page writes an empty partial
//     (l = 0) and exits before any load; -1 entries are compacted away.
//     Pages are staged with 16-byte cp.async copies, double-buffered
//     (page n+1 in flight while page n is scored), slot rows with their
//     16-byte chunks XOR-swizzled by slot.  Scores: each head owns a
//     segment of lanes, a group of L lanes per slot, each lane a strided
//     share of the head dim with four partial sums; shuffles finish the
//     dot products, the page max and the exp-sum, and every lane of the
//     segment keeps the head's running (m, l) in registers.  P.V: one
//     thread per (head, 16-byte chunk of the head dim), unrolled over
//     slots, accumulating into shared memory.  Each split writes its
//     (m, l, acc[hd]) per head in fp32 to scratch the wrapper allocated.
//  2. Combine pass (common.cuh's split_combine_kernel, shared with the
//     tree kernel), one warp per (row, head): merges the row's splits
//     with l > 0 in split order with log-sum-exp rescaling, no atomics,
//     so two launches on the same inputs are bitwise equal; writes
//     acc / max(l, 1e-30) (zeros for a row with no valid page).
#include "common.cuh"

#define PAGED_THREADS 128

template <typename T>
__global__ void __launch_bounds__(PAGED_THREADS) paged_split_kernel(
    const T* __restrict__ q,             // (B, H, hd)
    const T* __restrict__ k_pool,        // (P, S, K, hd)
    const T* __restrict__ v_pool,        // (P, S, K, hd)
    const int* __restrict__ tables,      // (B, T)   -1 padded
    const int* __restrict__ lengths,     // (B,)
    float* __restrict__ part_acc,        // (n_splits, B, H, hd)
    float* __restrict__ part_ml,         // (n_splits, B, H, 2)
    int B, int T_, int S, int K, int G, int hd, int pps, float scale) {
  constexpr int EPC = 16 / (int)sizeof(T);   // elements per 16-byte chunk
  const int b = blockIdx.x, kh = blockIdx.y, split = blockIdx.z;
  const int H = K * G, tid = threadIdx.x;
  const int len = lengths[b];
  const int n_pages = len > 0 ? min(T_, (len + S - 1) / S) : 0;
  const int t0 = split * pps;
  const int n_here = min(pps, n_pages - t0);
  // (split, b, kh * G): the first of this CTA's G (m, l, acc) partials
  const size_t part0 = ((size_t)split * B + b) * H + (size_t)kh * G;
  if (n_here <= 0) {                   // past the row's last page
    for (int g = tid; g < G; g += blockDim.x) {
      part_ml[(part0 + g) * 2] = NEG_INF_F;
      part_ml[(part0 + g) * 2 + 1] = 0.f;
    }
    return;
  }
  const int row_bytes = hd * (int)sizeof(T);
  const int chunks = row_bytes >> 4;            // 16-byte chunks per slot
  const int swz = (chunks & 7) == 0 ? 7 : (chunks & 3) == 0 ? 3
                  : (chunks & 1) == 0 ? 1 : 0;
  const int page_bytes = S * row_bytes;

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* kvbuf = smem;                  // 2 stages x (K, V) pages
  T* qs = reinterpret_cast<T*>(smem + 4 * page_bytes);          // G x hd
  float* acc = reinterpret_cast<float*>(qs + G * hd);           // G x hd
  float* sc = acc + G * hd;                     // G x S scores, then p
  float* alpha = sc + G * S;                    // G
  int* pages = reinterpret_cast<int*>(alpha + G);               // pps
  int* nvals = pages + pps;                     // pps
  __shared__ int n_use;

  // ---- the split's valid entries, compacted (warp 0) -------------------
  if (tid < 32) {
    int cnt = 0;
    for (int i0 = 0; i0 < n_here; i0 += 32) {
      const int i = i0 + tid;
      const int page = i < n_here ? tables[(size_t)b * T_ + t0 + i] : -1;
      const unsigned bal = __ballot_sync(0xffffffffu, page >= 0);
      if (page >= 0) {
        const int o = cnt + __popc(bal & ((1u << tid) - 1u));
        pages[o] = page;
        nvals[o] = min(len - (t0 + i) * S, S);
      }
      cnt += __popc(bal);
    }
    if (tid == 0) n_use = cnt;
  }
  __syncthreads();
  const int cnt = n_use;
  if (cnt == 0) {                      // only -1 entries here
    for (int g = tid; g < G; g += blockDim.x) {
      part_ml[(part0 + g) * 2] = NEG_INF_F;
      part_ml[(part0 + g) * 2 + 1] = 0.f;
    }
    return;
  }

  // stage page `it` of the compacted list into buffer `buf`
  auto stage = [&](int it, int buf) {
    const size_t page = (size_t)pages[it];
    const int per = nvals[it] * chunks;
    unsigned char* dst = kvbuf + buf * 2 * page_bytes;
    for (int c = tid; c < 2 * per; c += blockDim.x) {
      const int which = c >= per;
      const int r = c - which * per;
      const int s = r / chunks, ch = r - s * chunks;
      const T* src = (which ? v_pool : k_pool) +
                     ((page * S + s) * K + kh) * hd;
      cp_async16(dst + which * page_bytes + s * row_bytes +
                     ((ch ^ (s & swz)) << 4),
                 reinterpret_cast<const unsigned char*>(src) + (ch << 4));
    }
  };
  // the G query heads of this kv head (contiguous), with page 0
  const unsigned char* qsrc = reinterpret_cast<const unsigned char*>(
      q + ((size_t)b * H + (size_t)kh * G) * hd);
  for (int c = tid; c < G * chunks; c += blockDim.x)
    cp_async16(reinterpret_cast<unsigned char*>(qs) + c * 16, qsrc + c * 16);
  stage(0, 0);
  cp_async_commit();
  for (int i = tid; i < G * hd; i += blockDim.x) acc[i] = 0.f;

  // score lanes: head g owns a segment of `seg` lanes (a power of two,
  // G * seg <= the block), `ns` slot lanes x `L` lanes per slot
  int seg = 32;
  while (seg * G > (int)blockDim.x) seg >>= 1;
  int ns = 1;
  while (ns < S && ns < seg) ns <<= 1;
  const int L = seg / ns;
  const int g_seg = tid / seg, lane_seg = tid & (seg - 1);
  const int j = lane_seg / L, c = lane_seg & (L - 1);
  const bool head_on = g_seg < G;
  const uint4* qp = reinterpret_cast<const uint4*>(qs + (head_on ? g_seg : 0)
                                                   * hd);
  float m_run = NEG_INF_F, l_run = 0.f;     // this lane's head

  for (int it = 0; it < cnt; ++it) {
    if (it + 1 < cnt) {
      stage(it + 1, (it + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int nv = nvals[it];
    const unsigned char* ks = kvbuf + (it & 1) * 2 * page_bytes;
    const unsigned char* vs = ks + page_bytes;

    // scores and the online-softmax update of each head
    float mloc = NEG_INF_F;
    for (int s0 = 0; s0 < nv; s0 += ns) {
      const int s = s0 + j;
      const bool on = head_on && s < nv;
      float d[4] = {0.f, 0.f, 0.f, 0.f};
      if (on) {
        const unsigned char* krow = ks + s * row_bytes;
#pragma unroll 4
        for (int ch = c; ch < chunks; ch += L)
          dot16(d, *reinterpret_cast<const uint4*>(
                       krow + ((ch ^ (s & swz)) << 4)),
                qp[ch], T());
      }
      float x = (d[0] + d[1]) + (d[2] + d[3]);
      for (int o = 1; o < L; o <<= 1)
        x += __shfl_xor_sync(0xffffffffu, x, o);
      x *= scale;
      if (on) {
        if (c == 0) sc[g_seg * S + s] = x;
        mloc = fmaxf(mloc, x);
      }
    }
    for (int o = L; o < seg; o <<= 1)
      mloc = fmaxf(mloc, __shfl_xor_sync(0xffffffffu, mloc, o));
    const float m_new = fmaxf(m_run, mloc);
    float psum = 0.f;
    if (head_on && c == 0)
      for (int s = j; s < nv; s += ns) {      // the slots this lane scored
        const float e = expf(sc[g_seg * S + s] - m_new);
        sc[g_seg * S + s] = e;
        psum += e;
      }
    for (int o = 1; o < seg; o <<= 1)
      psum += __shfl_xor_sync(0xffffffffu, psum, o);
    const float a = expf(m_run - m_new);
    l_run = l_run * a + psum;
    m_run = m_new;
    if (head_on && lane_seg == 0) alpha[g_seg] = a;
    __syncthreads();

    // acc = alpha * acc + P.V: one task per (head, 16-byte chunk)
    for (int t = tid; t < G * chunks; t += blockDim.x) {
      const int g = t / chunks, ch = t - g * chunks;
      float* ap = acc + g * hd + ch * EPC;
      const float ag = alpha[g];
      float av[EPC];
#pragma unroll
      for (int e = 0; e < EPC; ++e) av[e] = ap[e] * ag;
      const float* pg = sc + g * S;
#pragma unroll 4
      for (int s = 0; s < nv; ++s)
        axpy16(av, *reinterpret_cast<const uint4*>(
                       vs + s * row_bytes + ((ch ^ (s & swz)) << 4)),
               pg[s]);
#pragma unroll
      for (int e = 0; e < EPC; ++e) ap[e] = av[e];
    }
    __syncthreads();                    // buffer it & 1 and sc are free
  }

  // ---- partials --------------------------------------------------------
  const int hd4 = hd >> 2;
  for (int i = tid; i < G * hd4; i += blockDim.x)
    reinterpret_cast<float4*>(part_acc + part0 * hd)[i] =
        reinterpret_cast<const float4*>(acc)[i];
  if (head_on && lane_seg == 0) {
    part_ml[(part0 + g_seg) * 2] = m_run;
    part_ml[(part0 + g_seg) * 2 + 1] = l_run;
  }
}

template <typename T>
static int launch(const void* q, const void* k, const void* v,
                  const void* tables, const void* lengths, void* out,
                  void* part_acc, void* part_ml, int B, int K, int G, int hd,
                  int S, int T_, int pps, float scale, cudaStream_t stream) {
  const int n_splits = (T_ + pps - 1) / pps;
  if (n_splits > 0) {
    size_t optin = 0;                   // the card's per-block cap
    cudaError_t e = smem_optin(&optin);
    if (e != cudaSuccess) return (int)e;
    const size_t smem = 4 * (size_t)S * hd * sizeof(T)
                        + (size_t)G * hd * (sizeof(T) + sizeof(float))
                        + (size_t)G * (S + 1) * sizeof(float)
                        + 2 * (size_t)pps * sizeof(int);
    if (smem > optin) return (int)cudaErrorInvalidValue;
    auto kern = paged_split_kernel<T>;
    static size_t smem_allowed = 0;     // this instance's raised cap
    if (smem > smem_allowed) {
      e = allow_smem(kern, smem);
      if (e != cudaSuccess) return (int)e;
      smem_allowed = smem;
    }
    dim3 grid(B, K, n_splits);
    kern<<<grid, PAGED_THREADS, smem, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (const int*)tables,
        (const int*)lengths, (float*)part_acc, (float*)part_ml, B, T_, S, K,
        G, hd, pps, scale);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)launch_combine<T>(part_acc, part_ml, nullptr, out, B, K * G,
                                hd, n_splits, stream);
}

// C entry point (loaded with ctypes).  The Python wrapper checks shapes,
// types, contiguity and alignment (hd % 8 == 0, hd <= 256, 1 <= G <= 32,
// 16-byte aligned operands), and allocates the scratch: part_acc
// (n_splits, B, H, hd) float32 and part_ml (n_splits, B, H, 2) float32,
// n_splits = ceil(T / pages_per_split).  Returns the first failing
// launch's cudaError_t (0 = success).
extern "C" int paged_attention_launch(
    const void* q, const void* k_pool, const void* v_pool,
    const void* block_tables, const void* lengths, void* out,
    void* part_acc, void* part_ml, int B, int K, int G, int hd, int S,
    int T_, int pages_per_split, float scale, int dtype, void* stream) {
  if (B == 0) return 0;
  if (pages_per_split < 1 || hd % 8 || hd > 256 || G < 1 || G > 32)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == DTYPE_BF16)
    return launch<__nv_bfloat16>(q, k_pool, v_pool, block_tables, lengths,
                                 out, part_acc, part_ml, B, K, G, hd, S, T_,
                                 pages_per_split, scale, st);
  return launch<float>(q, k_pool, v_pool, block_tables, lengths, out,
                       part_acc, part_ml, B, K, G, hd, S, T_,
                       pages_per_split, scale, st);
}
