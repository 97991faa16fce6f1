// Tree decode attention (DeFT-style), split over the unique-page walk:
// every unique live page of the tree is read from device memory once per
// kv head and attended against every leaf of the batch that descends
// from it.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/tree_attention.py::tree_attention (body _kernel).
// Same contract: page_list (N,) of unique pages, page_mask (N, B) int8
// descendant bitmap, page_lens (N,) valid slots; zero-length (dump)
// entries and leaves with no mask bit are inert, and a fully masked row
// outputs exactly zero (acc / max(l, 1e-30)), never NaN.
//
// Bound on the H100: the bytes of the tree's unique pages (each K/V
// slot of a live page read once per kv head).  This is where ETS's KV
// sharing becomes device-memory traffic saved: a prefix page shared by
// k leaves is read once, not k times.  The FLOPs (4 * H * hd per
// attended (leaf, slot)) are a few percent of the byte time even in
// fp32, so the products run on the CUDA cores.
//
// Design (flash-decoding over page_list, two launches on one stream):
//
//  1. Split pass, grid (split, kv head, leaf chunk).  Split s owns the
//     entries [s * pages_per_split, (s + 1) * pages_per_split) of
//     page_list and serves every leaf of the batch (of its leaf chunk:
//     the launcher cuts the batch into chunks only when one CTA's state
//     for all B leaves x G heads would not fit in shared memory) x the G
//     query heads of its kv head.  A pre-pass reads the split's mask rows
//     as 32-leaf ballot words (no block barrier per entry), drops dump
//     entries and entries no leaf of the chunk needs, and compacts the
//     rest into a page list.  An empty split writes its hit flags and
//     exits before any page or query is read.  Pages are staged in
//     shared memory with 16-byte cp.async copies, double-buffered: page
//     n+1 (and the list of its active leaves) is in flight while page n
//     is scored.  Slot rows are stored with their 16-byte chunks
//     XOR-swizzled by slot, so lanes reading one chunk of 8 slots hit
//     distinct banks.  Per page, the whole CTA works on the (active
//     leaf, head) pairs in two phases split by one barrier: scores, with
//     a group of lanes per pair (one lane per slot) that also takes the
//     group's max and sum by shuffles and updates the pair's running
//     (m, l); then acc = alpha * acc + P.V, one thread per (pair,
//     16-byte chunk of the head dim).  The running state of every pair
//     lives in shared memory for the whole split.
//  2. Partials.  For each (split, leaf, head) the split writes its (m, l,
//     acc[hd]) to scratch the wrapper allocated, only for leaves that have
//     a page in the split; for every (split, leaf) it writes one hit byte
//     (0 = the leaf has no page here: the combine skips the split, no
//     sentinel is written).  Scratch: n_splits x B x H x (hd + 2) floats
//     plus n_splits x B bytes (fp32 llama3.2-1b decode, 256 live pages,
//     8 pages per split: 32 x 32 x 32 x 66 x 4 B = 8.7 MB).
//  3. Combine pass, one warp per (leaf, head): merges the leaf's hit
//     splits in split order with log-sum-exp rescaling, no atomics, so a
//     result repeats bit for bit from run to run; writes
//     acc / max(l, 1e-30).  A leaf with no hit split writes zeros.
//
// Page order decides the speed, not the result: the allocator emits
// pages sorted by (first row, position), so a split holds a few
// problems' prefix pages and touches few leaves.
#include "common.cuh"

#define TREE_WARPS 8
#define TREE_MAX_WORDS 8          // at most 256 leaves per CTA chunk
#define COMBINE_WARPS 8

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

template <typename T>
__global__ void __launch_bounds__(TREE_WARPS * 32) tree_split_kernel(
    const T* __restrict__ q,               // (B, H, hd)
    const T* __restrict__ k_pool,          // (P, S, K, hd)
    const T* __restrict__ v_pool,          // (P, S, K, hd)
    const int* __restrict__ page_list,     // (N,)
    const signed char* __restrict__ page_mask,  // (N, B)
    const int* __restrict__ page_lens,     // (N,)
    float* __restrict__ part_acc,          // (n_splits, B, H, hd)
    float* __restrict__ part_ml,           // (n_splits, B, H, 2)
    unsigned char* __restrict__ part_hit,  // (n_splits, B)
    int B, int n_entries, int S, int K, int G, int hd, int pps, int lb,
    float scale) {
  constexpr int EPC = 16 / (int)sizeof(T);   // elements per 16-byte chunk
  const int split = blockIdx.x, kh = blockIdx.y, b0 = blockIdx.z * lb;
  const int nb = min(lb, B - b0);
  const int H = K * G, pairs = nb * G;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n0 = split * pps;
  const int n_here = max(0, min(pps, n_entries - n0));
  const int nwords = (lb + 31) >> 5;
  const int row_bytes = hd * (int)sizeof(T);
  const int chunks = row_bytes >> 4;            // 16-byte chunks per slot
  const int swz = (chunks & 7) == 0 ? 7 : (chunks & 3) == 0 ? 3
                  : (chunks & 1) == 0 ? 1 : 0;
  const int page_bytes = S * row_bytes;
  int sg = 1;                                   // lanes per pair (scores)
  while (sg < S && sg < 32) sg <<= 1;

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* kvbuf = smem;                  // 2 stages x (K, V) pages
  T* qs = reinterpret_cast<T*>(smem + 4 * page_bytes);          // pair, hd
  float* acc = reinterpret_cast<float*>(qs + lb * G * hd);      // pair, hd
  float* ms = acc + lb * G * hd;                // pair
  float* ls = ms + lb * G;                      // pair
  float* alpha = ls + lb * G;                   // active ordinal
  float* sc = alpha + lb * G;                   // active ordinal, slot
  unsigned* pwords = reinterpret_cast<unsigned*>(sc + lb * G * S);
  int* order = reinterpret_cast<int*>(pwords + pps * nwords);   // pps
  int* act = order + pps;                       // 2 x lb active leaves
  __shared__ unsigned touched[TREE_MAX_WORDS];
  __shared__ int n_use, n_act[2];

  // ---- pre-pass: the split's mask rows as ballot words ----------------
  if (tid < TREE_MAX_WORDS) touched[tid] = 0u;
  __syncthreads();
  for (int i = warp; i < n_here; i += TREE_WARPS) {
    const int n = n0 + i;
    const bool live = page_lens[n] > 0;
    for (int j = 0; j < nwords; ++j) {
      const int bl = j * 32 + lane;
      const bool on = live && bl < nb &&
                      page_mask[(size_t)n * B + b0 + bl] != 0;
      const unsigned w = __ballot_sync(0xffffffffu, on);
      if (lane == 0) {
        pwords[i * nwords + j] = w;
        if (w) atomicOr(&touched[j], w);
      }
    }
  }
  __syncthreads();
  if (warp == 0) {                 // compact the pages some leaf needs
    int cnt = 0;
    for (int i0 = 0; i0 < n_here; i0 += 32) {
      const int i = i0 + lane;
      bool use = false;
      if (i < n_here)
        for (int j = 0; j < nwords; ++j) use |= pwords[i * nwords + j] != 0u;
      const unsigned bal = __ballot_sync(0xffffffffu, use);
      if (use) order[cnt + __popc(bal & ((1u << lane) - 1u))] = i;
      cnt += __popc(bal);
    }
    if (lane == 0) n_use = cnt;
  }
  __syncthreads();
  auto is_hit = [&](int bl) { return (touched[bl >> 5] >> (bl & 31)) & 1u; };
  if (kh == 0)
    for (int bl = tid; bl < nb; bl += blockDim.x)
      part_hit[(size_t)split * B + b0 + bl] = (unsigned char)is_hit(bl);
  const int cnt = n_use;
  if (cnt == 0) return;                 // only dump entries / no leaf here

  // ---- stage page `it` of the compacted list into buffer `buf`, and
  // list its active leaves (warp 0) --------------------------------------
  auto stage = [&](int it, int buf) {
    const int i = order[it];
    const int n = n0 + i;
    const size_t page = (size_t)page_list[n];
    const int nv = min(page_lens[n], S);
    unsigned char* dst = kvbuf + buf * 2 * page_bytes;
    const int per = nv * chunks;
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
    if (warp == 0) {
      int base = 0;
      for (int j = 0; j < nwords; ++j) {
        const unsigned bits = pwords[i * nwords + j];
        if ((bits >> lane) & 1u)
          act[buf * lb + base + __popc(bits & ((1u << lane) - 1u))] =
              j * 32 + lane;
        base += __popc(bits);
      }
      if (lane == 0) n_act[buf] = base;
    }
  };
  // queries of the leaves that have a page here (G x hd contiguous
  // elements per leaf), in the first copy group with page 0
  const int leaf_chunks = G * chunks;
  for (int c = tid; c < nb * leaf_chunks; c += blockDim.x) {
    const int bl = c / leaf_chunks, r = c - bl * leaf_chunks;
    if (is_hit(bl))
      cp_async16(reinterpret_cast<unsigned char*>(qs) +
                     ((size_t)bl * leaf_chunks + r) * 16,
                 reinterpret_cast<const unsigned char*>(
                     q + ((size_t)(b0 + bl) * H + kh * G) * hd) + r * 16);
  }
  stage(0, 0);
  cp_async_commit();

  // running state of the pairs
  for (int i = tid; i < pairs * hd; i += blockDim.x) acc[i] = 0.f;
  for (int p = tid; p < pairs; p += blockDim.x) {
    ms[p] = NEG_INF_F;
    ls[p] = 0.f;
  }

  for (int it = 0; it < cnt; ++it) {
    if (it + 1 < cnt) {
      stage(it + 1, (it + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int buf = it & 1;
    const int nv = min(page_lens[n0 + order[it]], S);
    const unsigned char* ks = kvbuf + buf * 2 * page_bytes;
    const unsigned char* vs = ks + page_bytes;
    const int* al = act + buf * lb;
    const int np = n_act[buf] * G;      // active (leaf, head) pairs

    // scores and the online-softmax update: sg lanes per active pair,
    // lane j holding slots j, j + sg, ...; max and sum over the group
    const int per_pass = blockDim.x / sg;
    for (int k0 = 0; k0 < np; k0 += per_pass) {
      const int k = k0 + tid / sg, j = tid & (sg - 1);
      const bool on = k < np;
      const int p = on ? al[k / G] * G + k % G : 0;
      float mloc = NEG_INF_F;
      if (on) {
        const uint4* qp = reinterpret_cast<const uint4*>(qs + p * hd);
        for (int s = j; s < nv; s += sg) {
          const unsigned char* krow = ks + s * row_bytes;
          float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
          for (int ch = 0; ch < chunks; ++ch)
            dot16(d, *reinterpret_cast<const uint4*>(
                         krow + ((ch ^ (s & swz)) << 4)),
                  qp[ch], T());
          const float x = ((d[0] + d[1]) + (d[2] + d[3])) * scale;
          sc[k * S + s] = x;
          mloc = fmaxf(mloc, x);
        }
      }
      for (int o = sg >> 1; o > 0; o >>= 1)
        mloc = fmaxf(mloc, __shfl_xor_sync(0xffffffffu, mloc, o));
      float m_old = 0.f, m_new = 0.f, psum = 0.f;
      if (on) {
        m_old = ms[p];
        m_new = fmaxf(m_old, mloc);
        for (int s = j; s < nv; s += sg) {
          const float e = expf(sc[k * S + s] - m_new);
          sc[k * S + s] = e;
          psum += e;
        }
      }
      for (int o = sg >> 1; o > 0; o >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, o);
      if (on && j == 0) {
        const float a = expf(m_old - m_new);
        alpha[k] = a;
        ms[p] = m_new;
        ls[p] = ls[p] * a + psum;
      }
    }
    __syncthreads();

    // acc = alpha * acc + P.V: one task per (active pair, 16-byte chunk
    // of the head dim)
    for (int t = tid; t < np * chunks; t += blockDim.x) {
      const int k = t / chunks, ch = t - k * chunks;
      const int p = al[k / G] * G + k % G;
      float* ap = acc + p * hd + ch * EPC;
      const float ak = alpha[k];
      float a[EPC];
#pragma unroll
      for (int e = 0; e < EPC; ++e) a[e] = ap[e] * ak;
      const float* pk = sc + k * S;
#pragma unroll 4
      for (int s = 0; s < nv; ++s)
        axpy16(a, *reinterpret_cast<const uint4*>(
                      vs + s * row_bytes + ((ch ^ (s & swz)) << 4)),
               pk[s]);
#pragma unroll
      for (int e = 0; e < EPC; ++e) ap[e] = a[e];
    }
    __syncthreads();                    // buffer `buf` and sc are free
  }

  // ---- partials of the leaves this split touched ----------------------
  const int hd4 = hd >> 2;
  for (int i = tid; i < pairs * hd4; i += blockDim.x) {
    const int p = i / hd4, d4 = i - p * hd4;
    const int bl = p / G, g = p - bl * G;
    if (is_hit(bl))
      reinterpret_cast<float4*>(part_acc + (((size_t)split * B + b0 + bl) * H
                                            + kh * G + g) * hd)[d4] =
          reinterpret_cast<const float4*>(acc)[i];
  }
  for (int p = tid; p < pairs; p += blockDim.x) {
    const int bl = p / G, g = p - bl * G;
    if (is_hit(bl)) {
      float* ml = part_ml + (((size_t)split * B + b0 + bl) * H + kh * G + g)
                                * 2;
      ml[0] = ms[p];
      ml[1] = ls[p];
    }
  }
}

// One warp per (leaf, query head): merge the leaf's hit splits in split
// order; lane t holds output dims t, t + 32, ....
template <typename T>
__global__ void __launch_bounds__(COMBINE_WARPS * 32) tree_combine_kernel(
    const float* __restrict__ part_acc, const float* __restrict__ part_ml,
    const unsigned char* __restrict__ part_hit, T* __restrict__ out, int B,
    int H, int hd, int n_splits) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int pair = blockIdx.x * COMBINE_WARPS + warp;   // b * H + h
  if (pair >= B * H) return;
  const int b = pair / H;
  float m = NEG_INF_F, l = 0.f, a[8];
#pragma unroll
  for (int t = 0; t < 8; ++t) a[t] = 0.f;
  for (int sb = 0; sb < n_splits; sb += 32) {
    const int s = sb + lane;
    unsigned bits = __ballot_sync(
        0xffffffffu, s < n_splits && part_hit[(size_t)s * B + b] != 0);
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
static int launch(const void* q, const void* k, const void* v,
                  const void* page_list, const void* page_mask,
                  const void* page_lens, void* out, void* part_acc,
                  void* part_ml, void* part_hit, int B, int n_entries, int S,
                  int K, int G, int hd, int pps, float scale,
                  cudaStream_t stream) {
  const int n_splits = (n_entries + pps - 1) / pps;
  if (n_splits > 0) {
    static int optin = 0;               // the card's per-block cap
    cudaError_t e = cudaSuccess;
    if (optin == 0) {
      int dev = 0;
      e = cudaGetDevice(&dev);
      if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(
            &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
      if (e != cudaSuccess) return (int)e;
    }
    // leaves per CTA: all of the batch when their state fits
    const size_t page_bytes = (size_t)S * hd * sizeof(T);
    int lb = B < 32 * TREE_MAX_WORDS ? B : 32 * TREE_MAX_WORDS;
    size_t smem = 0;
    for (;;) {
      const int nwords = (lb + 31) / 32;
      smem = 4 * page_bytes + (size_t)lb * G * hd * sizeof(T)
             + (size_t)lb * G * (hd + 3 + S) * sizeof(float)
             + ((size_t)pps * (nwords + 1) + 2 * lb) * 4;
      if (smem <= (size_t)optin) break;
      if (lb == 1) return (int)cudaErrorInvalidValue;
      lb = lb > 32 ? lb - 32 : lb / 2;
    }
    auto kern = tree_split_kernel<T>;
    static size_t smem_allowed = 0;     // this instance's raised cap
    if (smem > smem_allowed) {
      e = allow_smem(kern, smem);
      if (e != cudaSuccess) return (int)e;
      smem_allowed = smem;
    }
    dim3 grid(n_splits, K, (B + lb - 1) / lb);
    kern<<<grid, TREE_WARPS * 32, smem, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (const int*)page_list,
        (const signed char*)page_mask, (const int*)page_lens,
        (float*)part_acc, (float*)part_ml, (unsigned char*)part_hit, B,
        n_entries, S, K, G, hd, pps, lb, scale);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const int H = K * G;
  tree_combine_kernel<T><<<(B * H + COMBINE_WARPS - 1) / COMBINE_WARPS,
                           COMBINE_WARPS * 32, 0, stream>>>(
      (const float*)part_acc, (const float*)part_ml,
      (const unsigned char*)part_hit, (T*)out, B, H, hd, n_splits);
  return (int)cudaGetLastError();
}

// C entry point (loaded with ctypes).  The Python wrapper checks shapes,
// types, contiguity and alignment (hd % 8 == 0, hd <= 256, 16-byte
// aligned pools), and allocates the scratch: part_acc (n_splits, B, H,
// hd) float32, part_ml (n_splits, B, H, 2) float32, part_hit (n_splits,
// B) uint8, n_splits = ceil(n_entries / pages_per_split).  n_entries <=
// N is the count of leading page_list entries the grid covers (every
// entry past it must be a dump entry).  Returns the first failing
// launch's cudaError_t (0 = success).
extern "C" int tree_attention_launch(
    const void* q, const void* k_pool, const void* v_pool,
    const void* page_list, const void* page_mask, const void* page_lens,
    void* out, void* part_acc, void* part_ml, void* part_hit, int B,
    int n_entries, int S, int K, int G, int hd, int pages_per_split,
    float scale, int dtype, void* stream) {
  if (B == 0) return 0;
  if (pages_per_split < 1 || hd % 8 || hd > 256)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == DTYPE_BF16)
    return launch<__nv_bfloat16>(q, k_pool, v_pool, page_list, page_mask,
                                 page_lens, out, part_acc, part_ml, part_hit,
                                 B, n_entries, S, K, G, hd, pages_per_split,
                                 scale, st);
  return launch<float>(q, k_pool, v_pool, page_list, page_mask, page_lens,
                       out, part_acc, part_ml, part_hit, B, n_entries, S, K,
                       G, hd, pages_per_split, scale, st);
}
