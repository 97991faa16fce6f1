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
//  3. Combine pass (common.cuh's split_combine_kernel, shared with the
//     paged kernel), one warp per (leaf, head): merges the leaf's hit
//     splits in split order with log-sum-exp rescaling, no atomics, so a
//     result repeats bit for bit from run to run; writes
//     acc / max(l, 1e-30).  A leaf with no hit split writes zeros.
//  4. The live count.  The host passes n_entries, the leading page_list
//     entries the grid covers, and optionally a device pointer to an
//     int32 count of the live entries among them.  With the pointer, the
//     grid is sized for all n_entries (one launch shape serves every
//     count, as a CUDA graph replay needs); a split CTA whose first entry
//     is at or past the count exits before it reads q or any page, and
//     the combine merges only the first ceil(count / pages_per_split)
//     splits.  The live splits hold the entries a launch trimmed to the
//     count on the host would give them, in the same order, so the two
//     launches agree bit for bit.
//
// Page order decides the speed, not the result: the allocator emits
// pages sorted by (first row, position), so a split holds a few
// problems' prefix pages and touches few leaves.
#include "common.cuh"

#define TREE_WARPS 8
#define TREE_MAX_WORDS 8          // at most 256 leaves per CTA chunk

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
    const int* __restrict__ n_live,        // (1,) live count, or null
    int B, int n_entries, int S, int K, int G, int hd, int pps, int lb,
    float scale) {
  constexpr int EPC = 16 / (int)sizeof(T);   // elements per 16-byte chunk
  const int split = blockIdx.x, kh = blockIdx.y, b0 = blockIdx.z * lb;
  if (n_live != nullptr) n_entries = min(n_entries, max(*n_live, 0));
  if (split * pps >= n_entries) return;     // past the live count
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

// Leaves per CTA of the split pass: all of the batch when one CTA's
// shared memory holds their queries and state beside the four staged
// pages, else fewer (the batch is then cut into leaf chunks, and each
// chunk streams the pages its own leaves need, so a page shared across
// chunks is read once per chunk).  Writes the CTA's shared bytes to
// *smem; returns 0 when not even one leaf fits.
static int leaves_per_cta(size_t elem, int B, int S, int G, int hd, int pps,
                          size_t optin, size_t* smem) {
  const size_t page_bytes = (size_t)S * hd * elem;
  int lb = B < 32 * TREE_MAX_WORDS ? B : 32 * TREE_MAX_WORDS;
  for (;;) {
    const int nwords = (lb + 31) / 32;
    *smem = 4 * page_bytes + (size_t)lb * G * hd * elem
            + (size_t)lb * G * (hd + 3 + S) * sizeof(float)
            + ((size_t)pps * (nwords + 1) + 2 * lb) * 4;
    if (*smem <= optin) return lb;
    if (lb == 1) return 0;
    lb = lb > 32 ? lb - 32 : lb / 2;
  }
}

template <typename T>
static int launch(const void* q, const void* k, const void* v,
                  const void* page_list, const void* page_mask,
                  const void* page_lens, void* out, void* part_acc,
                  void* part_ml, void* part_hit, const void* n_live, int B,
                  int n_entries, int S, int K, int G, int hd, int pps,
                  float scale, cudaStream_t stream) {
  const int n_splits = (n_entries + pps - 1) / pps;
  if (n_splits > 0) {
    size_t optin = 0;                   // the card's per-block cap
    cudaError_t e = smem_optin(&optin);
    if (e != cudaSuccess) return (int)e;
    size_t smem = 0;
    const int lb = leaves_per_cta(sizeof(T), B, S, G, hd, pps, optin, &smem);
    if (lb == 0) return (int)cudaErrorInvalidValue;
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
        (float*)part_acc, (float*)part_ml, (unsigned char*)part_hit,
        (const int*)n_live, B, n_entries, S, K, G, hd, pps, lb, scale);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)launch_combine<T>(part_acc, part_ml, part_hit, out, B, K * G,
                                hd, n_splits, stream, n_live, pps);
}

// C entry point (loaded with ctypes).  The Python wrapper checks shapes,
// types, contiguity and alignment (hd % 8 == 0, hd <= 256, 16-byte
// aligned pools), and allocates the scratch: part_acc (n_splits, B, H,
// hd) float32, part_ml (n_splits, B, H, 2) float32, part_hit (n_splits,
// B) uint8, n_splits = ceil(n_entries / pages_per_split).  n_entries <=
// N is the count of leading page_list entries the grid covers (every
// entry past it must be a dump entry); n_live, when not null, points at
// the int32 count of live entries among them on the device (design 4).
// Returns the first failing launch's cudaError_t (0 = success).
extern "C" int tree_attention_launch(
    const void* q, const void* k_pool, const void* v_pool,
    const void* page_list, const void* page_mask, const void* page_lens,
    void* out, void* part_acc, void* part_ml, void* part_hit,
    const void* n_live, int B, int n_entries, int S, int K, int G, int hd,
    int pages_per_split, float scale, int dtype, void* stream) {
  if (B == 0) return 0;
  if (pages_per_split < 1 || hd % 8 || hd > 256)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == DTYPE_BF16)
    return launch<__nv_bfloat16>(q, k_pool, v_pool, page_list, page_mask,
                                 page_lens, out, part_acc, part_ml, part_hit,
                                 n_live, B, n_entries, S, K, G, hd,
                                 pages_per_split, scale, st);
  return launch<float>(q, k_pool, v_pool, page_list, page_mask, page_lens,
                       out, part_acc, part_ml, part_hit, n_live, B,
                       n_entries, S, K, G, hd, pages_per_split, scale, st);
}

// Leaves per CTA the split pass would take for these shapes (the leaf
// chunks of a call are ceil(B / leaves)); 0 when not even one leaf's
// state fits, a negative cudaError_t when the device query fails.
extern "C" int tree_attention_leaves_per_cta(int B, int S, int G, int hd,
                                             int pages_per_split,
                                             int dtype) {
  size_t optin = 0, smem = 0;
  cudaError_t e = smem_optin(&optin);
  if (e != cudaSuccess) return -(int)e;
  const size_t elem = dtype == DTYPE_BF16 ? 2 : 4;
  return leaves_per_cta(elem, B, S, G, hd, pages_per_split, optin, &smem);
}
