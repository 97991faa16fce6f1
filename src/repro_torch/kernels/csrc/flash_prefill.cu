// Causal flash attention for prefill (optional sliding window) over a
// right-padded prompt bucket, FlashAttention-2 style on the tensor cores.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_prefill.py::flash_prefill (body _kernel).
// Same contract: no length operand — prompts are right-padded, so with
// causal=1 every padded key lies in the future of every valid query;
// padded query rows compute finite values the caller discards.  The G
// query heads of a kv head are packed into the tile's rows (row r is
// query position r / G, head r % G), tiles wholly in the future or
// wholly before the window are skipped, and the softmax is an fp32
// online softmax with masked scores at -1e30.
//
// Bound on the H100: the causal FLOPs, 4 * B * H * hd * S(S+1)/2 for the
// two products (fewer under a window), against the peak of the input
// type (fp32 67 TFLOP/s on the CUDA cores; bf16 989 TFLOP/s).
//
// Design: one CTA of 4 warps per (64-row packed query tile, kv head,
// batch row); warp w owns rows 16w .. 16w + 15.  The query tile and
// 32-key K/V tiles are staged in shared memory with 16-byte cp.async
// copies, the K/V tiles double-buffered (tile j + 1 loads while tile j
// is computed); rows are padded by 16 bytes so every fragment load is
// free of bank conflicts.  S = Q.K^T and O += P.V run as mma.sync
// tensor-core products (m16n8k8 TF32 for fp32 inputs, m16n8k16 bf16 for
// bf16 inputs) with fp32 accumulators in registers; the softmax runs in
// the log2 domain (exp2) and its row max and sum come from quad
// shuffles.  P stays in registers: the score accumulator's layout is the
// A operand of P.V once the 8 keys of a TF32 k-step are taken in the
// order (0, 2, 4, 6, 1, 3, 5, 7), and V's fragment is read in the same
// order.  Only the tiles that cross the diagonal, the window edge or the
// end of the bucket evaluate the mask.  32-key tiles (not 64) halve the
// shared memory per CTA (more CTAs per SM) and the masked work on the
// diagonal (PERF.md).
//
// fp32 inputs: one TF32 pass keeps ~11 bits of each operand, too few for
// the reference's 2e-5 tolerance, so each product is split 3xTF32:
// a = big + small with big = tf32(a), small = tf32(a - big), and
// a.b ~ big.big + big.small + small.big with fp32 accumulation (the
// dropped small.small term is ~2^-22 relative).  Accumulating in the
// tensor cores' fp32 accumulator over a whole key row (768 products into
// O at S = 2048) left the kernel farther from a float64 oracle than
// the plain fp32 version on 1024- and 2048-token buckets (PERF.md, P1).  So each k-step's three products go into a zeroed
// fragment, which is added to the running S or O with an ordinary
// round-to-nearest fp32 add: no chain inside the tensor cores is longer
// than three products.  At hd <= 64 the split Q
// fragments are made once and stay in registers; at hd 96 to 128 they
// would spill, so Q is read from shared memory and split at each
// k-step.  bf16 inputs: bf16 MMA with fp32 accumulation, P rounded to
// bf16 before P.V.  hd is 32, 64, 96, 112 or 128 (a template
// parameter).  The loops need only hd % 16 == 0: rows are staged in
// 16-byte chunks (hd 112: 28 fp32 / 14 bf16 chunks, strided over the
// CTA's threads), QK^T takes hd / 8 TF32 or hd / 16 bf16 k-steps and
// P.V hd / 8 n-tiles of 8 columns; no warp or lane maps onto the head
// dim, and the padded row stride (hd + 16 bytes) keeps 16-byte
// alignment and conflict-free fragment loads at every instance.
#include "common.cuh"

constexpr int FP_BM = 64;      // packed query rows per CTA
constexpr int FP_BN = 32;      // keys per K/V tile (a multiple of 16)
constexpr int FP_WARPS = 4;    // 16 rows each
#define LOG2E_F 1.4426950408889634f

__device__ __forceinline__ unsigned tf32_bits(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r & 0xffffe000u;
}
// x = big + small, both TF32
__device__ __forceinline__ void split_tf32(float x, unsigned& big,
                                           unsigned& small) {
  big = tf32_bits(x);
  small = tf32_bits(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
// 3xTF32: c += a.b with both operands split
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const float (&a)[4],
                                           const float (&b)[2]) {
  unsigned ab[4], as[4], bb[2], bs[2];
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(a[i], ab[i], as[i]);
  split_tf32(b[0], bb[0], bs[0]);
  split_tf32(b[1], bb[1], bs[1]);
  mma_tf32(c, as, bb);
  mma_tf32(c, ab, bs);
  mma_tf32(c, ab, bb);
}

// acc += c in round-to-nearest fp32 (the partial sums of one k-step)
__device__ __forceinline__ void add4(float (&acc)[4], const float (&c)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i] += c[i];
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}
__device__ __forceinline__ unsigned pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return (unsigned)__bfloat16_as_ushort(lo) |
         ((unsigned)__bfloat16_as_ushort(hi) << 16);
}

template <typename T, int HD>
__global__ void __launch_bounds__(FP_WARPS * 32) flash_prefill_kernel(
    const T* __restrict__ q,      // (B, S, H, hd)
    const T* __restrict__ k,      // (B, S, K, hd)
    const T* __restrict__ v,      // (B, S, K, hd)
    T* __restrict__ out,          // (B, S, H, hd)
    int S, int K, int G, int causal, int window, float scale) {
  constexpr bool F32 = sizeof(T) == 4;
  constexpr int EPC = 16 / (int)sizeof(T);   // elements per 16-byte chunk
  constexpr int CH = HD / EPC;               // chunks per row
  constexpr int LD = HD + EPC;               // shared row stride (elements)
  // fp32 at hd <= 64: the split Q fragments stay in registers for the
  // whole key loop (2 x hd / 2 registers; at hd 96 to 128 they spill)
  constexpr bool QREG = F32 && HD <= 64;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);    // FP_BM x LD
  T* kvs = qs + FP_BM * LD;                  // 2 stages x (K, V) x FP_BN x LD

  const int qt = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int H = K * G, rows = S * G;
  const int r0 = qt * FP_BM;
  const int p_lo = r0 / G, p_hi = (min(r0 + FP_BM, rows) - 1) / G;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;

  for (int c = tid; c < FP_BM * CH; c += blockDim.x) {
    const int r = c / CH, ch = c - r * CH;
    const int R = r0 + r;
    const bool ok = R < rows;
    const int pos = ok ? R / G : 0, g = ok ? R - pos * G : 0;
    cp_async16(qs + r * LD + ch * EPC,
               q + (((size_t)b * S + pos) * H + kh * G + g) * HD + ch * EPC,
               ok ? 16 : 0);
  }
  auto load_kv = [&](int k0, int st) {
    T* ks = kvs + st * 2 * FP_BN * LD;
    T* vs = ks + FP_BN * LD;
    for (int c = tid; c < FP_BN * CH; c += blockDim.x) {
      const int j = c / CH, ch = c - j * CH;
      const bool ok = k0 + j < S;
      const size_t off =
          (((size_t)b * S + (ok ? k0 + j : 0)) * K + kh) * HD + ch * EPC;
      cp_async16(ks + j * LD + ch * EPC, k + off, ok ? 16 : 0);
      cp_async16(vs + j * LD + ch * EPC, v + off, ok ? 16 : 0);
    }
  };

  // key tiles: skip those wholly before the window / wholly in the future
  int k_begin = 0;
  if (window) k_begin = max(0, p_lo - window + 1) / FP_BN * FP_BN;
  const int k_end = causal ? p_hi + 1 : S;
  load_kv(k_begin, 0);
  cp_async_commit();                  // group 0: the Q tile + first K/V

  const int wr = warp * 16 + gid;     // this lane's rows: wr and wr + 8
  const int qpos0 = (r0 + wr) / G, qpos1 = (r0 + wr + 8) / G;
  float o[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
    o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = NEG_INF_F, m1 = NEG_INF_F, l0 = 0.f, l1 = 0.f;
  // scores in the log2 domain: exp(x - m) = exp2(x log2 e - m log2 e)
  const float scale2 = scale * LOG2E_F;
  unsigned qb[QREG ? HD / 8 : 1][4], qsm[QREG ? HD / 8 : 1][4];

  int st = 0;
  for (int k0 = k_begin; k0 < k_end; k0 += FP_BN, st ^= 1) {
    if (k0 + FP_BN < k_end) {
      load_kv(k0 + FP_BN, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* ks = kvs + st * 2 * FP_BN * LD;
    const T* vs = ks + FP_BN * LD;

    // ---- S = Q K^T ------------------------------------------------------
    float s[FP_BN / 8][4];
#pragma unroll
    for (int j = 0; j < FP_BN / 8; ++j)
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    if constexpr (F32) {
#pragma unroll
      for (int kk = 0; kk < HD / 8; ++kk) {
        const float* qa = reinterpret_cast<const float*>(qs) + wr * LD +
                          kk * 8 + tig;
        float a[4];
        if constexpr (QREG) {
          if (k0 == k_begin) {          // the Q tile has just arrived
            const float qv[4] = {qa[0], qa[8 * LD], qa[4], qa[8 * LD + 4]};
#pragma unroll
            for (int i = 0; i < 4; ++i)
              split_tf32(qv[i], qb[kk][i], qsm[kk][i]);
          }
        } else {
          a[0] = qa[0];
          a[1] = qa[8 * LD];
          a[2] = qa[4];
          a[3] = qa[8 * LD + 4];
        }
#pragma unroll
        for (int j = 0; j < FP_BN / 8; ++j) {
          const float* kb = reinterpret_cast<const float*>(ks) +
                            (j * 8 + gid) * LD + kk * 8 + tig;
          const float bf[2] = {kb[0], kb[4]};
          float c[4] = {0.f, 0.f, 0.f, 0.f};
          if constexpr (QREG) {
            unsigned bb[2], bs[2];
            split_tf32(bf[0], bb[0], bs[0]);
            split_tf32(bf[1], bb[1], bs[1]);
            mma_tf32(c, qsm[kk], bb);
            mma_tf32(c, qb[kk], bs);
            mma_tf32(c, qb[kk], bb);
          } else {
            mma_3xtf32(c, a, bf);
          }
          add4(s[j], c);
        }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const T* qa = qs + wr * LD + kk * 16 + 2 * tig;
        const unsigned a[4] = {
            *reinterpret_cast<const unsigned*>(qa),
            *reinterpret_cast<const unsigned*>(qa + 8 * LD),
            *reinterpret_cast<const unsigned*>(qa + 8),
            *reinterpret_cast<const unsigned*>(qa + 8 * LD + 8)};
#pragma unroll
        for (int j = 0; j < FP_BN / 8; ++j) {
          const T* kb = ks + (j * 8 + gid) * LD + kk * 16 + 2 * tig;
          const unsigned bf[2] = {*reinterpret_cast<const unsigned*>(kb),
                                  *reinterpret_cast<const unsigned*>(kb + 8)};
          mma_bf16(s[j], a, bf);
        }
      }
    }

    // ---- mask, online softmax (rows wr: s[.][0..1], wr + 8: s[.][2..3])
    const bool need_mask = k0 + FP_BN > S ||
                           (causal && k0 + FP_BN - 1 > p_lo) ||
                           (window && k0 <= p_hi - window);
    float mx0 = NEG_INF_F, mx1 = NEG_INF_F;
#pragma unroll
    for (int j = 0; j < FP_BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale2;
        if (need_mask) {
          const int kpos = k0 + j * 8 + 2 * tig + (e & 1);
          const int qpos = e < 2 ? qpos0 : qpos1;
          const bool ok = kpos < S && (!causal || kpos <= qpos) &&
                          (!window || kpos > qpos - window);
          if (!ok) x = NEG_INF_F;
        }
        s[j][e] = x;
      }
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int o2 = 1; o2 <= 2; o2 <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o2));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float al0 = exp2f(m0 - mn0), al1 = exp2f(m1 - mn1);
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < FP_BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float mn = e < 2 ? mn0 : mn1;
        s[j][e] = s[j][e] <= NEG_INF_F ? 0.f : exp2f(s[j][e] - mn);
      }
      sum0 += s[j][0] + s[j][1];
      sum1 += s[j][2] + s[j][3];
    }
#pragma unroll
    for (int o2 = 1; o2 <= 2; o2 <<= 1) {
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, o2);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, o2);
    }
    l0 = l0 * al0 + sum0;
    l1 = l1 * al1 + sum1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      o[n][0] *= al0;
      o[n][1] *= al0;
      o[n][2] *= al1;
      o[n][3] *= al1;
    }

    // ---- O += P V ---------------------------------------------------------
    if constexpr (F32) {
      const float* vf = reinterpret_cast<const float*>(vs);
#pragma unroll
      for (int kk = 0; kk < FP_BN / 8; ++kk) {
        // k-step keys in the order 0,2,4,6,1,3,5,7: A column tig is key
        // 2 tig, column tig + 4 is key 2 tig + 1 (the lane's own scores)
        const float a[4] = {s[kk][0], s[kk][2], s[kk][1], s[kk][3]};
        const float* vb = vf + (kk * 8 + 2 * tig) * LD + gid;
#pragma unroll
        for (int n = 0; n < HD / 8; ++n) {
          const float bf[2] = {vb[n * 8], vb[n * 8 + LD]};
          float c[4] = {0.f, 0.f, 0.f, 0.f};
          mma_3xtf32(c, a, bf);
          add4(o[n], c);
        }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < FP_BN / 16; ++kk) {
        const unsigned a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                               pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                               pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                               pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
        const T* vb = vs + (kk * 16 + 2 * tig) * LD + gid;
#pragma unroll
        for (int n = 0; n < HD / 8; ++n) {
          const T* c = vb + n * 8;
          const unsigned bf[2] = {pack_bf16(c[0], c[LD]),
                                  pack_bf16(c[8 * LD], c[9 * LD])};
          mma_bf16(o[n], a, bf);
        }
      }
    }
    __syncthreads();                  // stage st is free for tile j + 2
  }

  // ---- epilogue: rows wr, wr + 8; cols 8n + 2 tig, + 1 -------------------
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int R = r0 + wr + 8 * half;
    if (R >= rows) continue;
    const int pos = R / G, g = R - pos * G;
    const float denom = fmaxf(half ? l1 : l0, L_MIN_F);
    T* dst = out + (((size_t)b * S + pos) * H + kh * G + g) * HD + 2 * tig;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      const float x = o[n][2 * half] / denom, y = o[n][2 * half + 1] / denom;
      if constexpr (F32) {
        *reinterpret_cast<float2*>(dst + n * 8) = make_float2(x, y);
      } else {
        *reinterpret_cast<__nv_bfloat162*>(dst + n * 8) =
            __floats2bfloat162_rn(x, y);
      }
    }
  }
}

template <typename T, int HD>
static int launch(const void* q, const void* k, const void* v, void* out,
                  int B, int S, int K, int G, int causal, int window,
                  float scale, cudaStream_t stream) {
  constexpr int LD = HD + 16 / (int)sizeof(T);
  const size_t smem = sizeof(T) * (size_t)(FP_BM + 4 * FP_BN) * LD;
  auto kern = flash_prefill_kernel<T, HD>;
  static size_t smem_allowed = 0;       // this instance's raised cap
  if (smem > smem_allowed) {
    cudaError_t e = allow_smem(kern, smem);
    if (e != cudaSuccess) return (int)e;
    smem_allowed = smem;
  }
  dim3 grid((S * G + FP_BM - 1) / FP_BM, K, B);
  kern<<<grid, FP_WARPS * 32, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, S, K, G, causal, window,
      scale);
  return (int)cudaGetLastError();
}

template <typename T>
static int dispatch(const void* q, const void* k, const void* v, void* out,
                    int B, int S, int K, int G, int hd, int causal,
                    int window, float scale, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<T, 32>(q, k, v, out, B, S, K, G, causal, window, scale, stream);
    case 64: return launch<T, 64>(q, k, v, out, B, S, K, G, causal, window, scale, stream);
    case 96: return launch<T, 96>(q, k, v, out, B, S, K, G, causal, window, scale, stream);
    case 112: return launch<T, 112>(q, k, v, out, B, S, K, G, causal, window, scale, stream);
    case 128: return launch<T, 128>(q, k, v, out, B, S, K, G, causal, window, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// C entry point (loaded with ctypes).  The Python wrapper checks shapes
// (hd in {32, 64, 96, 112, 128}, G >= 1), types, contiguity and 16-byte
// alignment.  Returns the launch's cudaError_t (0 = success).
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
