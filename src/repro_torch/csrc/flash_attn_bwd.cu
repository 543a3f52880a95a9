// Backward of fused softmax attention (flash attention) for Hopper
// (sm_90a): dQ, dK and dV from Q, K, V, the output O, its cotangent dO and
// the forward's per-row log-sum-exp, bfloat16 on the tensor cores
// (mma.sync m16n8k16, float32 accumulators), float32 as 3xTF32 mma.sync
// (m16n8k8, the operands split into a TF32 high and low part).
//
// Replaces no Pallas kernel: the reference's Pallas flash kernel has no
// backward, and its model attention differentiates through
// repro/models/layers.py::_flash_bwd, the custom_vjp of _flash_attention
// written in plain jnp, which recomputes P from the log-sum-exp.  These
// kernels compute the same arithmetic:
//   delta = rowsum(dO o O), P = exp(S scale - lse) under the mask,
//   dV = P^T dO, dS = P o (dO V^T - delta) scale, dQ = dS K, dK = dS^T Q,
// with dK and dV summed over the G = H / H_kv query heads of each KV head.
// Three kernels:
//   flash_bwd_delta_kernel  rowsum(dO o O) in float32, one warp a row;
//   flash_bwd_dkdv_kernel   a block per (batch, KV head, 64-row kv tile):
//                           it keeps K and V in shared memory and walks the
//                           group's G query heads and, in each, the query
//                           tiles that the causal mask or the window lets
//                           meet the tile, recomputing S and P from lse and
//                           accumulating dK and dV in float32 registers;
//   flash_bwd_dq_kernel     a block per (batch, head, 64-row query tile):
//                           it keeps Q and dO and walks the kv tiles,
//                           recomputing P and dS, dQ in float32 registers.
// Splitting dQ from dK and dV costs two recomputed products (S and dO V^T
// in both kernels) but needs no atomics: every sum is taken in one order,
// so dQ, dK and dV are bitwise the same from run to run.
//
// Layout: q, o, dO and dq (B, S, H, D), k, v, dk and dv (B, S, H_kv, D),
// query head h reading KV head h / G in place (the forward's grouping);
// lse and delta (B, H, S) float32.  Rows past S and columns past D are
// zero-filled in shared memory and masked, so any S and D <= 128 work (D
// is padded to 64 or 128).  A block is 8 warps: for the 64 x 64 score
// tiles warp w takes query rows 16 (w % 4) and keys 32 (w / 4); for the
// 64 x D products rows 16 (w % 4) and columns D / 2 (w / 4).  P and dS go
// to shared memory (in the input type: bfloat16 rounds them once, as
// FlashAttention does; float32 keeps them) for the products that read
// them transposed.  Fragments come from padded shared-memory rows by
// ldmatrix (bfloat16) or 32-bit loads (float32).
//
// Bound: operations.  The five products are 5 x 2 D per (query, key) pair
// the mask keeps: a causal backward at S = 4096, 20 heads of 128 is 214.8
// GFLOP, 217 us at the bf16 tensor-core rate, against 168 MB (50 us).  A
// simple kernel first: tiles are loaded synchronously (no cp.async ring,
// no wgmma, no TMA), which later work can add.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;
constexpr int BT = 64;                  // rows of a query or kv tile
constexpr int BWD_THREADS = 256;        // 8 warps
constexpr float kLog2eBwd = 1.4426950408889634f;

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16_rn(x);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// A warp's tile products.  A is 16 x K (the warp's rows), B is K x 8; the
// accumulator c holds element 2 h + i at row g + 8 h, column 2 t + i (g =
// lane / 4, t = lane % 4).  load_a<TRANS>: A(m, k) at s[m ld + k] (TRANS:
// s[k ld + m]), rows m0.., columns k0..; load_b<NK>: B(k, n) at s[n ld + k]
// (NK) or s[k ld + n], rows k0.., columns n0...
template <typename T>
struct Mma;

template <>
struct Mma<bf16> {
  static constexpr int K = 16;
  struct A { uint32_t r[4]; };
  struct B { uint32_t r[2]; };
  template <bool TRANS>
  __device__ static A load_a(const bf16* s, int ld, int m0, int k0) {
    const int lane = threadIdx.x % 32, mat = lane / 8, r = lane % 8;
    A a;
    if (!TRANS) {
      // matrices (rows 0-7 | 8-15) x (k 0-7 | 8-15): a0a1, a2a3, a4a5, a6a7
      const bf16* p = s + (m0 + r + 8 * (mat % 2)) * ld + k0 + 8 * (mat / 2);
      asm volatile(
          "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
          : "=r"(a.r[0]), "=r"(a.r[1]), "=r"(a.r[2]), "=r"(a.r[3])
          : "r"(saddr(p))
          : "memory");
    } else {
      const bf16* p = s + (k0 + r + 8 * (mat / 2)) * ld + m0 + 8 * (mat % 2);
      asm volatile(
          "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
          "[%4];\n"
          : "=r"(a.r[0]), "=r"(a.r[1]), "=r"(a.r[2]), "=r"(a.r[3])
          : "r"(saddr(p))
          : "memory");
    }
    return a;
  }
  template <bool NK>
  __device__ static B load_b(const bf16* s, int ld, int k0, int n0) {
    const int l = threadIdx.x % 16;
    B b;
    if (NK) {
      const bf16* p = s + (n0 + l % 8) * ld + k0 + 8 * (l / 8);
      asm volatile(
          "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
          : "=r"(b.r[0]), "=r"(b.r[1])
          : "r"(saddr(p))
          : "memory");
    } else {
      const bf16* p = s + (k0 + l) * ld + n0;
      asm volatile(
          "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
          : "=r"(b.r[0]), "=r"(b.r[1])
          : "r"(saddr(p))
          : "memory");
    }
    return b;
  }
  __device__ static void mma(float (&c)[4], const A& a, const B& b) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a.r[0]), "r"(a.r[1]), "r"(a.r[2]), "r"(a.r[3]), "r"(b.r[0]),
          "r"(b.r[1]));
  }
};

// x rounded to TF32 (hi) and the TF32 rounding of what is left (lo)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  const float rest = x - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(rest));
}

template <>
struct Mma<float> {
  static constexpr int K = 8;
  struct A { uint32_t hi[4], lo[4]; };
  struct B { uint32_t hi[2], lo[2]; };
  // m16n8k8 TF32 fragments: a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
  // a3 (g + 8, t + 4); b0 (k t, n g), b1 (k t + 4, n g)
  template <bool TRANS>
  __device__ static A load_a(const float* s, int ld, int m0, int k0) {
    const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
    auto at = [&](int m, int kk) {
      return TRANS ? s[kk * ld + m] : s[m * ld + kk];
    };
    const float x[4] = {at(m0 + g, k0 + t), at(m0 + g + 8, k0 + t),
                        at(m0 + g, k0 + t + 4), at(m0 + g + 8, k0 + t + 4)};
    A a;
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(x[i], a.hi[i], a.lo[i]);
    return a;
  }
  template <bool NK>
  __device__ static B load_b(const float* s, int ld, int k0, int n0) {
    const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
    auto at = [&](int kk, int n) {
      return NK ? s[n * ld + kk] : s[kk * ld + n];
    };
    const float x[2] = {at(k0 + t, n0 + g), at(k0 + t + 4, n0 + g)};
    B b;
#pragma unroll
    for (int i = 0; i < 2; ++i) split_tf32(x[i], b.hi[i], b.lo[i]);
    return b;
  }
  __device__ static void mma1(float (&c)[4], const uint32_t (&a)[4],
                              const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  // a b ~ a_lo b_hi + a_hi b_lo + a_hi b_hi, small terms first
  __device__ static void mma(float (&c)[4], const A& a, const B& b) {
    mma1(c, a.lo, b.hi);
    mma1(c, a.hi, b.lo);
    mma1(c, a.hi, b.hi);
  }
};

// shared-memory rows padded by 16 bytes: ldmatrix rows stay 16-byte
// aligned and 8 consecutive rows fall on distinct banks
template <typename T, int DP>
struct BwdSmem {
  static constexpr int kPad = 16 / sizeof(T);
  static constexpr int LD = DP + kPad;           // a 64 x DP tile's rows
  static constexpr int LDP = BT + kPad;          // a 64 x 64 tile's rows
  static constexpr int kTile = BT * LD, kSq = BT * LDP;   // elements
  // K, V, Q, dO; P, dS; lse and delta of the query tile
  static constexpr int kBytes =
      (4 * kTile + 2 * kSq) * static_cast<int>(sizeof(T)) + 2 * BT * 4;
};

// rows r0 .. r0 + 63 of one head of a (B, S, heads, D) tensor (g: its row
// 0, rows rs elements apart) into s (64 x DP, rows ld apart), zeros past S
// and D; vec: D a multiple of 16 bytes and 16-byte aligned rows
template <typename T, int DP>
__device__ void load_tile(T* s, int ld, const T* g, int64_t rs, int r0,
                          int S, int D, int vec) {
  if (vec) {
    constexpr int V = 16 / sizeof(T), NC = DP / V;
    for (int i = threadIdx.x; i < BT * NC; i += BWD_THREADS) {
      const int r = i / NC, c = (i % NC) * V;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (r0 + r < S && c < D) {
        val = *reinterpret_cast<const uint4*>(g + (r0 + r) * rs + c);
      }
      *reinterpret_cast<uint4*>(s + r * ld + c) = val;
    }
  } else {
    for (int i = threadIdx.x; i < BT * DP; i += BWD_THREADS) {
      const int r = i / DP, c = i % DP;
      s[r * ld + c] = (r0 + r < S && c < D) ? g[(r0 + r) * rs + c]
                                            : from_f32<T>(0.f);
    }
  }
}

// lse and delta of query rows q0 .. q0 + 63 (zeros past S)
__device__ __forceinline__ void load_rows(float* s_lse, float* s_delta,
                                          const float* lse,
                                          const float* delta, int q0,
                                          int S) {
  if (threadIdx.x < BT) {
    const int r = q0 + threadIdx.x;
    s_lse[threadIdx.x] = r < S ? lse[r] : 0.f;
    s_delta[threadIdx.x] = r < S ? delta[r] : 0.f;
  }
}

// S = Q K^T and dP = dO V^T of the staged tiles (this warp's 16 query rows
// by 32 keys), then P = exp(S scale - lse) and dS = P (dP - delta) scale
// under the mask (zero elsewhere) into sP (when not null) and sdS
template <typename T, int DP>
__device__ __forceinline__ void scores(const T* sQ, const T* sdO,
                                       const T* sK, const T* sV, T* sP,
                                       T* sdS, const float* s_lse,
                                       const float* s_delta, int q0, int k0,
                                       int S, float scale, int causal,
                                       int window) {
  using M = Mma<T>;
  using L = BwdSmem<T, DP>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wr = warp % 4, wc = warp / 4, g = lane / 4, t = lane % 4;
  float s_acc[4][4] = {}, dp_acc[4][4] = {};
#pragma unroll
  for (int kk = 0; kk < DP; kk += M::K) {
    const auto aq = M::template load_a<false>(sQ, L::LD, 16 * wr, kk);
    const auto ad = M::template load_a<false>(sdO, L::LD, 16 * wr, kk);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int n0 = 32 * wc + 8 * nt;
      M::mma(s_acc[nt], aq, M::template load_b<true>(sK, L::LD, kk, n0));
      M::mma(dp_acc[nt], ad, M::template load_b<true>(sV, L::LD, kk, n0));
    }
  }
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = 16 * wr + g + 8 * hh, c = 32 * wc + 8 * nt + 2 * t;
      const int qi = q0 + r;
      float p[2], ds[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int kj = k0 + c + i;
        const bool keep = qi < S && kj < S && (!causal || kj <= qi) &&
                          (!window || kj > qi - window);
        p[i] = keep ? expf(s_acc[nt][2 * hh + i] * scale - s_lse[r]) : 0.f;
        ds[i] = p[i] * (dp_acc[nt][2 * hh + i] - s_delta[r]) * scale;
      }
      if (sP != nullptr) store2(sP + r * L::LDP + c, p[0], p[1]);
      store2(sdS + r * L::LDP + c, ds[0], ds[1]);
    }
  }
}

// this warp's accumulator of 16 rows by DP / 2 columns to rows r0.. of one
// head of a (B, S, heads, D) tensor (g: its row 0, rows rs apart)
template <typename T, int DP>
__device__ __forceinline__ void store_rows(T* out, int64_t rs,
                                           const float (&acc)[DP / 16][4],
                                           int r0, int S, int D) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wr = warp % 4, wc = warp / 4, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = r0 + 16 * wr + g + 8 * hh;
    if (r >= S) continue;
#pragma unroll
    for (int nt = 0; nt < DP / 16; ++nt) {
      const int c = (DP / 2) * wc + 8 * nt + 2 * t;
      if (c < D) out[r * rs + c] = from_f32<T>(acc[nt][2 * hh]);
      if (c + 1 < D) out[r * rs + c + 1] = from_f32<T>(acc[nt][2 * hh + 1]);
    }
  }
}

}  // namespace

// delta (B, H, S) = rowsum(dO o O) in float32: one warp a (b, s, h) row
template <typename T>
__global__ void __launch_bounds__(BWD_THREADS)
    flash_bwd_delta_kernel(const T* __restrict__ o,
                           const T* __restrict__ dout,
                           float* __restrict__ delta, int64_t rows, int S,
                           int H, int D) {
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * (BWD_THREADS / 32) + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  const T* po = o + row * D;
  const T* pd = dout + row * D;
  float acc = 0.f;
  for (int c = lane; c < D; c += 32) acc += to_f32(po[c]) * to_f32(pd[c]);
#pragma unroll
  for (int w = 16; w > 0; w /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, w);
  if (lane == 0) {
    const int h = static_cast<int>(row % H);
    const int64_t bs = row / H;
    const int s = static_cast<int>(bs % S);
    const int64_t b = bs / S;
    delta[(b * H + h) * S + s] = acc;
  }
}

// A block per (batch x KV head, kv tile): dK and dV of the tile, summed
// over the group's G query heads and every query tile that meets it
template <typename T, int DP>
__global__ void __launch_bounds__(BWD_THREADS)
    flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v,
                          const T* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          T* __restrict__ dk, T* __restrict__ dv, int S,
                          int H, int Hkv, int D, float scale, int causal,
                          int window, int vec) {
  using M = Mma<T>;
  using L = BwdSmem<T, DP>;
  extern __shared__ __align__(16) uint8_t smem_bwd[];
  T* sK = reinterpret_cast<T*>(smem_bwd);
  T* sV = sK + L::kTile;
  T* sQ = sV + L::kTile;
  T* sdO = sQ + L::kTile;
  T* sP = sdO + L::kTile;
  T* sdS = sP + L::kSq;
  float* s_lse = reinterpret_cast<float*>(sdS + L::kSq);
  float* s_delta = s_lse + BT;

  const int k0 = blockIdx.x * BT;   // low tiles meet the most queries: first
  const int b = blockIdx.y / Hkv, hk = blockIdx.y % Hkv, G = H / Hkv;
  const int64_t qrs = static_cast<int64_t>(H) * D;
  const int64_t krs = static_cast<int64_t>(Hkv) * D;
  const int64_t kbase = (static_cast<int64_t>(b) * S * Hkv + hk) * D;
  const int warp = threadIdx.x / 32;
  const int wr = warp % 4, wc = warp / 4;
  float dk_acc[DP / 16][4] = {}, dv_acc[DP / 16][4] = {};

  load_tile<T, DP>(sK, L::LD, k + kbase, krs, k0, S, D, vec);
  load_tile<T, DP>(sV, L::LD, v + kbase, krs, k0, S, D, vec);
  // the query tiles that meet keys k0 .. k0 + 63: from the diagonal (causal)
  // to the last query within the window of the tile's last key
  const int n_q = (S + BT - 1) / BT;
  const int qt_lo = causal ? k0 / BT : 0;
  const int qt_hi = window ? min(n_q, (k0 + BT - 2 + window) / BT + 1) : n_q;
  for (int gi = 0; gi < G; ++gi) {
    const int h = hk * G + gi;
    const int64_t qbase = (static_cast<int64_t>(b) * S * H + h) * D;
    const int64_t rbase = (static_cast<int64_t>(b) * H + h) * S;
    for (int qt = qt_lo; qt < qt_hi; ++qt) {
      const int q0 = qt * BT;
      __syncthreads();               // the last tile's readers are done
      load_tile<T, DP>(sQ, L::LD, q + qbase, qrs, q0, S, D, vec);
      load_tile<T, DP>(sdO, L::LD, dout + qbase, qrs, q0, S, D, vec);
      load_rows(s_lse, s_delta, lse + rbase, delta + rbase, q0, S);
      __syncthreads();
      scores<T, DP>(sQ, sdO, sK, sV, sP, sdS, s_lse, s_delta, q0, k0, S,
                    scale, causal, window);
      __syncthreads();
      // dV += P^T dO, dK += dS^T Q: this warp's 16 keys by DP / 2 columns
#pragma unroll
      for (int kk = 0; kk < BT; kk += M::K) {
        const auto ap = M::template load_a<true>(sP, L::LDP, 16 * wr, kk);
        const auto as = M::template load_a<true>(sdS, L::LDP, 16 * wr, kk);
#pragma unroll
        for (int nt = 0; nt < DP / 16; ++nt) {
          const int n0 = (DP / 2) * wc + 8 * nt;
          M::mma(dv_acc[nt], ap,
                 M::template load_b<false>(sdO, L::LD, kk, n0));
          M::mma(dk_acc[nt], as,
                 M::template load_b<false>(sQ, L::LD, kk, n0));
        }
      }
    }
  }
  store_rows<T, DP>(dk + kbase, krs, dk_acc, k0, S, D);
  store_rows<T, DP>(dv + kbase, krs, dv_acc, k0, S, D);
}

// A block per (batch x head, query tile): dQ of the tile over every kv
// tile that meets it
template <typename T, int DP>
__global__ void __launch_bounds__(BWD_THREADS)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        int S, int H, int Hkv, int D, float scale,
                        int causal, int window, int vec) {
  using M = Mma<T>;
  using L = BwdSmem<T, DP>;
  extern __shared__ __align__(16) uint8_t smem_bwd[];
  T* sK = reinterpret_cast<T*>(smem_bwd);
  T* sV = sK + L::kTile;
  T* sQ = sV + L::kTile;
  T* sdO = sQ + L::kTile;
  T* sdS = sdO + L::kTile + L::kSq;
  float* s_lse = reinterpret_cast<float*>(sdS + L::kSq);
  float* s_delta = s_lse + BT;

  const int n_q = (S + BT - 1) / BT;
  const int q0 = (n_q - 1 - blockIdx.x) * BT;     // longest first
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int64_t qrs = static_cast<int64_t>(H) * D;
  const int64_t krs = static_cast<int64_t>(Hkv) * D;
  const int64_t qbase = (static_cast<int64_t>(b) * S * H + h) * D;
  const int64_t kbase =
      (static_cast<int64_t>(b) * S * Hkv + h / (H / Hkv)) * D;
  const int64_t rbase = (static_cast<int64_t>(b) * H + h) * S;
  const int warp = threadIdx.x / 32;
  const int wr = warp % 4, wc = warp / 4;
  float dq_acc[DP / 16][4] = {};

  load_tile<T, DP>(sQ, L::LD, q + qbase, qrs, q0, S, D, vec);
  load_tile<T, DP>(sdO, L::LD, dout + qbase, qrs, q0, S, D, vec);
  load_rows(s_lse, s_delta, lse + rbase, delta + rbase, q0, S);
  // kv tiles from the first inside the window of the tile's first query to
  // the last below the diagonal (causal)
  const int n_k = (S + BT - 1) / BT;
  const int kt_lo = window ? max(0, q0 - window + 1) / BT : 0;
  const int kt_hi = causal ? min(n_k, (q0 + BT - 1) / BT + 1) : n_k;
  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * BT;
    __syncthreads();                 // the last tile's readers are done
    load_tile<T, DP>(sK, L::LD, k + kbase, krs, k0, S, D, vec);
    load_tile<T, DP>(sV, L::LD, v + kbase, krs, k0, S, D, vec);
    __syncthreads();
    scores<T, DP>(sQ, sdO, sK, sV, nullptr, sdS, s_lse, s_delta, q0, k0, S,
                  scale, causal, window);
    __syncthreads();
    // dQ += dS K: this warp's 16 query rows by DP / 2 columns
#pragma unroll
    for (int kk = 0; kk < BT; kk += M::K) {
      const auto as = M::template load_a<false>(sdS, L::LDP, 16 * wr, kk);
#pragma unroll
      for (int nt = 0; nt < DP / 16; ++nt) {
        M::mma(dq_acc[nt], as,
               M::template load_b<false>(sK, L::LD, kk, (DP / 2) * wc +
                                                        8 * nt));
      }
    }
  }
  store_rows<T, DP>(dq + qbase, qrs, dq_acc, q0, S, D);
}

namespace {

template <typename Kernel>
cudaError_t allow_smem_bwd(Kernel kernel, int bytes, bool& configured) {
  if (configured) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  configured = err == cudaSuccess;
  return err;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T, int DP>
int launch_dkdv(const void* q, const void* k, const void* v,
                const void* dout, const float* lse, const float* delta,
                void* dk, void* dv, int B, int S, int H, int Hkv, int D,
                float scale, int causal, int window, int vec,
                cudaStream_t st) {
  auto kernel = flash_bwd_dkdv_kernel<T, DP>;
  constexpr int smem = BwdSmem<T, DP>::kBytes;
  static bool configured = false;
  const cudaError_t err = allow_smem_bwd(kernel, smem, configured);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + BT - 1) / BT, B * Hkv);
  kernel<<<grid, BWD_THREADS, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), S, H, Hkv, D, scale, causal,
      window, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DP>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dq, int B, int S,
              int H, int Hkv, int D, float scale, int causal, int window,
              int vec, cudaStream_t st) {
  auto kernel = flash_bwd_dq_kernel<T, DP>;
  constexpr int smem = BwdSmem<T, DP>::kBytes;
  static bool configured = false;
  const cudaError_t err = allow_smem_bwd(kernel, smem, configured);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + BT - 1) / BT, B * H);
  kernel<<<grid, BWD_THREADS, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), S, H, Hkv, D, scale, causal, window, vec);
  return static_cast<int>(cudaGetLastError());
}

// 16-byte loads where D fills whole 16-byte chunks and every row is aligned
int use_vec(int D, int elem, const void* a, const void* b, const void* c,
            const void* d) {
  return D % (16 / elem) == 0 && aligned16(a) && aligned16(b) &&
         aligned16(c) && aligned16(d);
}

}  // namespace

// delta (B, H, S) float32 = rowsum(dO o O); o, dout (B, S, H, D)
extern "C" int repro_flash_bwd_delta(const void* o, const void* dout,
                                     void* delta, int32_t B, int32_t S,
                                     int32_t H, int32_t D, int32_t bf16_in,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t rows = static_cast<int64_t>(B) * S * H;
  const int64_t blocks = (rows + BWD_THREADS / 32 - 1) / (BWD_THREADS / 32);
  if (blocks == 0) return 0;
  if (bf16_in) {
    flash_bwd_delta_kernel<bf16><<<blocks, BWD_THREADS, 0, st>>>(
        static_cast<const bf16*>(o), static_cast<const bf16*>(dout),
        static_cast<float*>(delta), rows, S, H, D);
  } else {
    flash_bwd_delta_kernel<float><<<blocks, BWD_THREADS, 0, st>>>(
        static_cast<const float*>(o), static_cast<const float*>(dout),
        static_cast<float*>(delta), rows, S, H, D);
  }
  return static_cast<int>(cudaGetLastError());
}

// dk, dv (B, S, Hkv, D) from q, dout (B, S, H, D), k, v (B, S, Hkv, D),
// lse and delta (B, H, S); D <= 128, H % Hkv == 0; window > 0: query i
// sees keys j > i - window only
extern "C" int repro_flash_bwd_dkdv(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const void* lse, const void* delta,
                                    void* dk, void* dv, int32_t B, int32_t S,
                                    int32_t H, int32_t Hkv, int32_t D,
                                    float scale, int32_t causal,
                                    int32_t window, int32_t bf16_in,
                                    void* stream) {
  if (D < 1 || D > 128) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* ls = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  const int elem = bf16_in ? 2 : 4;
  const int vec = use_vec(D, elem, q, k, v, dout);
  if (bf16_in) {
    return D <= 64 ? launch_dkdv<bf16, 64>(q, k, v, dout, ls, dl, dk, dv, B,
                                           S, H, Hkv, D, scale, causal,
                                           window, vec, st)
                   : launch_dkdv<bf16, 128>(q, k, v, dout, ls, dl, dk, dv, B,
                                            S, H, Hkv, D, scale, causal,
                                            window, vec, st);
  }
  return D <= 64 ? launch_dkdv<float, 64>(q, k, v, dout, ls, dl, dk, dv, B,
                                          S, H, Hkv, D, scale, causal,
                                          window, vec, st)
                 : launch_dkdv<float, 128>(q, k, v, dout, ls, dl, dk, dv, B,
                                           S, H, Hkv, D, scale, causal,
                                           window, vec, st);
}

// dq (B, S, H, D), the same inputs as repro_flash_bwd_dkdv
extern "C" int repro_flash_bwd_dq(const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const void* lse, const void* delta,
                                  void* dq, int32_t B, int32_t S, int32_t H,
                                  int32_t Hkv, int32_t D, float scale,
                                  int32_t causal, int32_t window,
                                  int32_t bf16_in, void* stream) {
  if (D < 1 || D > 128) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* ls = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  const int elem = bf16_in ? 2 : 4;
  const int vec = use_vec(D, elem, q, k, v, dout);
  if (bf16_in) {
    return D <= 64 ? launch_dq<bf16, 64>(q, k, v, dout, ls, dl, dq, B, S, H,
                                         Hkv, D, scale, causal, window, vec,
                                         st)
                   : launch_dq<bf16, 128>(q, k, v, dout, ls, dl, dq, B, S, H,
                                          Hkv, D, scale, causal, window, vec,
                                          st);
  }
  return D <= 64 ? launch_dq<float, 64>(q, k, v, dout, ls, dl, dq, B, S, H,
                                        Hkv, D, scale, causal, window, vec,
                                        st)
                 : launch_dq<float, 128>(q, k, v, dout, ls, dl, dq, B, S, H,
                                         Hkv, D, scale, causal, window, vec,
                                         st);
}
