// Backward of fused softmax attention (flash attention) for Hopper
// (sm_90a): dQ, dK and dV from Q, K, V, the output O, its cotangent dO and
// the forward's per-row log-sum-exp.  Five routes, chosen by the wrapper
// (flash_attn/ops.py::bwd_route) by dtype, head size and layout alone:
//   wgmma  bfloat16 with D % 8 == 0 (D <= 128), contiguous, 16-byte
//          aligned bases (every LM path): warp-specialised kernels on
//          bf16 wgmma fed by TMA, below;
//   wgmma_d256  the same at 128 < D <= 256 (RecurrentGemma's local
//          attention): flash_attn_bwd_d256.cu's dK/dV and dQ kernels,
//          with this file's row pass (flash_bwd_prep_kernel) and sum
//          pass;
//   mma    the rest of bfloat16 at D <= 128 (D % 8 != 0 or unaligned
//          rows, which TMA cannot read): mma.sync m16n8k16 kernels;
//   d256   the rest of 128 < D <= 256, float32 and bfloat16 off the
//          wgmma_d256 conditions: the mma route's kernels at D 256,
//          bfloat16 on m16n8k16 with 64-row tiles, float32 on 3xTF32
//          m16n8k8 with 32-row tiles;
//   tf32   float32 at D <= 128: flash_attn_bwd_tf32.cu's 3xTF32 wgmma
//          kernels, with this file's row pass (flash_bwd_delta_kernel)
//          and sum pass (flash_bwd_reduce_kernel) in float32.
//
// Replaces no Pallas kernel: the reference's Pallas flash kernel has no
// backward, and its model attention differentiates through
// repro/models/layers.py::_flash_bwd, the custom_vjp of _flash_attention
// written in plain jnp, which recomputes P from the log-sum-exp.  These
// kernels compute the same arithmetic:
//   delta = rowsum(dO o O), P = exp(S scale - lse) under the mask,
//   dV = P^T dO, dS = P o (dO V^T - delta) scale, dQ = dS K, dK = dS^T Q,
// with dK and dV summed over the G = H / H_kv query heads of each KV head.
// dQ is computed apart from dK and dV (two recomputed products, S and dO
// V^T, 7 products for 5) so that no sum needs atomics: every sum is taken
// in an order fixed by the shape, and dQ, dK and dV are bitwise the same
// from run to run.  Layout: q, o, dO and dq (B, S, H, D), k, v, dk and dv
// (B, S, H_kv, D), query head h reading KV head h / G in place (the
// forward's grouping); lse (B, H, S) float32.
//
// Bound: operations.  The five products are 5 x 2 D per (query, key) pair
// the mask keeps: a causal backward at S = 4096, 20 heads of 128 is 214.8
// GFLOP, 217 us at the bf16 tensor-core rate, against 168 MB (50 us).
//
// The wgmma route (four kernels, the sum pass at H_kv < H only):
//   flash_bwd_prep_kernel  lse log2(e) and delta = rowsum(dO o O) of each
//                          row, float32, (B, H, S_pad) with S_pad a
//                          multiple of 128 and zeros past S, so that TMA
//                          brings a tile's 64 rows in as one 256-byte bulk
//                          copy each;
//   flash_bwd_dkdv_wgmma_kernel  a block per (batch, query head, 128 kv
//                          rows), kv tile index slowest (the causal
//                          triangle's long tiles start first): a producer
//                          warpgroup whose one thread brings K and V of the
//                          block's rows in once and streams the query tiles
//                          that meet them (Q, dO, their lse and delta rows)
//                          through a 3-stage ring by TMA against full /
//                          empty mbarriers, and two consumer warpgroups of
//                          64 kv rows (setmaxnreg: 24 / 240 registers).  A
//                          consumer computes S^T = K Q^T and dP^T = V dO^T
//                          with the kv rows as wgmma's M (m64n64k16, both
//                          operands K-major in shared memory), P^T =
//                          exp2(S^T scale log2(e) - lse log2(e)) under the
//                          mask (edge tiles only) and dS^T = P^T (dP^T -
//                          delta) scale in registers, rounded to bf16 once
//                          in the accumulator's layout, which is wgmma's
//                          register A operand: dV += P^T dO and dK += dS^T
//                          Q read Q and dO MN-major (the transpose bit)
//                          from the same swizzled tiles.  No round trip
//                          through shared memory, no __syncthreads in the
//                          loop.  dK and dV stay in float32 registers (128
//                          a thread at D 128).  At H_kv == H it writes them
//                          in bf16; at H_kv < H it writes the head's float32
//                          dK and dV to a scratch (2, B, S, H, D), and
//   flash_bwd_reduce_kernel  sums each KV head's G partials in head order
//                          and rounds once: the group is split across
//                          blocks (GLM-4-9B's 16 heads a KV head fill the
//                          card) and still sums in a fixed order;
//   flash_bwd_dq_wgmma_kernel  a block per (batch, head, 128 query rows),
//                          the longest first: Q and dO of the block's rows
//                          in once, the kv tiles that meet them streamed
//                          through the ring; S = Q K^T and dP = dO V^T, P
//                          and dS in registers, dQ += dS K with K read
//                          MN-major.
// A tile wholly behind the window or above the diagonal for one consumer
// is skipped there (P = 0).  Each consumer is compiled for its index and
// builds its descriptors from 32-bit addresses, and every register operand
// and accumulator of a wgmma is fenced until its wait, so ptxas keeps the
// wgmma pipeline (no C7510-C7515 note).
//
// The mma route (three kernels):
//   flash_bwd_delta_kernel  rowsum(dO o O) in float32, one warp a row (the
//                           tf32 route's row pass too);
//   flash_bwd_dkdv_kernel   a block per (batch, KV head, 64-row kv tile):
//                           it keeps K and V in shared memory and walks the
//                           group's G query heads and, in each, the query
//                           tiles that the causal mask or the window lets
//                           meet the tile, recomputing S and P from lse and
//                           accumulating dK and dV in float32 registers
//                           (bf16 products are exact in float32; the tf32
//                           route splits the group instead: the tensor
//                           cores' float32 accumulation truncates, and one
//                           accumulator over a group's G S / 8 TF32 k steps
//                           passed the float32 limit at G 8);
//   flash_bwd_dq_kernel     a block per (batch, head, 64-row query tile):
//                           it keeps Q and dO and walks the kv tiles,
//                           recomputing P and dS, dQ in float32 registers.
// Rows past S and columns past D are zero-filled in shared memory and
// masked, so any S and D <= 128 work (D is padded to 64 or 128).  A block
// is 8 warps: for the 64 x 64 score tiles warp w takes query rows 16 (w %
// 4) and keys 32 (w / 4); for the 64 x D products rows 16 (w % 4) and
// columns D / 2 (w / 4).  P and dS go to shared memory (in bfloat16:
// rounded once, as FlashAttention does) for the products that read them
// transposed.  Fragments come from padded shared-memory rows by ldmatrix;
// tiles are loaded synchronously.
//
// The d256 route (three kernels, four at H_kv < H): delta, the mma
// route's dK/dV and dQ kernels instantiated at D 256, and with H_kv < H
// flash_bwd_reduce_kernel.  bfloat16 keeps the 64-row tiles (K, V, Q and
// dO of 64 x 256 and P, dS: 154 KB of shared memory; a warp's dK and dV
// accumulators of 16 rows by 128 columns, 128 registers).  float32 takes
// 32-row tiles so that the four 32 x 256 tiles fit (143 KB), the 8 warps
// as 2 row groups by 4 column groups, and runs each product as three TF32
// products on m16n8k8, each operand split into a high and a low part
// (tf32.cuh), P and dS kept in float32.  At H_kv < H the group is split:
// a block per (batch, query head, kv tile) writes the head's float32 dK
// and dV, and the sum pass adds the G heads in head order (RecurrentGemma
// is 10 query heads over 1: a block per KV head would leave most SMs
// idle, and the tensor cores' float32 accumulation truncates over a
// group's G S / 8 k steps).  Bound: the five products over the band's
// pairs, 161 GFLOP at 1 x 4096 x 10 heads of 256, window 2048: 163 us at
// the bf16 rate; float32's three TF32 products each 977 us at 495 T/s.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "sm90.cuh"
#include "tf32.cuh"

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

// A warp's bf16 tile products.  A is 16 x K (the warp's rows), B is K x 8; the
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

// float32: 3xTF32 on m16n8k8, each operand split once into a TF32 high
// and low part (tf32.cuh), a b ~ a_lo b_hi + a_hi b_lo + a_hi b_hi
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
    for (int i = 0; i < 4; ++i) tf32::split_tf32(x[i], a.hi[i], a.lo[i]);
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
    for (int i = 0; i < 2; ++i) tf32::split_tf32(x[i], b.hi[i], b.lo[i]);
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
  // the small terms first
  __device__ static void mma(float (&c)[4], const A& a, const B& b) {
    mma1(c, a.lo, b.hi);
    mma1(c, a.hi, b.lo);
    mma1(c, a.hi, b.hi);
  }
};

// shared-memory rows padded by 16 bytes: ldmatrix rows stay 16-byte
// aligned and 8 consecutive rows fall on distinct banks.  R rows a query
// or kv tile (64, or 32 for float32 at D 256); the 8 warps as WR row
// groups of 16 by WC column groups
template <typename T, int DP, int R = BT>
struct BwdSmem {
  static constexpr int kPad = 16 / sizeof(T);
  static constexpr int LD = DP + kPad;           // an R x DP tile's rows
  static constexpr int LDP = R + kPad;           // an R x R tile's rows
  static constexpr int kTile = R * LD, kSq = R * LDP;   // elements
  // K, V, Q, dO; P, dS; lse and delta of the query tile
  static constexpr int kBytes =
      (4 * kTile + 2 * kSq) * static_cast<int>(sizeof(T)) + 2 * R * 4;
  static constexpr int WR = R / 16, WC = 8 / WR;
  static constexpr int NS = R / WC / 8;          // 8-key tiles a warp
  static constexpr int NP = DP / WC / 8;         // 8-column tiles a warp
};

// rows r0 .. r0 + R - 1 of one head of a (B, S, heads, D) tensor (g: its
// row 0, rows rs elements apart) into s (R x DP, rows ld apart), zeros
// past S and D; vec: D a multiple of 16 bytes and 16-byte aligned rows
template <typename T, int DP, int R = BT>
__device__ void load_tile(T* s, int ld, const T* g, int64_t rs, int r0,
                          int S, int D, int vec) {
  if (vec) {
    constexpr int V = 16 / sizeof(T), NC = DP / V;
    for (int i = threadIdx.x; i < R * NC; i += BWD_THREADS) {
      const int r = i / NC, c = (i % NC) * V;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (r0 + r < S && c < D) {
        val = *reinterpret_cast<const uint4*>(g + (r0 + r) * rs + c);
      }
      *reinterpret_cast<uint4*>(s + r * ld + c) = val;
    }
  } else {
    for (int i = threadIdx.x; i < R * DP; i += BWD_THREADS) {
      const int r = i / DP, c = i % DP;
      s[r * ld + c] = (r0 + r < S && c < D) ? g[(r0 + r) * rs + c]
                                            : from_f32<T>(0.f);
    }
  }
}

// lse and delta of query rows q0 .. q0 + R - 1 (zeros past S)
template <int R = BT>
__device__ __forceinline__ void load_rows(float* s_lse, float* s_delta,
                                          const float* lse,
                                          const float* delta, int q0,
                                          int S) {
  if (threadIdx.x < R) {
    const int r = q0 + threadIdx.x;
    s_lse[threadIdx.x] = r < S ? lse[r] : 0.f;
    s_delta[threadIdx.x] = r < S ? delta[r] : 0.f;
  }
}

// S = Q K^T and dP = dO V^T of the staged tiles (this warp's 16 query rows
// by R / WC keys), then P = exp(S scale - lse) and dS = P (dP - delta)
// scale under the mask (zero elsewhere) into sP (when not null) and sdS
template <typename T, int DP, int R = BT>
__device__ __forceinline__ void scores(const T* sQ, const T* sdO,
                                       const T* sK, const T* sV, T* sP,
                                       T* sdS, const float* s_lse,
                                       const float* s_delta, int q0, int k0,
                                       int S, float scale, int causal,
                                       int window) {
  using M = Mma<T>;
  using L = BwdSmem<T, DP, R>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wr = warp % L::WR, wc = warp / L::WR, g = lane / 4, t = lane % 4;
  float s_acc[L::NS][4] = {}, dp_acc[L::NS][4] = {};
#pragma unroll
  for (int kk = 0; kk < DP; kk += M::K) {
    const auto aq = M::template load_a<false>(sQ, L::LD, 16 * wr, kk);
    const auto ad = M::template load_a<false>(sdO, L::LD, 16 * wr, kk);
#pragma unroll
    for (int nt = 0; nt < L::NS; ++nt) {
      const int n0 = (R / L::WC) * wc + 8 * nt;
      M::mma(s_acc[nt], aq, M::template load_b<true>(sK, L::LD, kk, n0));
      M::mma(dp_acc[nt], ad, M::template load_b<true>(sV, L::LD, kk, n0));
    }
  }
#pragma unroll
  for (int nt = 0; nt < L::NS; ++nt) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = 16 * wr + g + 8 * hh;
      const int c = (R / L::WC) * wc + 8 * nt + 2 * t;
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

// this warp's accumulator of 16 rows by DP / WC columns to rows r0.. of
// one head of a (B, S, heads, D) tensor of U (out: its row 0, rows rs
// apart)
template <typename T, int DP, int R, typename U>
__device__ __forceinline__ void store_rows(
    U* out, int64_t rs, const float (&acc)[BwdSmem<T, DP, R>::NP][4],
    int r0, int S, int D) {
  using L = BwdSmem<T, DP, R>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wr = warp % L::WR, wc = warp / L::WR, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = r0 + 16 * wr + g + 8 * hh;
    if (r >= S) continue;
#pragma unroll
    for (int nt = 0; nt < L::NP; ++nt) {
      const int c = (DP / L::WC) * wc + 8 * nt + 2 * t;
      if (c < D) out[r * rs + c] = from_f32<U>(acc[nt][2 * hh]);
      if (c + 1 < D) out[r * rs + c + 1] = from_f32<U>(acc[nt][2 * hh + 1]);
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
// over the group's G query heads and every query tile that meets it.
// With part (the group split): a block per (batch x query head, kv tile),
// the head's float32 dK and dV into part (2, B, S, H, D), which
// flash_bwd_reduce_kernel sums in head order
template <typename T, int DP, int R>
__global__ void __launch_bounds__(BWD_THREADS)
    flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v,
                          const T* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          T* __restrict__ dk, T* __restrict__ dv,
                          float* __restrict__ part, int S, int H, int Hkv,
                          int D, float scale, int causal, int window,
                          int vec) {
  using M = Mma<T>;
  using L = BwdSmem<T, DP, R>;
  extern __shared__ __align__(16) uint8_t smem_bwd[];
  T* sK = reinterpret_cast<T*>(smem_bwd);
  T* sV = sK + L::kTile;
  T* sQ = sV + L::kTile;
  T* sdO = sQ + L::kTile;
  T* sP = sdO + L::kTile;
  T* sdS = sP + L::kSq;
  float* s_lse = reinterpret_cast<float*>(sdS + L::kSq);
  float* s_delta = s_lse + R;

  const int k0 = blockIdx.x * R;    // low tiles meet the most queries: first
  const int G = H / Hkv;
  const bool split = part != nullptr;
  const int heads = split ? H : Hkv;
  const int b = blockIdx.y / heads, hy = blockIdx.y % heads;
  const int hk = split ? hy / G : hy;
  const int g_lo = split ? hy % G : 0, g_hi = split ? g_lo + 1 : G;
  const int64_t qrs = static_cast<int64_t>(H) * D;
  const int64_t krs = static_cast<int64_t>(Hkv) * D;
  const int64_t kbase = (static_cast<int64_t>(b) * S * Hkv + hk) * D;
  const int warp = threadIdx.x / 32;
  const int wr = warp % L::WR, wc = warp / L::WR;
  float dk_acc[L::NP][4] = {}, dv_acc[L::NP][4] = {};

  load_tile<T, DP, R>(sK, L::LD, k + kbase, krs, k0, S, D, vec);
  load_tile<T, DP, R>(sV, L::LD, v + kbase, krs, k0, S, D, vec);
  // the query tiles that meet keys k0 .. k0 + R - 1: from the diagonal
  // (causal) to the last query within the window of the tile's last key
  const int n_q = (S + R - 1) / R;
  const int qt_lo = causal ? k0 / R : 0;
  const int qt_hi = window ? min(n_q, (k0 + R - 2 + window) / R + 1) : n_q;
  for (int gi = g_lo; gi < g_hi; ++gi) {
    const int h = hk * G + gi;
    const int64_t qbase = (static_cast<int64_t>(b) * S * H + h) * D;
    const int64_t rbase = (static_cast<int64_t>(b) * H + h) * S;
    for (int qt = qt_lo; qt < qt_hi; ++qt) {
      const int q0 = qt * R;
      __syncthreads();               // the last tile's readers are done
      load_tile<T, DP, R>(sQ, L::LD, q + qbase, qrs, q0, S, D, vec);
      load_tile<T, DP, R>(sdO, L::LD, dout + qbase, qrs, q0, S, D, vec);
      load_rows<R>(s_lse, s_delta, lse + rbase, delta + rbase, q0, S);
      __syncthreads();
      scores<T, DP, R>(sQ, sdO, sK, sV, sP, sdS, s_lse, s_delta, q0, k0, S,
                       scale, causal, window);
      __syncthreads();
      // dV += P^T dO, dK += dS^T Q: this warp's 16 keys by DP / WC columns
#pragma unroll
      for (int kk = 0; kk < R; kk += M::K) {
        const auto ap = M::template load_a<true>(sP, L::LDP, 16 * wr, kk);
        const auto as = M::template load_a<true>(sdS, L::LDP, 16 * wr, kk);
#pragma unroll
        for (int nt = 0; nt < L::NP; ++nt) {
          const int n0 = (DP / L::WC) * wc + 8 * nt;
          M::mma(dv_acc[nt], ap,
                 M::template load_b<false>(sdO, L::LD, kk, n0));
          M::mma(dk_acc[nt], as,
                 M::template load_b<false>(sQ, L::LD, kk, n0));
        }
      }
    }
  }
  if (split) {
    const int64_t pbase = (static_cast<int64_t>(b) * S * H + hy) * D;
    const int64_t plane = static_cast<int64_t>(gridDim.y) * S * D;
    store_rows<T, DP, R>(part + pbase, qrs, dk_acc, k0, S, D);
    store_rows<T, DP, R>(part + plane + pbase, qrs, dv_acc, k0, S, D);
  } else {
    store_rows<T, DP, R>(dk + kbase, krs, dk_acc, k0, S, D);
    store_rows<T, DP, R>(dv + kbase, krs, dv_acc, k0, S, D);
  }
}

// A block per (batch x head, query tile): dQ of the tile over every kv
// tile that meets it
template <typename T, int DP, int R>
__global__ void __launch_bounds__(BWD_THREADS)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        int S, int H, int Hkv, int D, float scale,
                        int causal, int window, int vec) {
  using M = Mma<T>;
  using L = BwdSmem<T, DP, R>;
  extern __shared__ __align__(16) uint8_t smem_bwd[];
  T* sK = reinterpret_cast<T*>(smem_bwd);
  T* sV = sK + L::kTile;
  T* sQ = sV + L::kTile;
  T* sdO = sQ + L::kTile;
  T* sdS = sdO + L::kTile + L::kSq;
  float* s_lse = reinterpret_cast<float*>(sdS + L::kSq);
  float* s_delta = s_lse + R;

  const int n_q = (S + R - 1) / R;
  const int q0 = (n_q - 1 - blockIdx.x) * R;      // longest first
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int64_t qrs = static_cast<int64_t>(H) * D;
  const int64_t krs = static_cast<int64_t>(Hkv) * D;
  const int64_t qbase = (static_cast<int64_t>(b) * S * H + h) * D;
  const int64_t kbase =
      (static_cast<int64_t>(b) * S * Hkv + h / (H / Hkv)) * D;
  const int64_t rbase = (static_cast<int64_t>(b) * H + h) * S;
  const int warp = threadIdx.x / 32;
  const int wr = warp % L::WR, wc = warp / L::WR;
  float dq_acc[L::NP][4] = {};

  load_tile<T, DP, R>(sQ, L::LD, q + qbase, qrs, q0, S, D, vec);
  load_tile<T, DP, R>(sdO, L::LD, dout + qbase, qrs, q0, S, D, vec);
  load_rows<R>(s_lse, s_delta, lse + rbase, delta + rbase, q0, S);
  // kv tiles from the first inside the window of the tile's first query to
  // the last below the diagonal (causal)
  const int n_k = (S + R - 1) / R;
  const int kt_lo = window ? max(0, q0 - window + 1) / R : 0;
  const int kt_hi = causal ? min(n_k, (q0 + R - 1) / R + 1) : n_k;
  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * R;
    __syncthreads();                 // the last tile's readers are done
    load_tile<T, DP, R>(sK, L::LD, k + kbase, krs, k0, S, D, vec);
    load_tile<T, DP, R>(sV, L::LD, v + kbase, krs, k0, S, D, vec);
    __syncthreads();
    scores<T, DP, R>(sQ, sdO, sK, sV, nullptr, sdS, s_lse, s_delta, q0, k0,
                     S, scale, causal, window);
    __syncthreads();
    // dQ += dS K: this warp's 16 query rows by DP / WC columns
#pragma unroll
    for (int kk = 0; kk < R; kk += M::K) {
      const auto as = M::template load_a<false>(sdS, L::LDP, 16 * wr, kk);
#pragma unroll
      for (int nt = 0; nt < L::NP; ++nt) {
        M::mma(dq_acc[nt], as,
               M::template load_b<false>(sK, L::LD, kk, (DP / L::WC) * wc +
                                                        8 * nt));
      }
    }
  }
  store_rows<T, DP, R>(dq + qbase, qrs, dq_acc, q0, S, D);
}

namespace {

using sm90::aligned16;
using sm90::allow_smem;

template <typename T, int DP, int R = BT>
int launch_dkdv(const void* q, const void* k, const void* v,
                const void* dout, const float* lse, const float* delta,
                void* dk, void* dv, float* part, int B, int S, int H,
                int Hkv, int D, float scale, int causal, int window, int vec,
                cudaStream_t st) {
  auto kernel = flash_bwd_dkdv_kernel<T, DP, R>;
  constexpr int smem = BwdSmem<T, DP, R>::kBytes;
  static_assert(smem <= 232448, "shared memory");
  static bool configured = false;
  const cudaError_t err = allow_smem(kernel, smem, configured);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + R - 1) / R, B * (part != nullptr ? H : Hkv));
  kernel<<<grid, BWD_THREADS, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), part, S, H, Hkv, D, scale,
      causal, window, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DP, int R = BT>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dq, int B, int S,
              int H, int Hkv, int D, float scale, int causal, int window,
              int vec, cudaStream_t st) {
  auto kernel = flash_bwd_dq_kernel<T, DP, R>;
  constexpr int smem = BwdSmem<T, DP, R>::kBytes;
  static bool configured = false;
  const cudaError_t err = allow_smem(kernel, smem, configured);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + R - 1) / R, B * H);
  kernel<<<grid, BWD_THREADS, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), S, H, Hkv, D, scale, causal, window, vec);
  return static_cast<int>(cudaGetLastError());
}

// 16-byte loads where D fills whole 16-byte chunks and every row is
// aligned
template <typename T>
int use_vec(int D, const void* a, const void* b, const void* c,
            const void* d) {
  return D * sizeof(T) % 16 == 0 && aligned16(a) && aligned16(b) &&
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

// dk, dv (B, S, Hkv, D) bfloat16 from q, dout (B, S, H, D), k, v (B, S,
// Hkv, D) bfloat16, lse and delta (B, H, S) float32; D <= 128, H % Hkv ==
// 0; window > 0: query i sees keys j > i - window only
extern "C" int repro_flash_bwd_dkdv(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const void* lse, const void* delta,
                                    void* dk, void* dv, int32_t B, int32_t S,
                                    int32_t H, int32_t Hkv, int32_t D,
                                    float scale, int32_t causal,
                                    int32_t window, void* stream) {
  if (D < 1 || D > 128) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* ls = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  const int vec = use_vec<bf16>(D, q, k, v, dout);
  return D <= 64 ? launch_dkdv<bf16, 64>(q, k, v, dout, ls, dl, dk, dv,
                                         nullptr, B, S, H, Hkv, D, scale,
                                         causal, window, vec, st)
                 : launch_dkdv<bf16, 128>(q, k, v, dout, ls, dl, dk, dv,
                                          nullptr, B, S, H, Hkv, D, scale,
                                          causal, window, vec, st);
}

// dq (B, S, H, D) bfloat16, the same inputs as repro_flash_bwd_dkdv
extern "C" int repro_flash_bwd_dq(const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const void* lse, const void* delta,
                                  void* dq, int32_t B, int32_t S, int32_t H,
                                  int32_t Hkv, int32_t D, float scale,
                                  int32_t causal, int32_t window,
                                  void* stream) {
  if (D < 1 || D > 128) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* ls = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  const int vec = use_vec<bf16>(D, q, k, v, dout);
  return D <= 64 ? launch_dq<bf16, 64>(q, k, v, dout, ls, dl, dq, B, S, H,
                                       Hkv, D, scale, causal, window, vec,
                                       st)
                 : launch_dq<bf16, 128>(q, k, v, dout, ls, dl, dq, B, S, H,
                                        Hkv, D, scale, causal, window, vec,
                                        st);
}

namespace {

// the d256 route's launches: T's tiles of R rows at D <= 256
template <typename T, int R>
int launch_dkdv_d256(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     void* dk, void* dv, void* part, int B, int S, int H,
                     int Hkv, int D, float scale, int causal, int window,
                     void* stream) {
  if (D <= 128 || D > 256 || (Hkv != H && part == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_dkdv<T, 256, R>(
      q, k, v, dout, static_cast<const float*>(lse),
      static_cast<const float*>(delta), dk, dv,
      Hkv != H ? static_cast<float*>(part) : nullptr, B, S, H, Hkv, D,
      scale, causal, window, use_vec<T>(D, q, k, v, dout),
      static_cast<cudaStream_t>(stream));
}

template <typename T, int R>
int launch_dq_d256(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dq, int B, int S, int H, int Hkv, int D, float scale,
                   int causal, int window, void* stream) {
  if (D <= 128 || D > 256) return static_cast<int>(cudaErrorInvalidValue);
  return launch_dq<T, 256, R>(q, k, v, dout, static_cast<const float*>(lse),
                              static_cast<const float*>(delta), dq, B, S, H,
                              Hkv, D, scale, causal, window,
                              use_vec<T>(D, q, k, v, dout),
                              static_cast<cudaStream_t>(stream));
}

}  // namespace

// The d256 route, 128 < D <= 256: dk, dv (B, S, Hkv, D) bfloat16 (tiles
// of 64 rows) from the inputs of repro_flash_bwd_dkdv; with Hkv < H, part
// (2, B, S, H, D) float32 takes the per-query-head partials and
// repro_flash_bwd_reduce writes dk and dv
extern "C" int repro_flash_bwd_dkdv_d256(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, void* part,
    int32_t B, int32_t S, int32_t H, int32_t Hkv, int32_t D, float scale,
    int32_t causal, int32_t window, void* stream) {
  return launch_dkdv_d256<bf16, 64>(q, k, v, dout, lse, delta, dk, dv, part,
                                    B, S, H, Hkv, D, scale, causal, window,
                                    stream);
}

// the same in float32 (3xTF32, tiles of 32 rows)
extern "C" int repro_flash_bwd_dkdv_d256_f32(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, void* part,
    int32_t B, int32_t S, int32_t H, int32_t Hkv, int32_t D, float scale,
    int32_t causal, int32_t window, void* stream) {
  return launch_dkdv_d256<float, 32>(q, k, v, dout, lse, delta, dk, dv,
                                     part, B, S, H, Hkv, D, scale, causal,
                                     window, stream);
}

// dq (B, S, H, D) of the d256 route, bfloat16, the inputs of
// repro_flash_bwd_dq
extern "C" int repro_flash_bwd_dq_d256(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int32_t B, int32_t S,
    int32_t H, int32_t Hkv, int32_t D, float scale, int32_t causal,
    int32_t window, void* stream) {
  return launch_dq_d256<bf16, 64>(q, k, v, dout, lse, delta, dq, B, S, H,
                                  Hkv, D, scale, causal, window, stream);
}

// the same in float32
extern "C" int repro_flash_bwd_dq_d256_f32(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int32_t B, int32_t S,
    int32_t H, int32_t Hkv, int32_t D, float scale, int32_t causal,
    int32_t window, void* stream) {
  return launch_dq_d256<float, 32>(q, k, v, dout, lse, delta, dq, B, S, H,
                                   Hkv, D, scale, causal, window, stream);
}

// ------------------------------ bfloat16 on wgmma: the route of the LMs

namespace {

// A block: a producer warpgroup (TMA) and two consumer warpgroups of 64
// rows each (wgmma's M), 128 rows a block; tiles of 64 rows by 64 NCH
// values, each stored as NCH 128-byte-swizzled column blocks of 8 KB
constexpr int WB_THREADS = 384, WB_ROWS = 64, WB_BLOCK = 2 * WB_ROWS;
constexpr int WB_ST = 3;                 // stages of the ring
constexpr int kWbRelease = 8;            // lane 0 of each consumer warp
constexpr int kWbProducerRegs = 24, kWbConsumerRegs = 240;
using sm90::edge_tile;
using sm90::fast_exp2;
using sm90::keeps;
using sm90::pack_bf16;

// Shared memory: four fixed tiles (the block's own rows of two tensors,
// one tile a consumer: K and V in the dK/dV kernel, Q and dO in the dQ
// kernel), then WB_ST ring stages of two tiles (Q and dO, or K and V),
// then a stage's lse and delta rows (dK/dV kernel: 64 + 64 floats), then
// the mbarriers: the fixed tiles, WB_ST full and WB_ST empty
template <int NCH>
struct WbSmem {
  static constexpr int kTile = WB_ROWS * 128 * NCH;
  static constexpr int kRows = (4 + 2 * WB_ST) * kTile;
  static constexpr int kBars = kRows + WB_ST * 512;
  static constexpr int kBytes = kBars + 8 * (1 + 2 * WB_ST) + 1024;
};
constexpr int kMbFixed = 0, kMbFull = 1, kMbEmpty = 1 + WB_ST;

// the tile masks every pair: its keys all above the diagonal or all
// behind the window.  A consumer skips its products (an exact no-op, P =
// 0), but releases the stage only after its full barrier: a release
// before it could count toward an earlier phase of the stage's empty
// barrier
__device__ __forceinline__ bool masked_tile(int q0, int k0, int causal,
                                            int window) {
  return (causal && k0 > q0 + WB_ROWS - 1) ||
         (window && k0 + WB_ROWS - 1 <= q0 - window);
}

// sc (+)= A B^T over D: A and B 64-row K-major tiles at shared addresses
// a and b (NCH column blocks 8 KB apart), 4 NCH k steps, one wgmma group;
// the descriptors are built from 32-bit addresses at each k step (a 64-bit
// add would rewrite a descriptor's registers in flight, and ptxas would
// serialise every wgmma)
template <int NCH>
__device__ __forceinline__ void issue_abt(float (&sc)[32], uint32_t a,
                                          uint32_t b) {
#pragma unroll
  for (int ks = 0; ks < 4 * NCH; ++ks) {
    const int off = (ks / 4) * WB_ROWS * 128 + (ks % 4) * 32;
    sm90::wgmma_ss_m64n64k16(sc, sm90::desc_sw128(a + off, 16, 1024),
                             sm90::desc_sw128(b + off, 16, 1024), ks > 0);
  }
  sm90::wgmma_commit();
}

// acc += A B: A 64 x 64 bf16 in registers (the accumulator layout of a
// 64 x 64 product, packed), B the 64-row tile at shared address b read
// MN-major (its rows are the k dimension), one wgmma group
template <int NCH>
__device__ __forceinline__ void issue_ab(float (&acc)[NCH][32],
                                         const uint32_t (&a)[16],
                                         uint32_t b) {
#pragma unroll
  for (int cb = 0; cb < NCH; ++cb) {
#pragma unroll
    for (int ks = 0; ks < WB_ROWS / 16; ++ks) {
      sm90::wgmma_rs_m64n64k16<true>(
          acc[cb], a + 4 * ks,
          sm90::desc_sw128(b + cb * WB_ROWS * 128 + ks * 16 * 128, 1024,
                           1024),
          1);
    }
  }
  sm90::wgmma_commit();
}

template <int NCH>
__device__ __forceinline__ void fence_acc(float (&acc)[NCH][32]) {
#pragma unroll
  for (int cb = 0; cb < NCH; ++cb) sm90::fence_regs(acc[cb]);
}

}  // namespace

// dK and dV of 128 kv rows of one (batch, query head): the tensor maps
// view q, dO (H heads) and k, v (H_kv heads) as (D, heads, S, B); lse2 and
// delta are (B, H, S_pad) float32, lse log2(e) and rowsum(dO o O), zeros
// past S.  Consumer c keeps kv rows k0 + 64 c .. of K and V in shared
// memory and walks the query tiles that meet the block's rows (a tile
// wholly masked for one consumer is an exact no-op there: P = 0).  With
// PARTIAL (H_kv < H) it writes its float32 dK and dV to part (2, B, S, H,
// D) at its query head, which flash_bwd_reduce_kernel sums; else dK and
// dV in bf16 at the KV head, which is the query head.  Consumer thread t
// holds S^T, dP^T and the accumulators in wgmma's layout: element 4 j + 2
// h + i at kv row 16 (t / 32) + (t % 32) / 4 + 8 h, column 8 j + 2 (t % 4)
// + i (a query for S^T and dP^T, a d for dK and dV).
template <int NCH, bool PARTIAL>
__global__ void __launch_bounds__(WB_THREADS, 1)
    flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                                const __grid_constant__ CUtensorMap tk,
                                const __grid_constant__ CUtensorMap tv,
                                const __grid_constant__ CUtensorMap tdo,
                                const float* __restrict__ lse2,
                                const float* __restrict__ delta,
                                bf16* __restrict__ dk, bf16* __restrict__ dv,
                                float* __restrict__ part, int S, int S_pad,
                                int H, int Hkv, int D, float scale,
                                int causal, int window) {
  using L = WbSmem<NCH>;
  extern __shared__ uint8_t smem_wb[];
  uint8_t* sm =
      smem_wb + ((1024 - (sm90::smem_addr(smem_wb) & 1023)) & 1023);
  const uint32_t base = sm90::smem_addr(sm);
  // fixed tiles: K of consumer c at c, V at 2 + c; stage st: Q, dO
  auto fixed = [&](int i) { return base + i * L::kTile; };
  auto ring = [&](int st, int i) {
    return base + (4 + 2 * st + i) * L::kTile;
  };
  auto rows = [&](int st) { return L::kRows + st * 512; };
  auto mb = [&](int i) { return base + L::kBars + 8 * i; };

  const int b = blockIdx.x / H, h = blockIdx.x % H, hk = h / (H / Hkv);
  const int k0 = blockIdx.y * WB_BLOCK;     // low tiles are the long ones
  const int n_q = (S + WB_ROWS - 1) / WB_ROWS;
  // the query tiles that meet kv rows k0 .. k0 + 127: from the diagonal
  // (causal) to the last query within the window of the block's last key
  const int qt_lo = causal ? k0 / WB_ROWS : 0;
  const int qt_hi =
      window ? min(n_q, (k0 + WB_BLOCK - 2 + window) / WB_ROWS + 1) : n_q;
  const int n_items = qt_hi - qt_lo;
  const int64_t rbase = (static_cast<int64_t>(b) * H + h) * S_pad;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    sm90::mbar_init(mb(kMbFixed), 1);
#pragma unroll
    for (int st = 0; st < WB_ST; ++st) {
      sm90::mbar_init(mb(kMbFull + st), 1);
      sm90::mbar_init(mb(kMbEmpty + st), kWbRelease);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {                     // producer: one thread issues the TMA
    sm90::setmaxnreg_dec<kWbProducerRegs>();
    if (threadIdx.x != 0) return;
    sm90::mbar_expect_tx(mb(kMbFixed), 4 * L::kTile);
#pragma unroll
    for (int c = 0; c < 2; ++c) {
#pragma unroll
      for (int cb = 0; cb < NCH; ++cb) {
        const int off = cb * WB_ROWS * 128;
        sm90::tma_load_4d(fixed(c) + off, &tk, 64 * cb, hk,
                          k0 + WB_ROWS * c, b, mb(kMbFixed));
        sm90::tma_load_4d(fixed(2 + c) + off, &tv, 64 * cb, hk,
                          k0 + WB_ROWS * c, b, mb(kMbFixed));
      }
    }
    // query tile i goes to stage i % WB_ST once both consumers have
    // released tile i - WB_ST there, with its lse and delta rows
    for (int i = 0; i < n_items; ++i) {
      const int st = i % WB_ST, q0 = (qt_lo + i) * WB_ROWS;
      if (i >= WB_ST) {
        sm90::mbar_wait(mb(kMbEmpty + st), ((i / WB_ST) & 1) ^ 1);
      }
      sm90::mbar_expect_tx(mb(kMbFull + st), 2 * L::kTile + 512);
#pragma unroll
      for (int cb = 0; cb < NCH; ++cb) {
        const int off = cb * WB_ROWS * 128;
        sm90::tma_load_4d(ring(st, 0) + off, &tq, 64 * cb, h, q0, b,
                          mb(kMbFull + st));
        sm90::tma_load_4d(ring(st, 1) + off, &tdo, 64 * cb, h, q0, b,
                          mb(kMbFull + st));
      }
      sm90::bulk_load(base + rows(st), lse2 + rbase + q0, 256,
                      mb(kMbFull + st));
      sm90::bulk_load(base + rows(st) + 256, delta + rbase + q0, 256,
                      mb(kMbFull + st));
    }
    return;
  }

  // consumer c (a compile-time index, so that its shared addresses and
  // descriptors are the uniform base plus constants)
  auto consumer = [&](auto index) {
    constexpr int c = decltype(index)::value;
    const int tid = threadIdx.x % 128, lane = tid % 32;
    const int kc0 = k0 + WB_ROWS * c;
    const int row0 = kc0 + 16 * (tid / 32) + lane / 4;  // rows row0, + 8
    const int col0 = 2 * (lane % 4);
    const float scale_log2 = scale * kLog2eBwd;
    float dkacc[NCH][32], dvacc[NCH][32];
#pragma unroll
    for (int cb = 0; cb < NCH; ++cb) {
#pragma unroll
      for (int e = 0; e < 32; ++e) dkacc[cb][e] = dvacc[cb][e] = 0.f;
    }
    sm90::mbar_wait(mb(kMbFixed), 0);
    for (int i = 0; i < n_items; ++i) {
      const int st = i % WB_ST, q0 = (qt_lo + i) * WB_ROWS;
      sm90::mbar_wait(mb(kMbFull + st), (i / WB_ST) & 1);
      // S^T = K Q^T and dP^T = V dO^T, two groups in flight; a
      // wholly masked tile is an exact no-op (P = 0)
      const bool skip = masked_tile(q0, kc0, causal, window);
      if (skip) {
        if (lane == 0) sm90::mbar_arrive(mb(kMbEmpty + st));
        continue;
      }
      float s[32], dp[32];
      sm90::wgmma_fence();
      issue_abt<NCH>(s, fixed(c), ring(st, 0));
      issue_abt<NCH>(dp, fixed(2 + c), ring(st, 1));
      sm90::wgmma_wait<1>();
      sm90::fence_regs(s);
      // P^T = exp2(S^T scale log2(e) - lse log2(e)) under the mask, in
      // float32 in s, and rounded to bf16 once as dV's A operand
      const float* rl = reinterpret_cast<const float*>(sm + rows(st));
      const float* rd = rl + WB_ROWS;
      const bool edge =
          edge_tile(q0, WB_ROWS, kc0, WB_ROWS, S, causal, window);
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int col = 8 * (e / 4) + col0 + e % 2;
        const float p = fast_exp2(s[e] * scale_log2 - rl[col]);
        s[e] = (!edge || keeps(q0 + col, row0 + 8 * ((e / 2) % 2), S, causal,
                               window))
                   ? p
                   : 0.f;
      }
      uint32_t pb[16];
#pragma unroll
      for (int x = 0; x < 16; ++x) pb[x] = pack_bf16(s[2 * x], s[2 * x + 1]);
      // dV += P^T dO, in flight while dS^T is formed
      sm90::wgmma_fence();
      issue_ab<NCH>(dvacc, pb, ring(st, 1));
      sm90::wgmma_wait<1>();
      sm90::fence_regs(dp);
      // dS^T = P^T (dP^T - delta) scale, rounded to bf16 once
      uint32_t dsb[16];
#pragma unroll
      for (int x = 0; x < 16; ++x) {
        const int col = 8 * (x / 2) + col0;
        dsb[x] = pack_bf16(s[2 * x] * (dp[2 * x] - rd[col]) * scale,
                           s[2 * x + 1] * (dp[2 * x + 1] - rd[col + 1]) *
                               scale);
      }
      // dK += dS^T Q
      sm90::wgmma_fence();
      issue_ab<NCH>(dkacc, dsb, ring(st, 0));
      sm90::wgmma_wait<0>();
      sm90::fence_regs(pb);
      sm90::fence_regs(dsb);
      fence_acc<NCH>(dvacc);
      fence_acc<NCH>(dkacc);
      if (lane == 0) sm90::mbar_arrive(mb(kMbEmpty + st));   // stage read
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int kv = row0 + 8 * hh;
      if (kv >= S) continue;
#pragma unroll
      for (int cb = 0; cb < NCH; ++cb) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = 64 * cb + 8 * j + col0;   // col + 1 < D with it
          if (col >= D) continue;
          const int e = 4 * j + 2 * hh;
          if constexpr (PARTIAL) {
            const int64_t at =
                ((static_cast<int64_t>(b) * S + kv) * H + h) * D + col;
            const int64_t half = static_cast<int64_t>(gridDim.x) * S * D;
            *reinterpret_cast<float2*>(part + at) =
                make_float2(dkacc[cb][e], dkacc[cb][e + 1]);
            *reinterpret_cast<float2*>(part + half + at) =
                make_float2(dvacc[cb][e], dvacc[cb][e + 1]);
          } else {
            const int64_t at =
                ((static_cast<int64_t>(b) * S + kv) * Hkv + hk) * D + col;
            *reinterpret_cast<__nv_bfloat162*>(dk + at) =
                __floats2bfloat162_rn(dkacc[cb][e], dkacc[cb][e + 1]);
            *reinterpret_cast<__nv_bfloat162*>(dv + at) =
                __floats2bfloat162_rn(dvacc[cb][e], dvacc[cb][e + 1]);
          }
        }
      }
    }
  };
  sm90::setmaxnreg_inc<kWbConsumerRegs>();
  if (wg == 1) {
    consumer(std::integral_constant<int, 0>());
  } else {
    consumer(std::integral_constant<int, 1>());
  }
}

// dQ of 128 query rows of one (batch, head): consumer c keeps query rows
// q0 + 64 c .. of Q and dO in shared memory, the producer streams the kv
// tiles that meet the block's rows through the ring (a tile wholly masked
// for one consumer is an exact no-op there).  Consumer thread t holds S,
// dP and dQ in wgmma's layout: element 4 j + 2 h + i at query row 16 (t /
// 32) + (t % 32) / 4 + 8 h, column 8 j + 2 (t % 4) + i (a key for S and
// dP, a d for dQ).
template <int NCH>
__global__ void __launch_bounds__(WB_THREADS, 1)
    flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              const __grid_constant__ CUtensorMap tdo,
                              const float* __restrict__ lse2,
                              const float* __restrict__ delta,
                              bf16* __restrict__ dq, int S, int S_pad, int H,
                              int Hkv, int D, float scale, int causal,
                              int window) {
  using L = WbSmem<NCH>;
  extern __shared__ uint8_t smem_wb[];
  uint8_t* sm =
      smem_wb + ((1024 - (sm90::smem_addr(smem_wb) & 1023)) & 1023);
  const uint32_t base = sm90::smem_addr(sm);
  // fixed tiles: Q of consumer c at c, dO at 2 + c; stage st: K, V
  auto fixed = [&](int i) { return base + i * L::kTile; };
  auto ring = [&](int st, int i) {
    return base + (4 + 2 * st + i) * L::kTile;
  };
  auto mb = [&](int i) { return base + L::kBars + 8 * i; };

  const int b = blockIdx.x / H, h = blockIdx.x % H, hk = h / (H / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * WB_BLOCK;  // longest first
  const int n_k = (S + WB_ROWS - 1) / WB_ROWS;
  // kv tiles from the first inside the window of the block's first query
  // to the last below the diagonal of its last (causal)
  const int j0 = window ? max(0, q0 - window + 1) / WB_ROWS : 0;
  const int j_hi =
      causal ? min(n_k, (q0 + WB_BLOCK - 1) / WB_ROWS + 1) : n_k;
  const int n_items = j_hi - j0;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    sm90::mbar_init(mb(kMbFixed), 1);
#pragma unroll
    for (int st = 0; st < WB_ST; ++st) {
      sm90::mbar_init(mb(kMbFull + st), 1);
      sm90::mbar_init(mb(kMbEmpty + st), kWbRelease);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {                     // producer
    sm90::setmaxnreg_dec<kWbProducerRegs>();
    if (threadIdx.x != 0) return;
    sm90::mbar_expect_tx(mb(kMbFixed), 4 * L::kTile);
#pragma unroll
    for (int c = 0; c < 2; ++c) {
#pragma unroll
      for (int cb = 0; cb < NCH; ++cb) {
        const int off = cb * WB_ROWS * 128;
        sm90::tma_load_4d(fixed(c) + off, &tq, 64 * cb, h, q0 + WB_ROWS * c,
                          b, mb(kMbFixed));
        sm90::tma_load_4d(fixed(2 + c) + off, &tdo, 64 * cb, h,
                          q0 + WB_ROWS * c, b, mb(kMbFixed));
      }
    }
    for (int j = 0; j < n_items; ++j) {
      const int st = j % WB_ST, r0 = (j0 + j) * WB_ROWS;
      if (j >= WB_ST) {
        sm90::mbar_wait(mb(kMbEmpty + st), ((j / WB_ST) & 1) ^ 1);
      }
      sm90::mbar_expect_tx(mb(kMbFull + st), 2 * L::kTile);
#pragma unroll
      for (int cb = 0; cb < NCH; ++cb) {
        const int off = cb * WB_ROWS * 128;
        sm90::tma_load_4d(ring(st, 0) + off, &tk, 64 * cb, hk, r0, b,
                          mb(kMbFull + st));
        sm90::tma_load_4d(ring(st, 1) + off, &tv, 64 * cb, hk, r0, b,
                          mb(kMbFull + st));
      }
    }
    return;
  }

  auto consumer = [&](auto index) {
    constexpr int c = decltype(index)::value;
    const int tid = threadIdx.x % 128, lane = tid % 32;
    const int qc0 = q0 + WB_ROWS * c;
    const int row0 = qc0 + 16 * (tid / 32) + lane / 4;  // rows row0, + 8
    const int col0 = 2 * (lane % 4);
    const float scale_log2 = scale * kLog2eBwd;
    // this thread's two rows' lse log2(e) and delta (S_pad covers them)
    const int64_t rbase = (static_cast<int64_t>(b) * H + h) * S_pad + row0;
    const float rl[2] = {lse2[rbase], lse2[rbase + 8]};
    const float rd[2] = {delta[rbase], delta[rbase + 8]};
    float dqacc[NCH][32];
#pragma unroll
    for (int cb = 0; cb < NCH; ++cb) {
#pragma unroll
      for (int e = 0; e < 32; ++e) dqacc[cb][e] = 0.f;
    }
    sm90::mbar_wait(mb(kMbFixed), 0);
    for (int j = 0; j < n_items; ++j) {
      const int st = j % WB_ST, kv0 = (j0 + j) * WB_ROWS;
      sm90::mbar_wait(mb(kMbFull + st), (j / WB_ST) & 1);
      // S = Q K^T and dP = dO V^T, two groups in flight; a
      // wholly masked tile is an exact no-op (P = 0)
      const bool skip = masked_tile(qc0, kv0, causal, window);
      if (skip) {
        if (lane == 0) sm90::mbar_arrive(mb(kMbEmpty + st));
        continue;
      }
      float s[32], dp[32];
      sm90::wgmma_fence();
      issue_abt<NCH>(s, fixed(c), ring(st, 0));
      issue_abt<NCH>(dp, fixed(2 + c), ring(st, 1));
      sm90::wgmma_wait<1>();
      sm90::fence_regs(s);
      const bool edge =
          edge_tile(qc0, WB_ROWS, kv0, WB_ROWS, S, causal, window);
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int hh = (e / 2) % 2;
        const float p = fast_exp2(s[e] * scale_log2 - rl[hh]);
        s[e] = (!edge || keeps(row0 + 8 * hh, kv0 + 8 * (e / 4) + col0 + e % 2,
                               S, causal, window))
                   ? p
                   : 0.f;
      }
      sm90::wgmma_wait<0>();
      sm90::fence_regs(dp);
      // dS = P (dP - delta) scale, rounded to bf16 once; dQ += dS K
      uint32_t dsb[16];
#pragma unroll
      for (int x = 0; x < 16; ++x) {
        const float d = rd[x % 2];
        dsb[x] = pack_bf16(s[2 * x] * (dp[2 * x] - d) * scale,
                           s[2 * x + 1] * (dp[2 * x + 1] - d) * scale);
      }
      sm90::wgmma_fence();
      issue_ab<NCH>(dqacc, dsb, ring(st, 0));
      sm90::wgmma_wait<0>();
      sm90::fence_regs(dsb);
      fence_acc<NCH>(dqacc);
      if (lane == 0) sm90::mbar_arrive(mb(kMbEmpty + st));   // stage read
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = row0 + 8 * hh;
      if (row >= S) continue;
      bf16* out = dq + ((static_cast<int64_t>(b) * S + row) * H + h) * D;
#pragma unroll
      for (int cb = 0; cb < NCH; ++cb) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = 64 * cb + 8 * j + col0;
          if (col >= D) continue;
          const int e = 4 * j + 2 * hh;
          *reinterpret_cast<__nv_bfloat162*>(out + col) =
              __floats2bfloat162_rn(dqacc[cb][e], dqacc[cb][e + 1]);
        }
      }
    }
  };
  sm90::setmaxnreg_inc<kWbConsumerRegs>();
  if (wg == 1) {
    consumer(std::integral_constant<int, 0>());
  } else {
    consumer(std::integral_constant<int, 1>());
  }
}

// lse2 and delta (B, H, S_pad) float32 for the wgmma kernels: each row's
// lse log2(e) and rowsum(dO o O), zeros past S; 8 lanes a (b, h, s) row,
// 16-byte loads (D % 8 == 0, aligned rows)
constexpr int kPrepLanes = 8, kPrepRows = BWD_THREADS / kPrepLanes;
__global__ void __launch_bounds__(BWD_THREADS)
    flash_bwd_prep_kernel(const bf16* __restrict__ o,
                          const bf16* __restrict__ dout,
                          const float* __restrict__ lse,
                          float* __restrict__ lse2,
                          float* __restrict__ delta, int64_t rows, int S,
                          int S_pad, int H, int D) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kPrepRows +
                      threadIdx.x / kPrepLanes;
  const int lane = threadIdx.x % kPrepLanes;
  const int s = static_cast<int>(row % S_pad);
  const int64_t bh = row / S_pad;
  float acc = 0.f;
  if (row < rows && s < S) {
    const int64_t b = bh / H, h = bh % H;
    const int64_t at = ((b * S + s) * H + h) * D;
    for (int c = 8 * lane; c < D; c += 8 * kPrepLanes) {
      const uint4 x = *reinterpret_cast<const uint4*>(o + at + c);
      const uint4 y = *reinterpret_cast<const uint4*>(dout + at + c);
      const __nv_bfloat162* xp = reinterpret_cast<const __nv_bfloat162*>(&x);
      const __nv_bfloat162* yp = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 a = __bfloat1622float2(xp[i]);
        const float2 d = __bfloat1622float2(yp[i]);
        acc += a.x * d.x;
        acc += a.y * d.y;
      }
    }
  }
#pragma unroll
  for (int w = kPrepLanes / 2; w > 0; w /= 2) {
    acc += __shfl_xor_sync(0xffffffffu, acc, w);
  }
  if (lane == 0 && row < rows) {
    delta[row] = acc;
    lse2[row] = s < S ? lse[bh * S + s] * kLog2eBwd : 0.f;
  }
}

// dk, dv (B, S, H_kv, D) in T: the float32 partials part (2, B, S, H, D)
// summed over each KV head's G query heads in head order and rounded
// once; V values a thread (4 where D % 4 == 0, else 1)
template <typename T, int V>
__global__ void __launch_bounds__(BWD_THREADS)
    flash_bwd_reduce_kernel(const float* __restrict__ part,
                            T* __restrict__ dk, T* __restrict__ dv,
                            int64_t n, int G, int D) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * BWD_THREADS +
                    threadIdx.x;
  if (i >= 2 * n) return;
  const int t = i >= n;                  // 0: dK, 1: dV
  const int64_t e = (i - t * n) * V;     // element of (B, S, H_kv, D)
  const int64_t d = e % D, r = e / D;    // r = (b S + s) H_kv + hk
  // query head hk G + g of row (b, s) is row r G + g of (B S H, D)
  const float* src = part + t * n * V * G + r * G * D + d;
  T* out = (t ? dv : dk) + e;
  if constexpr (V == 4) {
    float4 acc = *reinterpret_cast<const float4*>(src);
    for (int g = 1; g < G; ++g) {
      const float4 x = *reinterpret_cast<const float4*>(src + g * D);
      acc.x += x.x;
      acc.y += x.y;
      acc.z += x.z;
      acc.w += x.w;
    }
    store2(out, acc.x, acc.y);
    store2(out + 2, acc.z, acc.w);
  } else {
    float acc = src[0];
    for (int g = 1; g < G; ++g) acc += src[g * D];
    *out = from_f32<T>(acc);
  }
}

namespace {

// the wgmma route's inputs: D % 8 == 0 (16-byte rows for TMA), D <= 128,
// 16-byte aligned bases
bool wb_takes(int D, const void* a, const void* b, const void* c,
              const void* d) {
  return D >= 8 && D <= 128 && D % 8 == 0 && aligned16(a) && aligned16(b) &&
         aligned16(c) && aligned16(d);
}

template <int NCH, bool PARTIAL>
int launch_dkdv_wgmma(const CUtensorMap (&maps)[4], const float* lse2,
                      const float* delta, void* dk, void* dv, float* part,
                      int B, int S, int S_pad, int H, int Hkv, int D,
                      float scale, int causal, int window, cudaStream_t st) {
  auto kernel = flash_bwd_dkdv_wgmma_kernel<NCH, PARTIAL>;
  constexpr int smem = WbSmem<NCH>::kBytes;
  static bool configured = false;
  const cudaError_t err = allow_smem(kernel, smem, configured);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, (S + WB_BLOCK - 1) / WB_BLOCK);
  kernel<<<grid, WB_THREADS, smem, st>>>(
      maps[0], maps[1], maps[2], maps[3], lse2, delta, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), part, S, S_pad, H, Hkv, D, scale, causal,
      window);
  return static_cast<int>(cudaGetLastError());
}

template <int NCH>
int launch_dq_wgmma(const CUtensorMap (&maps)[4], const float* lse2,
                    const float* delta, void* dq, int B, int S, int S_pad,
                    int H, int Hkv, int D, float scale, int causal,
                    int window, cudaStream_t st) {
  auto kernel = flash_bwd_dq_wgmma_kernel<NCH>;
  constexpr int smem = WbSmem<NCH>::kBytes;
  static bool configured = false;
  const cudaError_t err = allow_smem(kernel, smem, configured);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, (S + WB_BLOCK - 1) / WB_BLOCK);
  kernel<<<grid, WB_THREADS, smem, st>>>(
      maps[0], maps[1], maps[2], maps[3], lse2, delta, static_cast<bf16*>(dq),
      S, S_pad, H, Hkv, D, scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// lse2, delta (B, H, S_pad) float32 from o, dout (B, S, H, D) bf16 and lse
// (B, H, S) float32; S_pad a multiple of 128 >= S; D <= 256 (the row pass
// of both wgmma routes)
extern "C" int repro_flash_bwd_prep(const void* o, const void* dout,
                                    const void* lse, void* lse2, void* delta,
                                    int32_t B, int32_t S, int32_t S_pad,
                                    int32_t H, int32_t D, void* stream) {
  if (D < 8 || D > 256 || D % 8 || !aligned16(o) || !aligned16(dout) ||
      S_pad % WB_BLOCK || S_pad < S) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t rows = static_cast<int64_t>(B) * H * S_pad;
  const int64_t blocks = (rows + kPrepRows - 1) / kPrepRows;
  if (blocks == 0) return 0;
  flash_bwd_prep_kernel<<<blocks, BWD_THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<float*>(lse2),
      static_cast<float*>(delta), rows, S, S_pad, H, D);
  return static_cast<int>(cudaGetLastError());
}

// dk, dv (B, S, Hkv, D) bf16 from q, dout (B, S, H, D), k, v (B, S, Hkv,
// D) bf16 and repro_flash_bwd_prep's lse2 and delta; with Hkv < H, part
// (2, B, S, H, D) float32 takes the per-query-head partials and
// repro_flash_bwd_reduce writes dk and dv
extern "C" int repro_flash_bwd_dkdv_wgmma(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse2, const void* delta, void* dk, void* dv, void* part,
    int32_t B, int32_t S, int32_t S_pad, int32_t H, int32_t Hkv, int32_t D,
    float scale, int32_t causal, int32_t window, void* stream) {
  if (!wb_takes(D, q, k, v, dout) || (Hkv != H && part == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap maps[4] = {};
  if (!sm90::bwd_tile_maps(maps, q, k, v, dout, B, S, H, Hkv, D)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* ls = static_cast<const float*>(lse2);
  const float* dl = static_cast<const float*>(delta);
  float* pt = static_cast<float*>(part);
  if (Hkv != H) {
    return D <= 64 ? launch_dkdv_wgmma<1, true>(maps, ls, dl, dk, dv, pt, B,
                                                S, S_pad, H, Hkv, D, scale,
                                                causal, window, st)
                   : launch_dkdv_wgmma<2, true>(maps, ls, dl, dk, dv, pt, B,
                                                S, S_pad, H, Hkv, D, scale,
                                                causal, window, st);
  }
  return D <= 64 ? launch_dkdv_wgmma<1, false>(maps, ls, dl, dk, dv, pt, B,
                                               S, S_pad, H, Hkv, D, scale,
                                               causal, window, st)
                 : launch_dkdv_wgmma<2, false>(maps, ls, dl, dk, dv, pt, B,
                                               S, S_pad, H, Hkv, D, scale,
                                               causal, window, st);
}

namespace {

template <typename T, int V>
int launch_reduce(const void* part, void* dk, void* dv, int64_t values,
                  int G, int D, cudaStream_t st) {
  const int64_t n = values / V;
  const int64_t blocks = (2 * n + BWD_THREADS - 1) / BWD_THREADS;
  if (blocks == 0) return 0;
  flash_bwd_reduce_kernel<T, V><<<blocks, BWD_THREADS, 0, st>>>(
      static_cast<const float*>(part), static_cast<T*>(dk),
      static_cast<T*>(dv), n, G, D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dk, dv (B, S, Hkv, D) in the inputs' type (bf16_out: bfloat16, else
// float32) = the sums of part (2, B, S, H, D) over each KV head's H / Hkv
// query heads, in head order
extern "C" int repro_flash_bwd_reduce(const void* part, void* dk, void* dv,
                                      int32_t B, int32_t S, int32_t H,
                                      int32_t Hkv, int32_t D,
                                      int32_t bf16_out, void* stream) {
  if (D < 1 || H % Hkv) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t values = static_cast<int64_t>(B) * S * Hkv * D;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int G = H / Hkv;
  if (bf16_out) {
    return D % 4 ? launch_reduce<bf16, 1>(part, dk, dv, values, G, D, st)
                 : launch_reduce<bf16, 4>(part, dk, dv, values, G, D, st);
  }
  return D % 4 ? launch_reduce<float, 1>(part, dk, dv, values, G, D, st)
               : launch_reduce<float, 4>(part, dk, dv, values, G, D, st);
}

// dq (B, S, H, D) bf16, the same inputs as repro_flash_bwd_dkdv_wgmma
extern "C" int repro_flash_bwd_dq_wgmma(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse2, const void* delta, void* dq, int32_t B, int32_t S,
    int32_t S_pad, int32_t H, int32_t Hkv, int32_t D, float scale,
    int32_t causal, int32_t window, void* stream) {
  if (!wb_takes(D, q, k, v, dout)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap maps[4] = {};
  if (!sm90::bwd_tile_maps(maps, q, k, v, dout, B, S, H, Hkv, D)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* ls = static_cast<const float*>(lse2);
  const float* dl = static_cast<const float*>(delta);
  return D <= 64 ? launch_dq_wgmma<1>(maps, ls, dl, dq, B, S, S_pad, H, Hkv,
                                      D, scale, causal, window, st)
                 : launch_dq_wgmma<2>(maps, ls, dl, dq, B, S, S_pad, H, Hkv,
                                      D, scale, causal, window, st);
}
