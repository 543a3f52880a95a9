// Backward of flash attention in bfloat16 at 128 < D <= 256 for Hopper
// (sm_90a): the "wgmma_d256" route of flash_attn/ops.py::bwd_route,
// bfloat16 tensors with D % 8 == 0, contiguous on 16-byte-aligned bases
// (RecurrentGemma-2B's local attention, 10 query heads over 1 KV head of
// 256).  The call's other passes are flash_attn_bwd.cu's: the row pass
// flash_bwd_prep_kernel (lse log2(e) and delta = rowsum(dO o O), padded to
// 128 rows) before, and with H_kv < H flash_bwd_reduce_kernel (each query
// head's float32 dK and dV summed in head order) after the dK/dV kernel.
//
// Replaces no Pallas kernel: the reference differentiates its model
// attention through repro/models/layers.py::_flash_bwd, plain jnp that
// recomputes P from the log-sum-exp.  The arithmetic is the wgmma route's
// (flash_attn_bwd.cu): P = exp2(S scale log2(e) - lse log2(e)) under the
// mask, dS = P (dP - delta) scale, P and dS rounded to bf16 once for
// their products, every sum in float32 in an order fixed by the shape (no
// atomics: the same bits every call).
//
// Bound: operations.  At 1 x 4096 x 10 heads of 256, window 2048, the five
// products over the band's pairs are 161 GFLOP, 163 us at the bf16
// tensor-core rate; these kernels run seven (S and dP are computed in
// both).
//
// Why D 256 needs its own division of the work.  The D <= 128 kernels give
// each consumer warpgroup 64 rows of its own and keep that consumer's dK
// and dV (or dQ) over the whole of D in registers: at D 256 that is 256
// float32 a thread for dK and dV alone, past the 255 a thread can have.
// Here a block is 64 rows, and its two consumer warpgroups split it twice:
//   - the score products by their other axis: consumer c computes columns
//     32 c .. 32 c + 31 of S^T = K Q^T and dP^T = V dO^T (the dQ kernel:
//     of S = Q K^T and dP = dO V^T) over the full D, m64n32k16 with both
//     operands K-major in shared memory, and stages its half of P^T and
//     dS^T (dS) in bf16 in a shared 64 x 64 tile;
//   - after a named barrier between the two, the accumulating products
//     by D: consumer c takes dV[:, 128 c ..] += P^T dO and dK[:, 128 c ..]
//     += dS^T Q (dQ[:, 128 c ..] += dS K), m64n128k16 over the block's 64
//     queries (keys) with the staged tile as A (K-major) and dO, Q (K) read
//     MN-major by the transpose bit.  A thread holds 16 + 16 + 64 + 64
//     float32 (dQ: 16 + 16 + 64), not 256.
// The staged tiles alternate between two buffers, so one barrier a tile
// suffices: a consumer writes buffer i % 2 at tile i only after both have
// passed tile i - 1's barrier, which each reaches after its tile i - 2
// products (the last readers of that buffer) have retired.
//
// Each block has a producer warpgroup whose one thread brings the block's
// own 64 x 256 tiles in once (K and V, or Q and dO) and streams the tiles
// that meet them (Q, dO with their lse and delta rows, or K and V) through
// a 2-stage ring by TMA against full / empty mbarriers (setmaxnreg: 24 /
// 240 registers).  Shared memory: the fixed tiles 64 KB, the ring 2 x 64
// KB, the staged tiles 2 x 16 KB (dQ: 2 x 8 KB), 226 KB in the dK/dV
// kernel: one block an SM.  A tile is four 128-byte-swizzled column blocks
// of 64 rows; D short of 256 reads TMA's zero fill past D, and only D
// columns are stored.  Rows past S are zero-filled and masked.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;
using sm90::edge_tile;
using sm90::fast_exp2;
using sm90::keeps;
using sm90::pack_bf16;

constexpr int D2_THREADS = 384;          // producer + two consumers
constexpr int D2_ROWS = 64;              // rows of a block and of a tile
constexpr int D2_NCH = 4;                // 64-wide column blocks of D 256
constexpr int D2_SQ = D2_ROWS * 128;     // a 64 x 64 bf16 tile: 8 KB
constexpr int D2_TILE = D2_NCH * D2_SQ;  // a 64 x 256 bf16 tile: 32 KB
constexpr int D2_ST = 2;                 // stages of the ring
constexpr int D2_HALF = 32;              // a consumer's score columns
constexpr int kD2Release = 8;            // lane 0 of each consumer warp
constexpr int kD2ProducerRegs = 24, kD2ConsumerRegs = 240;
constexpr int kBarStaged = 1;            // both consumers' halves staged
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMbFixed = 0, kMbFull = 1, kMbEmpty = 1 + D2_ST;

// Shared memory (offsets from a 1024-byte-aligned base): the two fixed
// tiles, D2_ST ring stages of two tiles, two buffers of NSTAGED staged 64
// x 64 tiles, the dK/dV kernel's D2_ST stages of lse and delta rows (64 +
// 64 floats), then the mbarriers: the fixed tiles, D2_ST full and D2_ST
// empty
template <int NSTAGED, int NROWS>
struct D2Smem {
  static constexpr int kRing = 2 * D2_TILE;
  static constexpr int kStaged = kRing + D2_ST * 2 * D2_TILE;
  static constexpr int kRows = kStaged + 2 * NSTAGED * D2_SQ;
  static constexpr int kBars = kRows + NROWS * 512;
  static constexpr int kBytes = kBars + 8 * (1 + 2 * D2_ST) + 1024;
  static_assert(kBytes <= 232448, "shared memory");
};
using DkdvSmem = D2Smem<2, D2_ST>;     // P^T and dS^T; lse and delta rows
using DqSmem = D2Smem<1, 0>;           // dS

// acc (=)= A B^T over D 256: A the fixed 64-row tile at shared address a,
// B 32 rows of a streamed tile at b, both K-major (column blocks D2_SQ
// apart), 16 k steps, one wgmma group; descriptors from 32-bit addresses
// at each k step, so that none is rewritten in flight
__device__ __forceinline__ void issue_scores(float (&acc)[16], uint32_t a,
                                             uint32_t b) {
#pragma unroll
  for (int ks = 0; ks < 4 * D2_NCH; ++ks) {
    const int off = (ks / 4) * D2_SQ + (ks % 4) * 32;
    sm90::wgmma_ss_m64n32k16(acc, sm90::desc_sw128(a + off, 16, 1024),
                             sm90::desc_sw128(b + off, 16, 1024), ks > 0);
  }
  sm90::wgmma_commit();
}

// acc += A B: A the staged 64 x 64 tile at a (K-major), B 128 columns of
// a 64-row tile at b (two column blocks, its rows the k dimension, read
// MN-major), 4 k steps, one wgmma group
__device__ __forceinline__ void issue_accumulate(float (&acc)[64],
                                                 uint32_t a, uint32_t b) {
#pragma unroll
  for (int ks = 0; ks < D2_ROWS / 16; ++ks) {
    sm90::wgmma_ss_m64n128k16<true>(
        acc, sm90::desc_sw128(a + ks * 32, 16, 1024),
        sm90::desc_sw128(b + ks * 16 * 128, D2_SQ, 1024));
  }
  sm90::wgmma_commit();
}

// this consumer's half of a staged tile: element 4 j + 2 h + i of x at
// row r0 + 8 h, column 32 c + 8 j + col0 + i, in bf16 pairs
template <int C>
__device__ __forceinline__ void stage_half(uint8_t* tile, const uint32_t* x,
                                           int r0, int col0) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = r0 + 8 * hh;
      *reinterpret_cast<uint32_t*>(tile + sm90::sw128(r, 4 * C + j) +
                                   2 * col0) = x[2 * j + hh];
    }
  }
}

__device__ __forceinline__ void zero(float (&acc)[64]) {
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = 0.f;
}

__device__ __forceinline__ void init_bars(uint32_t bars) {
  sm90::mbar_init(bars + 8 * kMbFixed, 1);
#pragma unroll
  for (int st = 0; st < D2_ST; ++st) {
    sm90::mbar_init(bars + 8 * (kMbFull + st), 1);
    sm90::mbar_init(bars + 8 * (kMbEmpty + st), kD2Release);
  }
  sm90::mbar_fence_init();
}

// the four column blocks of rows r0 .. r0 + 63 of one head of a tensor map
// into the tile at dst, completing on bar
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* m,
                                          int head, int r0, int b,
                                          uint32_t bar) {
#pragma unroll
  for (int cb = 0; cb < D2_NCH; ++cb) {
    sm90::tma_load_4d(dst + cb * D2_SQ, m, 64 * cb, head, r0, b, bar);
  }
}

}  // namespace

// dK and dV of 64 kv rows of one (batch, query head): the tensor maps view
// q, dO (H heads) and k, v (H_kv heads) as (D, heads, S, B); lse2 and
// delta are (B, H, S_pad) float32 (flash_bwd_prep_kernel's).  K and V of
// the block's rows stay in shared memory, the query tiles that meet them
// stream through the ring.  With PARTIAL (H_kv < H) the head's float32 dK
// and dV go to part (2, B, S, H, D), which flash_bwd_reduce_kernel sums;
// else dK and dV in bf16 at the KV head, which is the query head.
// Consumer thread t holds S^T and dP^T (m64n32) and its dK and dV columns
// (m64n128) in wgmma's layout: element 4 j + 2 h + i at kv row 16 (t / 32)
// + (t % 32) / 4 + 8 h, column 8 j + 2 (t % 4) + i of its half (a query of
// 32 c .., a d of 128 c ..).
template <bool PARTIAL>
__global__ void __launch_bounds__(D2_THREADS, 1)
    flash_bwd_dkdv_wgmma_d256_kernel(const __grid_constant__ CUtensorMap tq,
                                     const __grid_constant__ CUtensorMap tk,
                                     const __grid_constant__ CUtensorMap tv,
                                     const __grid_constant__ CUtensorMap tdo,
                                     const float* __restrict__ lse2,
                                     const float* __restrict__ delta,
                                     bf16* __restrict__ dk,
                                     bf16* __restrict__ dv,
                                     float* __restrict__ part, int S,
                                     int S_pad, int H, int Hkv, int D,
                                     float scale, int causal, int window) {
  using L = DkdvSmem;
  extern __shared__ uint8_t smem_d2[];
  uint8_t* sm =
      smem_d2 + ((1024 - (sm90::smem_addr(smem_d2) & 1023)) & 1023);
  const uint32_t base = sm90::smem_addr(sm);
  // fixed: K at 0, V at D2_TILE; stage st: Q, dO; buffer sb: P^T, dS^T
  auto ring = [&](int st) { return L::kRing + st * 2 * D2_TILE; };
  auto staged = [&](int sb) { return L::kStaged + sb * 2 * D2_SQ; };
  auto rows = [&](int st) { return L::kRows + st * 512; };
  auto mb = [&](int i) { return base + L::kBars + 8 * i; };

  const int b = blockIdx.x / H, h = blockIdx.x % H, hk = h / (H / Hkv);
  const int k0 = blockIdx.y * D2_ROWS;      // low tiles are the long ones
  const int n_q = (S + D2_ROWS - 1) / D2_ROWS;
  // the query tiles that meet kv rows k0 .. k0 + 63: from the diagonal
  // (causal) to the last query within the window of the block's last key
  const int qt_lo = causal ? k0 / D2_ROWS : 0;
  const int qt_hi =
      window ? min(n_q, (k0 + D2_ROWS - 2 + window) / D2_ROWS + 1) : n_q;
  const int n_items = qt_hi - qt_lo;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) init_bars(base + L::kBars);
  __syncthreads();

  if (wg == 0) {                     // producer: one thread issues the TMA
    sm90::setmaxnreg_dec<kD2ProducerRegs>();
    if (threadIdx.x != 0) return;
    sm90::mbar_expect_tx(mb(kMbFixed), 2 * D2_TILE);
    load_tile(base, &tk, hk, k0, b, mb(kMbFixed));
    load_tile(base + D2_TILE, &tv, hk, k0, b, mb(kMbFixed));
    const int64_t rbase = (static_cast<int64_t>(b) * H + h) * S_pad;
    // query tile i goes to stage i % D2_ST once both consumers have
    // released tile i - D2_ST there, with its lse and delta rows
    for (int i = 0; i < n_items; ++i) {
      const int st = i % D2_ST, q0 = (qt_lo + i) * D2_ROWS;
      if (i >= D2_ST) {
        sm90::mbar_wait(mb(kMbEmpty + st), ((i / D2_ST) & 1) ^ 1);
      }
      sm90::mbar_expect_tx(mb(kMbFull + st), 2 * D2_TILE + 512);
      load_tile(base + ring(st), &tq, h, q0, b, mb(kMbFull + st));
      load_tile(base + ring(st) + D2_TILE, &tdo, h, q0, b, mb(kMbFull + st));
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
    const int r0 = 16 * (tid / 32) + lane / 4;   // tile rows r0, r0 + 8
    const int row0 = k0 + r0;                    // kv rows row0, row0 + 8
    const int col0 = 2 * (lane % 4);
    const float scale_log2 = scale * kLog2e;
    float dkacc[64], dvacc[64];
    zero(dkacc);
    zero(dvacc);
    sm90::mbar_wait(mb(kMbFixed), 0);
    for (int i = 0; i < n_items; ++i) {
      const int st = i % D2_ST, sb = i % 2;
      const int qc0 = (qt_lo + i) * D2_ROWS + D2_HALF * c;
      sm90::mbar_wait(mb(kMbFull + st), (i / D2_ST) & 1);
      // S^T = K Q^T and dP^T = V dO^T over this consumer's 32 queries
      const uint32_t sq = base + ring(st), sdo = sq + D2_TILE;
      float s[16], dp[16];
      sm90::wgmma_fence();
      issue_scores(s, base, sq + D2_HALF * c * 128);
      issue_scores(dp, base + D2_TILE, sdo + D2_HALF * c * 128);
      sm90::wgmma_wait<1>();
      sm90::fence_regs(s);
      // P^T = exp2(S^T scale log2(e) - lse log2(e)) under the mask (edge
      // tiles only), in float32 in s
      const float* rl =
          reinterpret_cast<const float*>(sm + rows(st)) + D2_HALF * c;
      const float* rd = rl + D2_ROWS;
      const bool edge =
          edge_tile(qc0, D2_HALF, k0, D2_ROWS, S, causal, window);
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const int col = 8 * (e / 4) + col0 + e % 2;
        const float p = fast_exp2(s[e] * scale_log2 - rl[col]);
        s[e] = (!edge || keeps(qc0 + col, row0 + 8 * ((e / 2) % 2), S,
                               causal, window))
                   ? p
                   : 0.f;
      }
      sm90::wgmma_wait<0>();
      sm90::fence_regs(dp);
      // P^T and dS^T = P^T (dP^T - delta) scale, each rounded to bf16
      // once, into this consumer's half of the staged tiles
      uint32_t pb[8], dsb[8];
#pragma unroll
      for (int x = 0; x < 8; ++x) {
        const int col = 8 * (x / 2) + col0;
        pb[x] = pack_bf16(s[2 * x], s[2 * x + 1]);
        dsb[x] = pack_bf16(s[2 * x] * (dp[2 * x] - rd[col]) * scale,
                           s[2 * x + 1] * (dp[2 * x + 1] - rd[col + 1]) *
                               scale);
      }
      const uint32_t pst = staged(sb), dsst = pst + D2_SQ;
      stage_half<c>(sm + pst, pb, r0, col0);
      stage_half<c>(sm + dsst, dsb, r0, col0);
      sm90::fence_proxy_async();
      sm90::bar_sync<256>(kBarStaged);
      // dV[:, 128 c ..] += P^T dO and dK[:, 128 c ..] += dS^T Q over the
      // tile's 64 queries
      sm90::wgmma_fence();
      issue_accumulate(dvacc, base + pst, sdo + 2 * c * D2_SQ);
      issue_accumulate(dkacc, base + dsst, sq + 2 * c * D2_SQ);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(dvacc);
      sm90::fence_regs(dkacc);
      if (lane == 0) sm90::mbar_arrive(mb(kMbEmpty + st));   // stage read
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int kv = row0 + 8 * hh;
      if (kv >= S) continue;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = 128 * c + 8 * j + col0;   // col + 1 < D with it
        if (col >= D) continue;
        const int e = 4 * j + 2 * hh;
        if constexpr (PARTIAL) {
          const int64_t at =
              ((static_cast<int64_t>(b) * S + kv) * H + h) * D + col;
          const int64_t half = static_cast<int64_t>(gridDim.x) * S * D;
          *reinterpret_cast<float2*>(part + at) =
              make_float2(dkacc[e], dkacc[e + 1]);
          *reinterpret_cast<float2*>(part + half + at) =
              make_float2(dvacc[e], dvacc[e + 1]);
        } else {
          const int64_t at =
              ((static_cast<int64_t>(b) * S + kv) * Hkv + hk) * D + col;
          *reinterpret_cast<__nv_bfloat162*>(dk + at) =
              __floats2bfloat162_rn(dkacc[e], dkacc[e + 1]);
          *reinterpret_cast<__nv_bfloat162*>(dv + at) =
              __floats2bfloat162_rn(dvacc[e], dvacc[e + 1]);
        }
      }
    }
  };
  sm90::setmaxnreg_inc<kD2ConsumerRegs>();
  if (wg == 1) {
    consumer(std::integral_constant<int, 0>());
  } else {
    consumer(std::integral_constant<int, 1>());
  }
}

// dQ of 64 query rows of one (batch, head): Q and dO of the block's rows
// stay in shared memory, the kv tiles that meet them stream through the
// ring.  Consumer thread t holds S and dP (m64n32) and its dQ columns
// (m64n128) in wgmma's layout: element 4 j + 2 h + i at query row 16 (t /
// 32) + (t % 32) / 4 + 8 h, column 8 j + 2 (t % 4) + i of its half (a key
// of 32 c .., a d of 128 c ..).
__global__ void __launch_bounds__(D2_THREADS, 1)
    flash_bwd_dq_wgmma_d256_kernel(const __grid_constant__ CUtensorMap tq,
                                   const __grid_constant__ CUtensorMap tk,
                                   const __grid_constant__ CUtensorMap tv,
                                   const __grid_constant__ CUtensorMap tdo,
                                   const float* __restrict__ lse2,
                                   const float* __restrict__ delta,
                                   bf16* __restrict__ dq, int S, int S_pad,
                                   int H, int Hkv, int D, float scale,
                                   int causal, int window) {
  using L = DqSmem;
  extern __shared__ uint8_t smem_d2[];
  uint8_t* sm =
      smem_d2 + ((1024 - (sm90::smem_addr(smem_d2) & 1023)) & 1023);
  const uint32_t base = sm90::smem_addr(sm);
  // fixed: Q at 0, dO at D2_TILE; stage st: K, V; buffer sb: dS
  auto ring = [&](int st) { return L::kRing + st * 2 * D2_TILE; };
  auto staged = [&](int sb) { return L::kStaged + sb * D2_SQ; };
  auto mb = [&](int i) { return base + L::kBars + 8 * i; };

  const int b = blockIdx.x / H, h = blockIdx.x % H, hk = h / (H / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * D2_ROWS;   // longest first
  const int n_k = (S + D2_ROWS - 1) / D2_ROWS;
  // kv tiles from the first inside the window of the block's first query
  // to the diagonal's (causal)
  const int j0 = window ? max(0, q0 - window + 1) / D2_ROWS : 0;
  const int j_hi = causal ? min(n_k, q0 / D2_ROWS + 1) : n_k;
  const int n_items = j_hi - j0;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) init_bars(base + L::kBars);
  __syncthreads();

  if (wg == 0) {                     // producer
    sm90::setmaxnreg_dec<kD2ProducerRegs>();
    if (threadIdx.x != 0) return;
    sm90::mbar_expect_tx(mb(kMbFixed), 2 * D2_TILE);
    load_tile(base, &tq, h, q0, b, mb(kMbFixed));
    load_tile(base + D2_TILE, &tdo, h, q0, b, mb(kMbFixed));
    for (int j = 0; j < n_items; ++j) {
      const int st = j % D2_ST, r0 = (j0 + j) * D2_ROWS;
      if (j >= D2_ST) {
        sm90::mbar_wait(mb(kMbEmpty + st), ((j / D2_ST) & 1) ^ 1);
      }
      sm90::mbar_expect_tx(mb(kMbFull + st), 2 * D2_TILE);
      load_tile(base + ring(st), &tk, hk, r0, b, mb(kMbFull + st));
      load_tile(base + ring(st) + D2_TILE, &tv, hk, r0, b, mb(kMbFull + st));
    }
    return;
  }

  auto consumer = [&](auto index) {
    constexpr int c = decltype(index)::value;
    const int tid = threadIdx.x % 128, lane = tid % 32;
    const int r0 = 16 * (tid / 32) + lane / 4;   // tile rows r0, r0 + 8
    const int row0 = q0 + r0;                    // query rows row0, + 8
    const int col0 = 2 * (lane % 4);
    const float scale_log2 = scale * kLog2e;
    // this thread's two rows' lse log2(e) and delta (S_pad covers them)
    const int64_t rbase = (static_cast<int64_t>(b) * H + h) * S_pad + row0;
    const float rl[2] = {lse2[rbase], lse2[rbase + 8]};
    const float rd[2] = {delta[rbase], delta[rbase + 8]};
    float dqacc[64];
    zero(dqacc);
    sm90::mbar_wait(mb(kMbFixed), 0);
    for (int j = 0; j < n_items; ++j) {
      const int st = j % D2_ST, sb = j % 2;
      const int kc0 = (j0 + j) * D2_ROWS + D2_HALF * c;
      sm90::mbar_wait(mb(kMbFull + st), (j / D2_ST) & 1);
      // S = Q K^T and dP = dO V^T over this consumer's 32 keys
      const uint32_t sk = base + ring(st), sv = sk + D2_TILE;
      float s[16], dp[16];
      sm90::wgmma_fence();
      issue_scores(s, base, sk + D2_HALF * c * 128);
      issue_scores(dp, base + D2_TILE, sv + D2_HALF * c * 128);
      sm90::wgmma_wait<1>();
      sm90::fence_regs(s);
      const bool edge =
          edge_tile(q0, D2_ROWS, kc0, D2_HALF, S, causal, window);
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const int hh = (e / 2) % 2;
        const float p = fast_exp2(s[e] * scale_log2 - rl[hh]);
        s[e] = (!edge || keeps(row0 + 8 * hh,
                               kc0 + 8 * (e / 4) + col0 + e % 2, S, causal,
                               window))
                   ? p
                   : 0.f;
      }
      sm90::wgmma_wait<0>();
      sm90::fence_regs(dp);
      // dS = P (dP - delta) scale, rounded to bf16 once, into this
      // consumer's half of the staged tile
      uint32_t dsb[8];
#pragma unroll
      for (int x = 0; x < 8; ++x) {
        const float d = rd[x % 2];
        dsb[x] = pack_bf16(s[2 * x] * (dp[2 * x] - d) * scale,
                           s[2 * x + 1] * (dp[2 * x + 1] - d) * scale);
      }
      const uint32_t dsst = staged(sb);
      stage_half<c>(sm + dsst, dsb, r0, col0);
      sm90::fence_proxy_async();
      sm90::bar_sync<256>(kBarStaged);
      // dQ[:, 128 c ..] += dS K over the tile's 64 keys
      sm90::wgmma_fence();
      issue_accumulate(dqacc, base + dsst, sk + 2 * c * D2_SQ);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(dqacc);
      if (lane == 0) sm90::mbar_arrive(mb(kMbEmpty + st));   // stage read
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = row0 + 8 * hh;
      if (row >= S) continue;
      bf16* out = dq + ((static_cast<int64_t>(b) * S + row) * H + h) * D;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = 128 * c + 8 * j + col0;
        if (col >= D) continue;
        const int e = 4 * j + 2 * hh;
        *reinterpret_cast<__nv_bfloat162*>(out + col) =
            __floats2bfloat162_rn(dqacc[e], dqacc[e + 1]);
      }
    }
  };
  sm90::setmaxnreg_inc<kD2ConsumerRegs>();
  if (wg == 1) {
    consumer(std::integral_constant<int, 0>());
  } else {
    consumer(std::integral_constant<int, 1>());
  }
}

namespace {

// the route's inputs: 128 < D <= 256, D % 8 == 0 (16-byte rows for TMA),
// 16-byte aligned bases
bool d2_takes(int D, const void* a, const void* b, const void* c,
              const void* d) {
  return D > 128 && D <= 256 && D % 8 == 0 && sm90::aligned16(a) &&
         sm90::aligned16(b) && sm90::aligned16(c) && sm90::aligned16(d);
}

template <bool PARTIAL>
int launch_dkdv(const CUtensorMap (&maps)[4], const float* lse2,
                const float* delta, void* dk, void* dv, float* part, int B,
                int S, int S_pad, int H, int Hkv, int D, float scale,
                int causal, int window, cudaStream_t st) {
  auto kernel = flash_bwd_dkdv_wgmma_d256_kernel<PARTIAL>;
  constexpr int smem = DkdvSmem::kBytes;
  static bool configured = false;
  const cudaError_t err = sm90::allow_smem(kernel, smem, configured);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, (S + D2_ROWS - 1) / D2_ROWS);
  kernel<<<grid, D2_THREADS, smem, st>>>(
      maps[0], maps[1], maps[2], maps[3], lse2, delta, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), part, S, S_pad, H, Hkv, D, scale, causal,
      window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dk, dv (B, S, Hkv, D) bf16 from q, dout (B, S, H, D), k, v (B, S, Hkv,
// D) bf16 and repro_flash_bwd_prep's lse2 and delta (B, H, S_pad); with
// Hkv < H, part (2, B, S, H, D) float32 takes the per-query-head partials
// and repro_flash_bwd_reduce writes dk and dv
extern "C" int repro_flash_bwd_dkdv_wgmma_d256(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse2, const void* delta, void* dk, void* dv, void* part,
    int32_t B, int32_t S, int32_t S_pad, int32_t H, int32_t Hkv, int32_t D,
    float scale, int32_t causal, int32_t window, void* stream) {
  if (!d2_takes(D, q, k, v, dout) || (Hkv != H && part == nullptr) ||
      S_pad < (S + D2_ROWS - 1) / D2_ROWS * D2_ROWS) {
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
  return Hkv != H ? launch_dkdv<true>(maps, ls, dl, dk, dv, pt, B, S, S_pad,
                                      H, Hkv, D, scale, causal, window, st)
                  : launch_dkdv<false>(maps, ls, dl, dk, dv, pt, B, S, S_pad,
                                       H, Hkv, D, scale, causal, window, st);
}

// dq (B, S, H, D) bf16, the same inputs as repro_flash_bwd_dkdv_wgmma_d256
extern "C" int repro_flash_bwd_dq_wgmma_d256(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse2, const void* delta, void* dq, int32_t B, int32_t S,
    int32_t S_pad, int32_t H, int32_t Hkv, int32_t D, float scale,
    int32_t causal, int32_t window, void* stream) {
  if (!d2_takes(D, q, k, v, dout) ||
      S_pad < (S + D2_ROWS - 1) / D2_ROWS * D2_ROWS) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap maps[4] = {};
  if (!sm90::bwd_tile_maps(maps, q, k, v, dout, B, S, H, Hkv, D)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = flash_bwd_dq_wgmma_d256_kernel;
  constexpr int smem = DqSmem::kBytes;
  static bool configured = false;
  const cudaError_t err = sm90::allow_smem(kernel, smem, configured);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, (S + D2_ROWS - 1) / D2_ROWS);
  kernel<<<grid, D2_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const float*>(lse2),
      static_cast<const float*>(delta), static_cast<bf16*>(dq), S, S_pad, H,
      Hkv, D, scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}
