// Backward of fused softmax attention (flash attention) in float32 for
// Hopper (sm_90a): dQ, dK and dV on 3xTF32 wgmma.  The wrapper's route
// "tf32" (flash_attn/ops.py::bwd_route): every float32 call with D <= 128,
// whatever its strides' alignment (D % 4 != 0 or unaligned rows load
// element by element).  The bfloat16 routes are flash_attn_bwd.cu's.
//
// Replaces no Pallas kernel: the reference differentiates its model
// attention through repro/models/layers.py::_flash_bwd, the plain jnp
// custom_vjp of _flash_attention.  The arithmetic is the reference's:
//   delta = rowsum(dO o O), P = exp(S scale - lse) under the mask,
//   dV = P^T dO, dS = P o (dP - delta) scale with dP = dO V^T,
//   dQ = dS K, dK = dS^T Q,
// each product on TF32 tensor cores with its operands split into x_hi =
// tf32(x) and x_lo = tf32(x - x_hi) (tf32.cuh), taken as a_hi b_hi + a_hi
// b_lo + a_lo b_hi with float32 sums (a_lo b_lo, about 2^-22 relative,
// left out).  One TF32 product alone misses float32's limit
// (tests/test_torch_tf32.py).  P = exp2(S scale log2(e) - lse log2(e))
// (ex2.approx), as on the bf16 route.
//
// Three launches, four at H_kv < H (the wrapper's bwd_launches):
//   flash_bwd_delta_kernel<float> (flash_attn_bwd.cu)  delta (B, H, S);
//   flash_bwd_dkdv_tf32_kernel  a block per (batch, query head, 64 kv
//       rows), the low kv rows (the causal triangle's long blocks) first;
//   flash_bwd_reduce_kernel<float> (flash_attn_bwd.cu)  at H_kv < H, the
//       query heads' float32 partial dK and dV summed in head order;
//   flash_bwd_dq_tf32_kernel  a block per (batch, head, 64 query rows),
//       the longest first.
// lse is read as the forward wrote it, (B, H, S) natural log, and scaled
// by log2(e) in the kernels (no padded row pass as on the bf16 route:
// nothing here is read by TMA).
//
// A block is two warpgroups: a consumer (64 rows, wgmma's M) and a
// producer.  The consumer keeps "fixed" operands for the whole block: K
// and V of its kv rows (dK/dV kernel) or Q and dO of its query rows (dQ
// kernel), split once into hi and lo tiles by the producer.  The producer
// streams the other side in tiles of T rows (Q and dO, or K and V; T 16
// in the dK/dV kernel at D > 64, else 32, see (3)): it loads each tile
// into registers with 16-byte loads while the consumer works on the tile
// before, splits every value once, and stores it in the layouts its
// products read, behind named barriers.  A stage has two
// halves, handed over apart: the stacked tiles (and the tile's lse and
// delta) are released once S and dP have retired, so the producer stores
// the next ones while the consumer runs the accumulating products, which
// read the transposed tiles.  (Issuing the next tile's S and dP behind a
// tile's accumulating products measured slower on the card, and two
// consumer warpgroups in the dK/dV kernel, one for dV and one for dK with
// P^T handed over in shared memory, no faster: neither kept.)
//
// dK/dV kernel, for each query tile: S^T = K Q^T and dP^T = V dO^T (kv
// rows as M, both operands in shared memory: K_hi against Q's stacked
// [Q_hi; Q_lo], one m64n(2T)k8 a k step, and K_lo against Q_hi, one
// m64nTk8 into an accumulator of its own, the three T-wide parts then
// added), P^T and dS^T = P^T (dP^T - delta) scale in registers, masked
// on edge tiles only; dV += P^T dO and dK += dS^T Q as m64nDk8 with P^T
// and dS^T split into the register A operand and dO^T, Q^T from shared
// memory.  dQ kernel, for each kv tile: S = Q K^T and dP = dO V^T (query
// rows as M), P and dS, dQ += dS K with K^T.  dK, dV and dQ stay in
// float32 registers (64 a thread each at D 128) and are stored in float32
// (dK and dV also every 1024 query rows, see (4)).
//
// How the design meets what makes this hard:
// (1) TF32 wgmma has no transpose bit: both operands are K-major.  S^T
//     and dP^T need Q and dO with D contiguous, as they stand; dV and dK
//     need dO and Q with the query axis contiguous, dQ needs K with the kv
//     axis contiguous.  TMA cannot split or transpose, so the producer
//     stages each streamed tile twice from the same split registers:
//     "stacked", 2T rows of 128-byte column blocks (hi rows 0 .. T - 1,
//     lo rows T .. 2T - 1, D along the row), and "transposed", a 128-byte
//     row a d (T 16: the tile's 16 hi values, then its 16 lo values; T
//     32: a tile of hi rows and one of lo rows).  The accumulating
//     products keep their natural form (A = P^T, dS^T or dS from the
//     accumulator; no transposed product, no P through shared memory).
// (2) The register A operand's order: the accumulator holds columns
//     {2t, 2t + 1} of each 8-column block where TF32's A operand wants
//     {t, t + 4}, so the transposed rows permute the contracted axis:
//     position 8 b + i (i < 4) holds tile row 8 b + 2 i, 8 b + 4 + i row
//     8 b + 2 i + 1 (the forward's V^T, flash_attn.cu), and
//     split_p_tf32 hands P^T, dS^T and dS to the tensor cores without a
//     shuffle.  The producer loads a tile as 4 x 4 items (4 rows of one
//     permuted chunk by 4 d values), which it stores row by row into the
//     stacked tile and column by column into the transposed one.
// (3) Shared memory (D 128; D <= 64 halves every tile): the fixed
//     operands 4 x 32 KB (hi and lo of two 64 x 128 float32 tiles), and
//     a stage of T streamed rows, 4 KB a row in the dK/dV kernel (Q and
//     dO, stacked and transposed) and 3 KB a row in dQ (K stacked and
//     transposed, V stacked): dK/dV at T 16 193 KB, dQ at T 32 225 KB (of
//     227), one block an SM, one consumer warpgroup (two would need the
//     fixed tiles twice), no setmaxnreg (a 256-thread block has 255
//     registers a thread).  32-row query tiles fit the dK/dV kernel at D
//     <= 64 only (129 KB).  A wider tile halves the fixed operand's reads
//     from shared memory per product (m64n64k8 in place of m64n32k8).
// (4) The tensor cores' float32 accumulation truncates (flash_attn_bwd.cu:
//     a group's G S / 8 k steps in one accumulator went past 2^-14), so at
//     H_kv < H each query head writes its own float32 partial dK and dV to
//     part (2, B, S, H, D) and flash_bwd_reduce_kernel sums them in head
//     order.  At G 1 and S 4096 (the training gate's length) dK and dV
//     over 512 k steps of three terms in one accumulator still reached
//     0.8 of 2^-14 on the card (dV), so the dK/dV kernel moves its
//     accumulators into the float32 output every 64 query tiles (1024
//     rows: the first time a store, then a read, an IEEE add and a store,
//     in a fixed order; nothing at S <= 1024).  dQ over the same length
//     stayed near 0.03 of its limit and keeps one accumulator.
// (5) The row pass is flash_bwd_delta_kernel's float32 instantiation, one
//     launch as before: the launch count stays bwd_launches'.
// (6) No atomics: every sum is taken in an order fixed by the shape, so
//     two calls give the same bits.
// Every wgmma accumulates (S and dP are zeroed first: a first product
// that overwrites its accumulator leaves ptxas too few registers for the
// pipeline, flash_attn.cu), descriptors are built from 32-bit addresses
// and every register operand and accumulator is fenced until its wait,
// so that ptxas keeps the wgmma pipeline (no C7510-C7515 note).
//
// Bound: operations, the five products' three TF32 terms at 495 TFLOP/s
// (bwd-f, 1 x 1024 x 20 x 128 causal: 81.4 us); these kernels take seven
// products (S and dP twice).
#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "sm90.cuh"
#include "tf32.cuh"

namespace {

using sm90::bar_arrive;
using sm90::bar_sync;
using sm90::edge_tile;
using sm90::fast_exp2;
using sm90::keeps;
using sm90::opaque;
using tf32::load4;
using tf32::RowTile;
using tf32::split_p_tf32;
using tf32::split_tf32;
using tf32::tf32_rs_k8;
using tf32::tf32_ss_m64n16k8;
using tf32::tf32_ss_m64n32k8;
using tf32::tf32_ss_m64n64k8;

constexpr int TB_M = 64;            // rows a block keeps: wgmma's M
constexpr int TB_THREADS = 256;     // the consumer, then the producer
constexpr float kLog2eTf = 1.4426950408889634f;
// named barriers (0 is __syncthreads' own), each over all 256 threads:
// the fixed tiles staged; a stage's stacked half (S) and transposed half
// (T) staged (full) or read (empty)
constexpr int kBarFixed = 1, kBarSFull = 2, kBarSEmpty = 3, kBarTFull = 4,
              kBarTEmpty = 5;
// dK and dV leave the tensor cores' accumulators for their float32 outputs
// every kFlushRows query rows (128 k steps of three terms an accumulator
// pass; see (4))
constexpr int kFlushRows = 1024;

// Shared memory of a block with NCH column blocks of 32 floats (D <= 32
// NCH) and stream tiles of T rows (16 or 32): the fixed tiles A1 hi, A1
// lo, A2 hi, A2 lo (64 rows of each column block), the stacked tiles X and
// Y (each column block: the stream tile's T hi rows, then its T lo rows),
// NT transposed tiles (X^T, and Y^T in the dK/dV kernel: 32 NCH rows of
// 128 bytes, T 16: a row's 16 hi values, then its 16 lo values; T 32: a
// tile of hi rows, then one of lo rows), then the stream tile's lse
// log2(e) and delta (dK/dV kernel)
template <int NCH, int NT, int T>
struct TbSmem {
  static constexpr int kFixed = TB_M * 128 * NCH;
  static constexpr int kStacked = 2 * T * 128 * NCH;
  // where a descriptor finds the lo values: T 16 64 bytes into the row,
  // T 32 the lo tile
  static constexpr int kLo = T == 16 ? 64 : 32 * NCH * 128;
  static constexpr int kTrans = (T / 16) * 32 * NCH * 128;
  static constexpr int kX = 4 * kFixed, kY = kX + kStacked;
  static constexpr int kXt = kY + kStacked, kYt = kXt + kTrans;
  static constexpr int kRows = kXt + NT * kTrans;
  static constexpr int kBytes = kRows + 2 * T * 4 + 1024;   // + align
};

// The T rows [r0, r0 + T) of one (batch, head), as 4 x 4 items: item (c,
// g), c < T / 4, g < 8 NCH, holds rows 8 (c / 2) + c % 2 + 2 i (i < 4) at
// columns 4 g .. 4 g + 3, which are chunk c of the transposed rows 4 g ..
// 4 g + 3 (the permuted order of (2)) and chunk g of four stacked rows.
// The 128 producer threads (pt) take items pt, pt + 128, ... (c = e % (T
// / 4): the eight threads of a 128-byte store wavefront write eight
// distinct chunks of the transposed tile).  load() issues the loads (zeros
// past S and D), split() splits each value once, store_*() write hi and
// lo.
template <int NCH, int T>
struct StreamTile {
  static constexpr int C = T / 4;              // chunks of a transposed row
  static constexpr int kItems = C * 8 * NCH;
  static constexpr int kPer = (kItems + 127) / 128;
  float4 v[kPer][4];
  uint32_t h[kPer][4][4], l[kPer][4][4];   // item, row i, column j

  __device__ __forceinline__ static int row(int c, int i) {
    return 8 * (c / 2) + c % 2 + 2 * i;
  }
  __device__ __forceinline__ void load(const float* src, int64_t rs, int r0,
                                       int S, int D, int pt, bool vec) {
#pragma unroll
    for (int x = 0; x < kPer; ++x) {
      const int e = opaque(pt) + x * 128, c = e % C, g = e / C;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = r0 + row(c, i);
        v[x][i] = load4(src + static_cast<int64_t>(r) * rs, 4 * g, D,
                        e < kItems && r < S, vec);
      }
    }
  }
  __device__ __forceinline__ void split() {
#pragma unroll
    for (int x = 0; x < kPer; ++x) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        split_tf32(v[x][i].x, h[x][i][0], l[x][i][0]);
        split_tf32(v[x][i].y, h[x][i][1], l[x][i][1]);
        split_tf32(v[x][i].z, h[x][i][2], l[x][i][2]);
        split_tf32(v[x][i].w, h[x][i][3], l[x][i][3]);
      }
    }
  }
  // row r of the tile into stacked row r (hi) and T + r (lo)
  __device__ __forceinline__ void store_stacked(uint8_t* t, int pt) const {
#pragma unroll
    for (int x = 0; x < kPer; ++x) {
      const int e = opaque(pt) + x * 128, c = e % C, g = e / C;
      if (e >= kItems) continue;
      uint8_t* cb = t + (g / 8) * 2 * T * 128;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t off = sm90::sw128(row(c, i), g % 8);
        *reinterpret_cast<uint4*>(cb + off) =
            make_uint4(h[x][i][0], h[x][i][1], h[x][i][2], h[x][i][3]);
        *reinterpret_cast<uint4*>(cb + off + T * 128) =
            make_uint4(l[x][i][0], l[x][i][1], l[x][i][2], l[x][i][3]);
      }
    }
  }
  // column 4 g + j of the tile into transposed row 4 g + j: chunk c of
  // the hi row, and chunk c of the lo row (T 32: the same row of the lo
  // tile; T 16: chunk 4 + c of the same row, which is what a descriptor 64
  // bytes on reads through the swizzle's XOR)
  __device__ __forceinline__ void store_trans(uint8_t* t, int pt) const {
    constexpr int kLoTile = T == 16 ? 0 : 32 * NCH * 128;
    constexpr int kLoChunk = T == 16 ? 4 : 0;
#pragma unroll
    for (int x = 0; x < kPer; ++x) {
      const int e = opaque(pt) + x * 128, c = e % C, g = e / C;
      if (e >= kItems) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        *reinterpret_cast<uint4*>(t + sm90::sw128(4 * g + j, c)) =
            make_uint4(h[x][0][j], h[x][1][j], h[x][2][j], h[x][3][j]);
        *reinterpret_cast<uint4*>(t + kLoTile +
                                  sm90::sw128(4 * g + j, kLoChunk + c)) =
            make_uint4(l[x][0][j], l[x][1][j], l[x][2][j], l[x][3][j]);
      }
    }
  }
};

// The producer warpgroup of either kernel (pt = its thread, 0-127): the
// fixed tiles from rows [m0, m0 + 64) of a1 and a2 (rows ars apart), then
// n stream tiles, tile i rows (t0 + i) T.. of x and y (rows xrs apart):
// X stacked and transposed, Y stacked and, with TRANS_Y, transposed, and
// with rows (lse, delta of the head, not null) the tile rows' lse log2(e)
// and delta (zeros past S)
template <int NCH, int T, bool TRANS_Y>
__device__ __forceinline__ void produce(uint8_t* sm, const float* a1,
                                        const float* a2, int64_t ars, int m0,
                                        const float* x, const float* y,
                                        int64_t xrs, int t0, int n,
                                        const float* lse,
                                        const float* delta, int S, int D,
                                        bool vec, int pt) {
  using L = TbSmem<NCH, TRANS_Y ? 2 : 1, T>;
#pragma unroll 1
  for (int part = 0; part < 4; ++part) {         // 32 rows at a time
    const int f = 2 * (part / 2), r = (part % 2) * 32;
    RowTile<32, NCH, TB_M, 128> ft;
    ft.load(part < 2 ? a1 : a2, ars, m0 + r, S, D, pt, vec);
    ft.store(sm + f * L::kFixed + r * 128, sm + (f + 1) * L::kFixed + r * 128,
             pt);
  }
  sm90::fence_proxy_async();
  bar_arrive<TB_THREADS>(kBarFixed);
  StreamTile<NCH, T> xt, yt;
  float* s_rows = reinterpret_cast<float*>(sm + L::kRows);
  auto load_rows = [&](int i, float& rl, float& rd) {
    const int r = (t0 + i) * T + pt;
    rl = r < S ? lse[r] * kLog2eTf : 0.f;
    rd = r < S ? delta[r] : 0.f;
  };
  const bool rows = lse != nullptr && pt < T;
  float rl = 0.f, rd = 0.f;
  xt.load(x, xrs, t0 * T, S, D, pt, vec);
  yt.load(y, xrs, t0 * T, S, D, pt, vec);
  if (rows) load_rows(0, rl, rd);
  for (int i = 0; i < n; ++i) {
    xt.split();
    yt.split();
    // the next tile's loads in flight while this one is stored
    float nrl = 0.f, nrd = 0.f;
    if (i + 1 < n) {
      xt.load(x, xrs, (t0 + i + 1) * T, S, D, pt, vec);
      yt.load(y, xrs, (t0 + i + 1) * T, S, D, pt, vec);
      if (rows) load_rows(i + 1, nrl, nrd);
    }
    if (i > 0) bar_sync<TB_THREADS>(kBarSEmpty);
    xt.store_stacked(sm + L::kX, pt);
    yt.store_stacked(sm + L::kY, pt);
    if (rows) {
      s_rows[pt] = rl;
      s_rows[T + pt] = rd;
    }
    sm90::fence_proxy_async();
    bar_arrive<TB_THREADS>(kBarSFull);
    if (i > 0) bar_sync<TB_THREADS>(kBarTEmpty);
    xt.store_trans(sm + L::kXt, pt);
    if constexpr (TRANS_Y) yt.store_trans(sm + L::kYt, pt);
    sm90::fence_proxy_async();
    bar_arrive<TB_THREADS>(kBarTFull);
    rl = nrl;
    rd = nrd;
  }
}

// A B^T over D in three TF32 terms: A the fixed tile pair (hi at a_hi, lo
// at a_lo), B the stacked tile at b ([B_hi; B_lo], 2T rows), 4 NCH k
// steps, one wgmma group: sc (64 x 2T) += A_hi [B_hi; B_lo]^T (columns 0
// .. T - 1 A_hi B_hi^T, T .. 2T - 1 A_hi B_lo^T) and sl (64 x T) += A_lo
// B_hi^T (its own accumulator: a wgmma of another shape on sc's registers
// would need a fence between them).  sum3() adds the three
template <int NCH, int T>
__device__ __forceinline__ void issue_st(float (&sc)[T], float (&sl)[T / 2],
                                         uint32_t a_hi, uint32_t a_lo,
                                         uint32_t b) {
#pragma unroll
  for (int ks = 0; ks < 4 * NCH; ++ks) {
    const uint32_t oa = (ks / 4) * TB_M * 128 + (ks % 4) * 32;
    const uint64_t db = sm90::desc_sw128(
        b + (ks / 4) * 2 * T * 128 + (ks % 4) * 32, 16, 1024);
    const uint64_t dh = sm90::desc_sw128(a_hi + oa, 16, 1024);
    const uint64_t dl = sm90::desc_sw128(a_lo + oa, 16, 1024);
    if constexpr (T == 16) {
      tf32_ss_m64n32k8(sc, dh, db, 1);
      tf32_ss_m64n16k8(sl, dl, db, 1);
    } else {
      static_assert(T == 32, "stream tiles of 16 or 32 rows");
      tf32_ss_m64n64k8(sc, dh, db, 1);
      tf32_ss_m64n32k8(sl, dl, db, 1);
    }
  }
  sm90::wgmma_commit();
}

// A_hi B_hi^T + (A_hi B_lo^T + A_lo B_hi^T), into sc[0 .. T / 2 - 1]
template <int T>
__device__ __forceinline__ void sum3(float (&sc)[T],
                                     const float (&sl)[T / 2]) {
#pragma unroll
  for (int e = 0; e < T / 2; ++e) sc[e] += sc[T / 2 + e] + sl[e];
}

// acc (64 x DN) += A B: A (64 x T) split into registers (ah, al: T / 8 k
// steps of four), B the transposed tile at t (DN rows of the T hi values,
// the contracted axis permuted; the lo values lo bytes on), three terms,
// small first; one wgmma group
template <int DN, int T>
__device__ __forceinline__ void issue_acc(float (&acc)[DN / 2],
                                          const uint32_t (&ah)[T / 2],
                                          const uint32_t (&al)[T / 2],
                                          uint32_t t, int lo) {
#pragma unroll
  for (int ks = 0; ks < T / 8; ++ks) {
    const uint64_t bh = sm90::desc_sw128(t + ks * 32, 16, 1024);
    const uint64_t bl = sm90::desc_sw128(t + lo + ks * 32, 16, 1024);
    tf32_rs_k8<DN>(acc, al + 4 * ks, bh);
    tf32_rs_k8<DN>(acc, ah + 4 * ks, bl);
    tf32_rs_k8<DN>(acc, ah + 4 * ks, bh);
  }
  sm90::wgmma_commit();
}

// the accumulator's column of element e (< 8: the tile's 16 columns)
__device__ __forceinline__ int acc_col(int e, int col0) {
  return 8 * (e / 4) + col0 + e % 2;
}

// the consumer's float32 acc (64 x DN, rows row0 + 8 h of its thread) to
// rows of one head of a (B, S, heads, D) tensor (out: its (b, row 0)),
// stored, or with add added to what an earlier call of this thread stored
// there (IEEE float32 sums, in the order of the calls); acc is zeroed
template <int DN>
__device__ __forceinline__ void store_acc(float* out, int64_t rs,
                                          float (&acc)[DN / 2], int row0,
                                          int col0, int S, int D, bool vec,
                                          bool add) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = row0 + 8 * hh;
    float* o = out + static_cast<int64_t>(r) * rs;
#pragma unroll
    for (int j = 0; j < DN / 8; ++j) {
      const int col = 8 * j + col0;
      float a = acc[4 * j + 2 * hh], b = acc[4 * j + 2 * hh + 1];
      acc[4 * j + 2 * hh] = acc[4 * j + 2 * hh + 1] = 0.f;
      if (r >= S) continue;
      if (vec && col + 1 < D) {
        float2* p = reinterpret_cast<float2*>(o + col);
        if (add) {
          const float2 x = *p;
          a += x.x;
          b += x.y;
        }
        *p = make_float2(a, b);
      } else {
        if (col < D) o[col] = add ? o[col] + a : a;
        if (col + 1 < D) o[col + 1] = add ? o[col + 1] + b : b;
      }
    }
  }
}

}  // namespace

// dK and dV of 64 kv rows of one (batch, query head): the fixed tiles are
// K and V of rows k0.., the stream Q and dO of the query tiles that meet
// them, from the diagonal (causal) to the last within the window of the
// block's last key.  dk_out, dv_out (B, S, H, D): dK and dV (H_kv == H),
// or this query head's float32 partials (H_kv < H).
// Consumer thread t holds S^T, dP^T and dK, dV in wgmma's layout: element
// 4 j + 2 h + i at kv row 16 (t / 32) + (t % 32) / 4 + 8 h, column 8 j +
// 2 (t % 4) + i (a query of the tile, a d).
template <int NCH, int T>
__global__ void __launch_bounds__(TB_THREADS, 1)
    flash_bwd_dkdv_tf32_kernel(const float* __restrict__ q,
                               const float* __restrict__ k,
                               const float* __restrict__ v,
                               const float* __restrict__ dout,
                               const float* __restrict__ lse,
                               const float* __restrict__ delta,
                               float* __restrict__ dk_out,
                               float* __restrict__ dv_out, int S, int H,
                               int Hkv, int D, float scale, int causal,
                               int window, int vec) {
  using L = TbSmem<NCH, 2, T>;
  constexpr int DN = 32 * NCH;
  constexpr int kFlushTiles = kFlushRows / T;
  extern __shared__ uint8_t smem_tb[];
  uint8_t* sm = smem_tb + ((1024 - (sm90::smem_addr(smem_tb) & 1023)) & 1023);
  const int b = blockIdx.x / H, h = blockIdx.x % H, hk = h / (H / Hkv);
  const int k0 = blockIdx.y * TB_M;
  const int n_q = (S + T - 1) / T;
  const int qt_lo = causal ? k0 / T : 0;
  const int qt_hi = window ? min(n_q, (k0 + TB_M - 2 + window) / T + 1) : n_q;
  const int n = qt_hi - qt_lo;
  const int64_t qrs = static_cast<int64_t>(H) * D;
  const int64_t krs = static_cast<int64_t>(Hkv) * D;
  const int64_t qbase = (static_cast<int64_t>(b) * S * H + h) * D;
  const int64_t kbase = (static_cast<int64_t>(b) * S * Hkv + hk) * D;
  const int64_t rbase = (static_cast<int64_t>(b) * H + h) * S;

  if (threadIdx.x >= 128) {
    produce<NCH, T, true>(sm, k + kbase, v + kbase, krs, k0, q + qbase,
                          dout + qbase, qrs, qt_lo, n, lse + rbase,
                          delta + rbase, S, D, vec, threadIdx.x - 128);
    return;
  }
  const int tid = threadIdx.x, lane = tid % 32;
  const int row0 = k0 + 16 * (tid / 32) + lane / 4;    // kv rows row0, + 8
  const int col0 = 2 * (lane % 4);
  const float scale_log2 = scale * kLog2eTf;
  const float* s_rows = reinterpret_cast<const float*>(sm + L::kRows);
  float dk[DN / 2], dv[DN / 2];
#pragma unroll
  for (int e = 0; e < DN / 2; ++e) dk[e] = dv[e] = 0.f;
  bar_sync<TB_THREADS>(kBarFixed);
  for (int i = 0; i < n; ++i) {
    const int q0 = (qt_lo + i) * T;
    const uint32_t base = opaque(sm90::smem_addr(sm));
    float s[T], dp[T], sl[T / 2], dpl[T / 2];
#pragma unroll
    for (int e = 0; e < T; ++e) s[e] = dp[e] = 0.f;
#pragma unroll
    for (int e = 0; e < T / 2; ++e) sl[e] = dpl[e] = 0.f;
    bar_sync<TB_THREADS>(kBarSFull);
    // S^T = K Q^T and dP^T = V dO^T, two groups in flight
    sm90::wgmma_fence();
    issue_st<NCH, T>(s, sl, base, base + L::kFixed, base + L::kX);
    issue_st<NCH, T>(dp, dpl, base + 2 * L::kFixed, base + 3 * L::kFixed,
                     base + L::kY);
    // the tile rows' lse log2(e) and delta for this thread's columns (x:
    // column 8 (x / 2) + col0 + x % 2, element e's x = 2 (e / 4) + e % 2)
    float rl[T / 4], rd[T / 4];
#pragma unroll
    for (int x = 0; x < T / 4; ++x) {
      rl[x] = s_rows[8 * (x / 2) + col0 + x % 2];
      rd[x] = s_rows[T + 8 * (x / 2) + col0 + x % 2];
    }
    sm90::wgmma_wait<1>();
    sm90::fence_regs(s);
    sm90::fence_regs(sl);
    sum3(s, sl);
    // P^T = exp2(S^T scale log2(e) - lse log2(e)) under the mask
    const bool edge = edge_tile(q0, T, k0, TB_M, S, causal, window);
#pragma unroll
    for (int e = 0; e < T / 2; ++e) {
      const float p = fast_exp2(s[e] * scale_log2 - rl[2 * (e / 4) + e % 2]);
      s[e] = (!edge || keeps(q0 + acc_col(e, col0), row0 + 8 * ((e / 2) % 2),
                             S, causal, window))
                 ? p
                 : 0.f;
    }
    uint32_t ph[T / 2], pl[T / 2];
    split_p_tf32(s, ph, pl);
    // dV += P^T dO, in flight while dS^T is formed
    bar_sync<TB_THREADS>(kBarTFull);
    sm90::wgmma_fence();
    issue_acc<DN, T>(dv, ph, pl, base + L::kYt, L::kLo);
    sm90::wgmma_wait<1>();
    sm90::fence_regs(dp);
    sm90::fence_regs(dpl);
    // stacked tiles and rows read (the producer waits for the next tile's)
    if (i + 1 < n) bar_arrive<TB_THREADS>(kBarSEmpty);
    // dS^T = P^T (dP^T - delta) scale; dK += dS^T Q
    sum3(dp, dpl);
#pragma unroll
    for (int e = 0; e < T / 2; ++e) {
      dp[e] = s[e] * (dp[e] - rd[2 * (e / 4) + e % 2]) * scale;
    }
    uint32_t dh[T / 2], dl[T / 2];
    split_p_tf32(dp, dh, dl);
    sm90::wgmma_fence();
    issue_acc<DN, T>(dk, dh, dl, base + L::kXt, L::kLo);
    sm90::wgmma_wait<0>();
    sm90::fence_regs(ph);
    sm90::fence_regs(pl);
    sm90::fence_regs(dh);
    sm90::fence_regs(dl);
    sm90::fence_regs(dv);
    sm90::fence_regs(dk);
    if (i + 1 < n) bar_arrive<TB_THREADS>(kBarTEmpty);   // transposed read
    // no wgmma in flight here: the accumulators may leave
    if ((i + 1) % kFlushTiles == 0 && i + 1 < n) {
      store_acc<DN>(dk_out + qbase, qrs, dk, row0, col0, S, D, vec,
                    i + 1 > kFlushTiles);
      store_acc<DN>(dv_out + qbase, qrs, dv, row0, col0, S, D, vec,
                    i + 1 > kFlushTiles);
    }
  }
  store_acc<DN>(dk_out + qbase, qrs, dk, row0, col0, S, D, vec,
                n > kFlushTiles);
  store_acc<DN>(dv_out + qbase, qrs, dv, row0, col0, S, D, vec,
                n > kFlushTiles);
}

// dQ of 64 query rows of one (batch, head): the fixed tiles are Q and dO
// of rows q0.., the stream K (stacked and transposed) and V (stacked) of
// the kv tiles that meet them, from the first inside the window of the
// block's first query to the last below the diagonal of its last.
// Consumer thread t holds S, dP and dQ in wgmma's layout: element 4 j + 2
// h + i at query row 16 (t / 32) + (t % 32) / 4 + 8 h, column 8 j + 2 (t
// % 4) + i (a key of the tile, a d).
template <int NCH, int T>
__global__ void __launch_bounds__(TB_THREADS, 1)
    flash_bwd_dq_tf32_kernel(const float* __restrict__ q,
                             const float* __restrict__ k,
                             const float* __restrict__ v,
                             const float* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             float* __restrict__ dq, int S, int H, int Hkv,
                             int D, float scale, int causal, int window,
                             int vec) {
  using L = TbSmem<NCH, 1, T>;
  constexpr int DN = 32 * NCH;
  extern __shared__ uint8_t smem_tb[];
  uint8_t* sm = smem_tb + ((1024 - (sm90::smem_addr(smem_tb) & 1023)) & 1023);
  const int b = blockIdx.x / H, h = blockIdx.x % H, hk = h / (H / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * TB_M;     // longest first
  const int n_k = (S + T - 1) / T;
  const int j0 = window ? max(0, q0 - window + 1) / T : 0;
  const int j_hi = causal ? min(n_k, (q0 + TB_M - 1) / T + 1) : n_k;
  const int n = j_hi - j0;
  const int64_t qrs = static_cast<int64_t>(H) * D;
  const int64_t krs = static_cast<int64_t>(Hkv) * D;
  const int64_t qbase = (static_cast<int64_t>(b) * S * H + h) * D;
  const int64_t kbase = (static_cast<int64_t>(b) * S * Hkv + hk) * D;

  if (threadIdx.x >= 128) {
    produce<NCH, T, false>(sm, q + qbase, dout + qbase, qrs, q0, k + kbase,
                           v + kbase, krs, j0, n, nullptr, nullptr, S, D,
                           vec, threadIdx.x - 128);
    return;
  }
  const int tid = threadIdx.x, lane = tid % 32;
  const int row0 = q0 + 16 * (tid / 32) + lane / 4;   // query rows row0, + 8
  const int col0 = 2 * (lane % 4);
  const float scale_log2 = scale * kLog2eTf;
  // this thread's two rows' lse log2(e) and delta
  const int64_t rbase = (static_cast<int64_t>(b) * H + h) * S;
  float rl[2], rd[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = row0 + 8 * hh;
    rl[hh] = r < S ? lse[rbase + r] * kLog2eTf : 0.f;
    rd[hh] = r < S ? delta[rbase + r] : 0.f;
  }
  float acc[DN / 2];
#pragma unroll
  for (int e = 0; e < DN / 2; ++e) acc[e] = 0.f;
  bar_sync<TB_THREADS>(kBarFixed);
  for (int j = 0; j < n; ++j) {
    const int k0 = (j0 + j) * T;
    const uint32_t base = opaque(sm90::smem_addr(sm));
    float s[T], dp[T], sl[T / 2], dpl[T / 2];
#pragma unroll
    for (int e = 0; e < T; ++e) s[e] = dp[e] = 0.f;
#pragma unroll
    for (int e = 0; e < T / 2; ++e) sl[e] = dpl[e] = 0.f;
    bar_sync<TB_THREADS>(kBarSFull);
    // S = Q K^T and dP = dO V^T, two groups in flight
    sm90::wgmma_fence();
    issue_st<NCH, T>(s, sl, base, base + L::kFixed, base + L::kX);
    issue_st<NCH, T>(dp, dpl, base + 2 * L::kFixed, base + 3 * L::kFixed,
                     base + L::kY);
    sm90::wgmma_wait<1>();
    sm90::fence_regs(s);
    sm90::fence_regs(sl);
    sum3(s, sl);
    const bool edge = edge_tile(q0, TB_M, k0, T, S, causal, window);
#pragma unroll
    for (int e = 0; e < T / 2; ++e) {
      const int hh = (e / 2) % 2;
      const float p = fast_exp2(s[e] * scale_log2 - rl[hh]);
      s[e] = (!edge || keeps(row0 + 8 * hh, k0 + acc_col(e, col0), S, causal,
                             window))
                 ? p
                 : 0.f;
    }
    sm90::wgmma_wait<0>();
    sm90::fence_regs(dp);
    sm90::fence_regs(dpl);
    if (j + 1 < n) bar_arrive<TB_THREADS>(kBarSEmpty);   // stacked read
    // dS = P (dP - delta) scale; dQ += dS K
    sum3(dp, dpl);
#pragma unroll
    for (int e = 0; e < T / 2; ++e) {
      dp[e] = s[e] * (dp[e] - rd[(e / 2) % 2]) * scale;
    }
    uint32_t dh[T / 2], dl[T / 2];
    split_p_tf32(dp, dh, dl);
    bar_sync<TB_THREADS>(kBarTFull);
    sm90::wgmma_fence();
    issue_acc<DN, T>(acc, dh, dl, base + L::kXt, L::kLo);
    sm90::wgmma_wait<0>();
    sm90::fence_regs(dh);
    sm90::fence_regs(dl);
    sm90::fence_regs(acc);
    if (j + 1 < n) bar_arrive<TB_THREADS>(kBarTEmpty);   // transposed read
  }
  store_acc<DN>(dq + qbase, qrs, acc, row0, col0, S, D, vec, false);
}

namespace {

using sm90::aligned16;
using sm90::allow_smem;

// 16-byte loads where D fills whole 16-byte chunks and every row is aligned
int tf32_vec(int D, const void* a, const void* b, const void* c,
             const void* d) {
  return D % 4 == 0 && aligned16(a) && aligned16(b) && aligned16(c) &&
         aligned16(d);
}

template <int NCH>
int launch_dkdv_tf32(const float* q, const float* k, const float* v,
                     const float* dout, const float* lse, const float* delta,
                     float* dk_out, float* dv_out, int B, int S, int H,
                     int Hkv, int D, float scale, int causal, int window,
                     int vec, cudaStream_t st) {
  // 32-row query tiles where they fit beside the fixed tiles (D <= 64)
  constexpr int T = NCH == 4 ? 16 : 32;
  auto kernel = flash_bwd_dkdv_tf32_kernel<NCH, T>;
  constexpr int smem = TbSmem<NCH, 2, T>::kBytes;
  static bool configured = false;
  const cudaError_t err = allow_smem(kernel, smem, configured);
  if (err != cudaSuccess) return static_cast<int>(err);
  static_assert(smem <= 232448, "one block's shared memory on Hopper");
  const dim3 grid(B * H, (S + TB_M - 1) / TB_M);
  kernel<<<grid, TB_THREADS, smem, st>>>(q, k, v, dout, lse, delta, dk_out,
                                         dv_out, S, H, Hkv, D, scale,
                                         causal, window, vec);
  return static_cast<int>(cudaGetLastError());
}

template <int NCH>
int launch_dq_tf32(const float* q, const float* k, const float* v,
                   const float* dout, const float* lse, const float* delta,
                   float* dq, int B, int S, int H, int Hkv, int D,
                   float scale, int causal, int window, int vec,
                   cudaStream_t st) {
  auto kernel = flash_bwd_dq_tf32_kernel<NCH, 32>;
  constexpr int smem = TbSmem<NCH, 1, 32>::kBytes;
  static_assert(smem <= 232448, "one block's shared memory on Hopper");
  static bool configured = false;
  const cudaError_t err = allow_smem(kernel, smem, configured);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, (S + TB_M - 1) / TB_M);
  kernel<<<grid, TB_THREADS, smem, st>>>(q, k, v, dout, lse, delta, dq, S,
                                         H, Hkv, D, scale, causal, window,
                                         vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dk, dv (B, S, Hkv, D) float32 from q, dout (B, S, H, D), k, v (B, S,
// Hkv, D) float32, the forward's lse (B, H, S) and delta (B, H, S)
// (repro_flash_bwd_delta); D <= 128, H % Hkv == 0; window > 0: query i
// sees keys j > i - window only.  With Hkv < H, part (2, B, S, H, D)
// float32 takes each query head's dK and dV, which repro_flash_bwd_reduce
// sums into dk and dv
extern "C" int repro_flash_bwd_dkdv_tf32(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, void* part,
    int32_t B, int32_t S, int32_t H, int32_t Hkv, int32_t D, float scale,
    int32_t causal, int32_t window, void* stream) {
  if (D < 1 || D > 128 || Hkv < 1 || H % Hkv ||
      (Hkv != H && part == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* df = static_cast<const float*>(dout);
  const float* ls = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  float* dko = static_cast<float*>(Hkv != H ? part : dk);
  float* dvo = Hkv != H ? dko + static_cast<int64_t>(B) * S * H * D
                        : static_cast<float*>(dv);
  const int vec = tf32_vec(D, q, k, v, dout);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return D <= 64
             ? launch_dkdv_tf32<2>(qf, kf, vf, df, ls, dl, dko, dvo, B, S, H,
                                   Hkv, D, scale, causal, window, vec, st)
             : launch_dkdv_tf32<4>(qf, kf, vf, df, ls, dl, dko, dvo, B, S, H,
                                   Hkv, D, scale, causal, window, vec, st);
}

// dq (B, S, H, D) float32, the same inputs as repro_flash_bwd_dkdv_tf32
extern "C" int repro_flash_bwd_dq_tf32(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* delta,
                                       void* dq, int32_t B, int32_t S,
                                       int32_t H, int32_t Hkv, int32_t D,
                                       float scale, int32_t causal,
                                       int32_t window, void* stream) {
  if (D < 1 || D > 128 || Hkv < 1 || H % Hkv) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* df = static_cast<const float*>(dout);
  const float* ls = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  const int vec = tf32_vec(D, q, k, v, dout);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return D <= 64 ? launch_dq_tf32<2>(qf, kf, vf, df, ls, dl,
                                     static_cast<float*>(dq), B, S, H, Hkv, D,
                                     scale, causal, window, vec, st)
                 : launch_dq_tf32<4>(qf, kf, vf, df, ls, dl,
                                     static_cast<float*>(dq), B, S, H, Hkv, D,
                                     scale, causal, window, vec, st);
}
