// Tensor-core tile code for 8-bit integer products on Hopper (sm_90a),
// shared by the MAC-array kernels mac_gemm.cu and mac_conv.cu: the
// operand pack (B transposed to K-major, A padded, a split-K output
// zeroed) in one launch, K-major operand tiles staged with 16-byte
// cp.async into the 128-byte swizzled layout of sm90.cuh, the warpgroup
// product wgmma.mma_async m64nNk32 (N = 64, 128 or 256) with an s32
// accumulator in its four s8/u8 signedness pairings, and the epilogue
// that stores (or atomically adds) the accumulator fragment.  No
// .satfinite: the int32 sums wrap, as the reference's int32 accumulation
// does.
#pragma once
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "sm90.cuh"

namespace imma {

constexpr int kTileK = 128;        // k bytes of one staged tile row
constexpr int kStepK = 32;         // k of one wgmma
constexpr int kPackTile = 64;      // pack kernel's tile (k x n bytes)
constexpr int kPackThreads = 256;

// Stage rows [r0, r0 + ROWS) and k bytes [k0, k0 + 128) of a row-major
// 8-bit matrix (row stride ld bytes) into the swizzled tile at shared
// address dst, with THREADS threads (thread tid), one 16-byte cp.async
// per chunk.  Rows at or past n_rows and k at or past n_k are zero-filled.
// ld, n_k and the base address are multiples of 16.
template <int ROWS, int THREADS>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const uint8_t* __restrict__ src,
                                          int64_t ld, int r0, int n_rows,
                                          int k0, int n_k, int tid) {
  static_assert(ROWS * 8 % THREADS == 0, "whole chunks per thread");
#pragma unroll
  for (int x = 0; x < ROWS * 8 / THREADS; ++x) {
    const int e = tid + x * THREADS, r = e >> 3, c = e & 7;
    const int row = r0 + r, k = k0 + c * 16;
    const bool in = row < n_rows && k < n_k;
    sm90::cp_async16(dst + sm90::sw128(r, c),
                     in ? src + static_cast<int64_t>(row) * ld + k : src,
                     in ? 16 : 0);
  }
}

#define IMMA_M64N64K32(TYPES)                                                \
  asm volatile(                                                              \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                           \
      "wgmma.mma_async.sync.aligned.m64n64k32.s32." TYPES " {"               \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "                   \
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "         \
      "%24, %25, %26, %27, %28, %29, %30, %31"                               \
      "}, %32, %33, p;\n}\n"                                                 \
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),          \
      "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),            \
      "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),       \
      "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),       \
      "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),       \
      "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),       \
      "+r"(d[30]), "+r"(d[31])                                               \
      : "l"(da), "l"(db), "r"(scale_d))

#define IMMA_M64N128K32(TYPES)                                               \
  asm volatile(                                                              \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                           \
      "wgmma.mma_async.sync.aligned.m64n128k32.s32." TYPES " {"              \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "                   \
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "         \
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "         \
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "         \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "         \
      "%60, %61, %62, %63"                                                   \
      "}, %64, %65, p;\n}\n"                                                 \
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),          \
      "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),            \
      "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),       \
      "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),       \
      "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),       \
      "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),       \
      "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),       \
      "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),       \
      "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),       \
      "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),       \
      "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),       \
      "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),       \
      "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])                     \
      : "l"(da), "l"(db), "r"(scale_d))

#define IMMA_M64N256K32(TYPES)                                               \
  asm volatile(                                                              \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"                          \
      "wgmma.mma_async.sync.aligned.m64n256k32.s32." TYPES " {"              \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "                   \
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "         \
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "         \
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "         \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "         \
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "         \
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "         \
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "         \
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, " \
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, "          \
      "%118, %119, "                                                         \
      "%120, %121, %122, %123, %124, %125, %126, %127"                       \
      "}, %128, %129, p;\n}\n"                                               \
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),          \
      "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),            \
      "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),       \
      "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),       \
      "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),       \
      "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),       \
      "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),       \
      "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),       \
      "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),       \
      "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),       \
      "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),       \
      "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),       \
      "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]),       \
      "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]),       \
      "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]), "+r"(d[74]),       \
      "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),       \
      "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]),       \
      "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),       \
      "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]),       \
      "+r"(d[95]), "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),       \
      "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]), "+r"(d[104]),  \
      "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]),  \
      "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]), "+r"(d[114]),  \
      "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),  \
      "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]),  \
      "+r"(d[125]), "+r"(d[126]), "+r"(d[127])                               \
      : "l"(da), "l"(db), "r"(scale_d))


// d (64 x N, s32) (scale_d ? += : =) A (64 x 32, K-major tile at
// descriptor da) * B (32 x N, K-major: N rows of k at descriptor db); AS /
// BS: the operands are s8 (true) or u8 (false)
#define IMMA_PAIRINGS(MMA)        \
  if constexpr (AS && BS) {       \
    MMA("s8.s8");                 \
  } else if constexpr (AS) {      \
    MMA("s8.u8");                 \
  } else if constexpr (BS) {      \
    MMA("u8.s8");                 \
  } else {                        \
    MMA("u8.u8");                 \
  }
template <bool AS, bool BS, int N>
__device__ __forceinline__ void mma_k32(int32_t (&d)[N / 2], uint64_t da,
                                        uint64_t db, int scale_d) {
  static_assert(N == 64 || N == 128 || N == 256, "N is 64, 128 or 256");
  if constexpr (N == 64) {
    IMMA_PAIRINGS(IMMA_M64N64K32)
  } else if constexpr (N == 128) {
    IMMA_PAIRINGS(IMMA_M64N128K32)
  } else {
    IMMA_PAIRINGS(IMMA_M64N256K32)
  }
}
#undef IMMA_PAIRINGS
#undef IMMA_M64N64K32
#undef IMMA_M64N128K32
#undef IMMA_M64N256K32

// d (+)= the product of one staged k tile (128 bytes): A rows at shared
// address a (64 rows of the warpgroup), B rows at b (N rows); scale_d = 0
// overwrites d with the tile's first k step
template <bool AS, bool BS, int N>
__device__ __forceinline__ void mma_tile(int32_t (&d)[N / 2], uint32_t a,
                                         uint32_t b, int scale_d = 1) {
#pragma unroll
  for (int s = 0; s < kTileK / kStepK; ++s) {
    mma_k32<AS, BS, N>(d, sm90::desc_sw128(a + s * kStepK, 16, 1024),
                       sm90::desc_sw128(b + s * kStepK, 16, 1024),
                       s > 0 ? 1 : scale_d);
  }
}

// Write one warpgroup's m64nN accumulator to out (row-major, n_cols
// columns): thread t (0-127) of the warpgroup holds d[4 j + 2 h + i] at
// row row0 + 16 (t / 32) + (t % 32) / 4 + 8 h, column col0 + 8 j +
// 2 (t % 4) + i.  Stores, or with add (split K) int32 atomicAdd, which
// wraps modulo 2^32 in any order; out-of-range elements are skipped.
template <int N>
__device__ __forceinline__ void store_m64n(const int32_t (&d)[N / 2],
                                           int32_t* __restrict__ out,
                                           int M, int n_cols, int row0,
                                           int col0, int t, bool add) {
  const int r = row0 + 16 * (t / 32) + (t % 32) / 4;
  const int c = col0 + 2 * (t % 4);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (r + 8 * h >= M) continue;
    int32_t* row = out + static_cast<int64_t>(r + 8 * h) * n_cols;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int col = c + 8 * j + i;
        if (col >= n_cols) continue;
        if (add) {
          atomicAdd(row + col, d[4 * j + 2 * h + i]);
        } else {
          row[col] = d[4 * j + 2 * h + i];
        }
      }
    }
  }
}

// 4 x 4 bytes: w[i] holds row i's bytes (columns 0-3); returns in w[j]
// column j's bytes (rows 0-3)
__device__ __forceinline__ void transpose4x4(uint32_t (&w)[4]) {
  const uint32_t t0 = __byte_perm(w[0], w[1], 0x5140);
  const uint32_t t1 = __byte_perm(w[2], w[3], 0x5140);
  const uint32_t t2 = __byte_perm(w[0], w[1], 0x7362);
  const uint32_t t3 = __byte_perm(w[2], w[3], 0x7362);
  w[0] = __byte_perm(t0, t1, 0x5410);
  w[1] = __byte_perm(t0, t1, 0x7632);
  w[2] = __byte_perm(t2, t3, 0x5410);
  w[3] = __byte_perm(t2, t3, 0x7632);
}

namespace {

// The operand pack of both MAC kernels.  Blocks [0, bt_blocks): B tiles
// of 64 k x 64 n, transposed into bt: with words (N % 4 == 0, b 4-byte
// aligned) each thread moves a 4 x 4 byte square by four 32-bit loads,
// __byte_perm and four 32-bit stores, else bytes through shared memory.
// Then ap_blocks blocks copy A into ap, then zero_blocks blocks zero out,
// each a grid-stride loop.
__global__ void __launch_bounds__(kPackThreads)
    imma_pack_kernel(const uint8_t* __restrict__ a,
                     const uint8_t* __restrict__ b, uint8_t* __restrict__ ap,
                     uint8_t* __restrict__ bt, int32_t* __restrict__ out,
                     int M, int N, int K, int Kp, int bt_cols, int bt_blocks,
                     int ap_blocks, int zero_blocks, int words) {
  constexpr int PT = kPackTile;
  __shared__ uint8_t tile[PT][PT + 4];   // +4: no bank conflicts
  int blk = blockIdx.x;
  const int tid = threadIdx.x;
  if (blk < bt_blocks) {
    const int n0 = (blk % bt_cols) * PT, k0 = (blk / bt_cols) * PT;
    if (words) {
      // consecutive threads take consecutive k quads: coalesced stores
      const int k = k0 + 4 * (tid % 16), n = n0 + 4 * (tid / 16);
      if (n >= N || k >= Kp) return;
      uint32_t w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        w[i] = k + i < K ? *reinterpret_cast<const uint32_t*>(
                               b + static_cast<int64_t>(k + i) * N + n)
                         : 0u;
      }
      transpose4x4(w);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (n + j < N) {
          *reinterpret_cast<uint32_t*>(
              bt + static_cast<int64_t>(n + j) * Kp + k) = w[j];
        }
      }
      return;
    }
#pragma unroll 4
    for (int e = tid; e < PT * PT; e += kPackThreads) {
      const int k = k0 + e / PT, n = n0 + e % PT;
      tile[e / PT][e % PT] =
          (k < K && n < N) ? b[static_cast<int64_t>(k) * N + n] : 0;
    }
    __syncthreads();
#pragma unroll 4
    for (int e = tid; e < PT * PT; e += kPackThreads) {
      const int n = n0 + e / PT, k = k0 + e % PT;
      if (n < N && k < Kp) {
        bt[static_cast<int64_t>(n) * Kp + k] = tile[e % PT][e / PT];
      }
    }
    return;
  }
  blk -= bt_blocks;
  if (blk < ap_blocks) {
    const int64_t total = static_cast<int64_t>(M) * Kp;
    for (int64_t e = static_cast<int64_t>(blk) * kPackThreads + tid;
         e < total; e += static_cast<int64_t>(ap_blocks) * kPackThreads) {
      const int64_t m = e / Kp;
      const int k = static_cast<int>(e - m * Kp);
      ap[e] = k < K ? a[m * K + k] : 0;
    }
    return;
  }
  blk -= ap_blocks;
  const int64_t total = static_cast<int64_t>(M) * N;
  for (int64_t e = static_cast<int64_t>(blk) * kPackThreads + tid;
       e < total; e += static_cast<int64_t>(zero_blocks) * kPackThreads) {
    out[e] = 0;
  }
}

// One launch of the pack: b (K, N) row-major 8-bit -> bt (N, Kp), Kp = K
// rounded up to 16, zero-filled; with ap, a (M, K) -> ap (M, Kp); with
// zero_out, out (M, N) int32 set to 0 (split K adds into it).  Returns
// the launch's cudaError_t.
inline int pack(const uint8_t* a, const uint8_t* b, uint8_t* ap,
                uint8_t* bt, int32_t* out, int M, int N, int K, int Kp,
                bool zero_out, cudaStream_t s) {
  const int bt_cols = (N + kPackTile - 1) / kPackTile;
  const int bt_blocks = bt_cols * ((Kp + kPackTile - 1) / kPackTile);
  const int ap_blocks =
      ap ? static_cast<int>(std::min<int64_t>(
               (static_cast<int64_t>(M) * Kp + 1023) / 1024, 2048))
         : 0;
  const int zero_blocks =
      zero_out ? static_cast<int>(std::min<int64_t>(
                     (static_cast<int64_t>(M) * N + 1023) / 1024, 2048))
               : 0;
  if (bt_blocks + ap_blocks + zero_blocks == 0) return 0;
  imma_pack_kernel<<<bt_blocks + ap_blocks + zero_blocks, kPackThreads, 0,
                     s>>>(
      a, b, ap, bt, out, M, N, K, Kp, bt_cols, bt_blocks, ap_blocks,
      zero_blocks,
      N % 4 == 0 && (reinterpret_cast<uintptr_t>(b) & 3) == 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Split K while the output tiles leave SMs idle, one K tile at least:
// (blocks along K, K tiles per block) for k_tiles K tiles and `tiles`
// output tiles on sms SMs
inline void split_k(int k_tiles, int tiles, int sms, int* split, int* kps) {
  *split = 1;
  if (k_tiles > 1 && tiles < sms) {
    *split = std::min(k_tiles, std::max(1, sms / tiles));
  }
  *kps = k_tiles ? (k_tiles + *split - 1) / *split : 0;
  if (k_tiles) *split = (k_tiles + *kps - 1) / *kps;
}

inline int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

}  // namespace imma
