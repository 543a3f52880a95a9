// Tensor-core tile code for 8-bit integer products on Hopper (sm_90a),
// shared by the MAC-array kernels (mac_gemm.cu now; mac_conv.cu can take
// it up): K-major operand tiles staged with 16-byte cp.async into the
// 128-byte swizzled layout of sm90.cuh, the warpgroup product
// wgmma.mma_async m64n256k32 with an s32 accumulator in its four s8/u8
// signedness pairings, and the epilogue that stores (or atomically adds)
// the accumulator fragment.  No .satfinite: the int32 sums wrap, as the
// reference's int32 accumulation does.
#pragma once
#include <cstdint>

#include "sm90.cuh"

namespace imma {

constexpr int kTileK = 128;        // k bytes of one staged tile row
constexpr int kStepK = 32;         // k of one wgmma

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

#define IMMA_M64N256K32(TYPES)                                               \
  asm volatile(                                                              \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"                          \
      "wgmma.mma_async.sync.aligned.m64n256k32.s32." TYPES " "               \
      "{"                                                                    \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "                   \
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "         \
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "         \
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "         \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "         \
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "         \
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "         \
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "         \
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, " \
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, "         \
      "%118, %119, %120, %121, %122, %123, %124, %125, %126, %127"           \
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
      : "l"(da), "l"(db), "r"(1))

// d (64 x 256, s32) += A (64 x 32, K-major tile at descriptor da) *
// B (32 x 256, K-major: 256 rows of k at descriptor db); AS / BS: the
// operands are s8 (true) or u8 (false)
template <bool AS, bool BS>
__device__ __forceinline__ void mma_m64n256k32(int32_t (&d)[128], uint64_t da,
                                               uint64_t db) {
  if constexpr (AS && BS) {
    IMMA_M64N256K32("s8.s8");
  } else if constexpr (AS) {
    IMMA_M64N256K32("s8.u8");
  } else if constexpr (BS) {
    IMMA_M64N256K32("u8.s8");
  } else {
    IMMA_M64N256K32("u8.u8");
  }
}
#undef IMMA_M64N256K32

// d += the product of one staged k tile (128 bytes): A rows at shared
// address a (64 rows of the warpgroup), B rows at b (256 rows)
template <bool AS, bool BS>
__device__ __forceinline__ void mma_tile(int32_t (&d)[128], uint32_t a,
                                         uint32_t b) {
#pragma unroll
  for (int s = 0; s < kTileK / kStepK; ++s) {
    mma_m64n256k32<AS, BS>(d, sm90::desc_sw128(a + s * kStepK, 16, 1024),
                           sm90::desc_sw128(b + s * kStepK, 16, 1024));
  }
}

// Write one warpgroup's m64n256 accumulator to out (row-major, N
// columns): thread t (0-127) of the warpgroup holds d[4 j + 2 h + i] at
// row row0 + 16 (t / 32) + (t % 32) / 4 + 8 h, column col0 + 8 j +
// 2 (t % 4) + i.  Stores, or with add (split K) int32 atomicAdd, which
// wraps modulo 2^32 in any order; out-of-range elements are skipped.
__device__ __forceinline__ void store_m64n256(const int32_t (&d)[128],
                                              int32_t* __restrict__ out,
                                              int M, int N, int row0,
                                              int col0, int t, bool add) {
  const int r = row0 + 16 * (t / 32) + (t % 32) / 4;
  const int c = col0 + 2 * (t % 4);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (r + 8 * h >= M) continue;
    int32_t* row = out + static_cast<int64_t>(r + 8 * h) * N;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int col = c + 8 * j + i;
        if (col >= N) continue;
        if (add) {
          atomicAdd(row + col, d[4 * j + 2 * h + i]);
        } else {
          row[col] = d[4 * j + 2 * h + i];
        }
      }
    }
  }
}

}  // namespace imma
