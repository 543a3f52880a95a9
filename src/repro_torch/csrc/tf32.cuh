// 3xTF32 building blocks shared by the float32 flash-attention kernels
// (flash_attn.cu's forward, flash_attn_bwd_tf32.cu's backward): TF32
// keeps 10 of float32's 23 mantissa bits, so each operand x is split into
// x_hi = tf32(x) and x_lo = tf32(x - x_hi) and each product is taken as
// a_hi b_hi + a_hi b_lo + a_lo b_hi with float32 sums.  Here: the split,
// 16-byte row loads that zero-fill past S and D, a producer's staging of
// rows into split, 128-byte-swizzled tiles, the TF32 wgmma products (A
// from shared memory or registers, B K-major in shared memory: TF32 wgmma
// has no transpose bit), and the split of an accumulator into the register
// A operand of the next product.
#pragma once
#include <cuda_runtime.h>

#include <cstdint>

#include "sm90.cuh"

namespace tf32 {

// x = hi + lo to about 2^-22 relative: hi = x rounded to TF32 (nearest,
// ties away), lo = the exact rest x - hi rounded to TF32.  The rounding
// is cvt.rna.tf32.f32's, done on the bit pattern: half of the 13 dropped
// mantissa bits' range added to the magnitude, then those bits cleared
// (two integer operations, which cost less than the cvt; Inf and NaN
// stay Inf and NaN)
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}
__device__ __forceinline__ void split4(const float4& v, uint4& hi,
                                      uint4& lo) {
  split_tf32(v.x, hi.x, lo.x);
  split_tf32(v.y, hi.y, lo.y);
  split_tf32(v.z, hi.z, lo.z);
  split_tf32(v.w, hi.w, lo.w);
}

// floats [c, c + 4) of a row (zeros past D, or all zeros when !in); vec:
// D % 4 == 0 and 16-byte aligned rows, one 16-byte load
__device__ __forceinline__ float4 load4(const float* row, int c, int D,
                                        bool in, bool vec) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (!in || c >= D) return v;
  if (vec) return __ldg(reinterpret_cast<const float4*>(row + c));
  v.x = __ldg(row + c);
  if (c + 1 < D) v.y = __ldg(row + c + 1);
  if (c + 2 < D) v.z = __ldg(row + c + 2);
  if (c + 3 < D) v.w = __ldg(row + c + 3);
  return v;
}

// The producer stages a tile in two steps, so that the loads of the next
// tile are in flight while it waits for a free stage: load() issues this
// thread's 16-byte global loads of the tile into registers (zeros for
// rows >= S and columns >= D), store() splits them and writes hi and lo.

// Rows [r0, r0 + ROWS) of one (batch, head) into swizzled tiles of NCH
// column blocks of 128-byte rows, BLOCK_ROWS rows apart, by THREADS
// threads (pt).  Eight neighbouring threads take the eight 16-byte chunks
// of one row: coalesced loads, conflict-free stores.
template <int ROWS, int NCH, int BLOCK_ROWS, int THREADS>
struct RowTile {
  static constexpr int kPer = ROWS * 8 * NCH / THREADS;   // chunks a thread
  float4 v[kPer];

  __device__ __forceinline__ void load(const float* src, int64_t rs, int r0,
                                       int S, int D, int pt, bool vec) {
#pragma unroll
    for (int x = 0; x < kPer; ++x) {
      const int e = sm90::opaque(pt) + x * THREADS;
      const int r = e / (8 * NCH), c = e % (8 * NCH);
      v[x] = load4(src + static_cast<int64_t>(r0 + r) * rs, 4 * c, D,
                   r0 + r < S, vec);
    }
  }
  __device__ __forceinline__ void store(uint8_t* hi, uint8_t* lo,
                                        int pt) const {
#pragma unroll
    for (int x = 0; x < kPer; ++x) {
      const int e = sm90::opaque(pt) + x * THREADS;
      const int r = e / (8 * NCH), c = e % (8 * NCH);
      const uint32_t off =
          (c / 8) * BLOCK_ROWS * 128 + sm90::sw128(r, c % 8);
      uint4 h, l;
      split4(v[x], h, l);
      *reinterpret_cast<uint4*>(hi + off) = h;
      *reinterpret_cast<uint4*>(lo + off) = l;
    }
  }
};

#define TF32_SS_M64N64K8                                                     \
  asm volatile(                                                              \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                           \
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"                \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "                   \
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "         \
      "%24, %25, %26, %27, %28, %29, %30, %31"                               \
      "}, %32, %33, p, 1, 1;\n}\n"                                           \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),          \
      "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),            \
      "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),       \
      "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),       \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),       \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),       \
      "+f"(d[30]), "+f"(d[31])                                               \
      : "l"(da), "l"(db), "r"(scale_d))

#define TF32_SS_M64N32K8                                                     \
  asm volatile(                                                              \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"                           \
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"                \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "                   \
      "%12, %13, %14, %15"                                                   \
      "}, %16, %17, p, 1, 1;\n}\n"                                           \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),          \
      "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),            \
      "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),       \
      "+f"(d[15])                                                            \
      : "l"(da), "l"(db), "r"(scale_d))

#define TF32_SS_M64N16K8                                                     \
  asm volatile(                                                              \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"                           \
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"                \
      "%0, %1, %2, %3, %4, %5, %6, %7"                                       \
      "}, %8, %9, p, 1, 1;\n}\n"                                             \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),          \
      "+f"(d[5]), "+f"(d[6]), "+f"(d[7])                                     \
      : "l"(da), "l"(db), "r"(scale_d))

#define TF32_RS_M64N64K8                                                     \
  asm volatile(                                                              \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                           \
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"                \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "                   \
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "         \
      "%24, %25, %26, %27, %28, %29, %30, %31"                               \
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"                          \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),          \
      "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),            \
      "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),       \
      "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),       \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),       \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),       \
      "+f"(d[30]), "+f"(d[31])                                               \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))

#define TF32_RS_M64N128K8                                                    \
  asm volatile(                                                              \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                           \
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"               \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "                   \
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "         \
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "         \
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "         \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "         \
      "%60, %61, %62, %63"                                                   \
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"                          \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),          \
      "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),            \
      "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),       \
      "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),       \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),       \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),       \
      "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),       \
      "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),       \
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),       \
      "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),       \
      "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),       \
      "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),       \
      "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])                     \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))

#define TF32_RS_M64N256K8                                                        \
  asm volatile(                                                              \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"                          \
      "wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32 {"               \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "                   \
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "         \
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "         \
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "         \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "         \
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "         \
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "         \
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "         \
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, " \
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "\
      "%120, %121, %122, %123, %124, %125, %126, %127"                       \
      "}, {%128, %129, %130, %131}, %132, p, 1, 1;\n}\n"                     \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),          \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),          \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),     \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),     \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),     \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),     \
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),     \
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),     \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),     \
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),     \
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),     \
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),     \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),     \
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),     \
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),     \
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),     \
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),     \
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),     \
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),     \
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),     \
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),\
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),\
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),\
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),\
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),\
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])                             \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d))


// d (64 x 64) (scale_d ? += : =) A (64 x 8, K-major tile at descriptor
// da) * B (8 x 64, K-major: 64 rows of k at db), TF32 in, float32 sums
__device__ __forceinline__ void tf32_ss_m64n64k8(float (&d)[32], uint64_t da,
                                                 uint64_t db, int scale_d) {
  TF32_SS_M64N64K8;
}
// d (64 x 16) (scale_d ? += : =) A (64 x 8 at da) * B (8 x 16, K-major:
// 16 rows of k at db), TF32 in, float32 sums
__device__ __forceinline__ void tf32_ss_m64n16k8(float (&d)[8], uint64_t da,
                                                 uint64_t db, int scale_d) {
  TF32_SS_M64N16K8;
}
// d (64 x 32) (scale_d ? += : =) A (64 x 8 at da) * B (8 x 32, K-major:
// 32 rows of k at db), TF32 in, float32 sums
__device__ __forceinline__ void tf32_ss_m64n32k8(float (&d)[16], uint64_t da,
                                                 uint64_t db, int scale_d) {
  TF32_SS_M64N32K8;
}
// d (64 x N) += A (64 x 8, registers a[0-3]) * B (8 x N, K-major at db)
template <int N>
__device__ __forceinline__ void tf32_rs_k8(float (&d)[N / 2],
                                           const uint32_t* a, uint64_t db) {
  if constexpr (N == 64) {
    TF32_RS_M64N64K8;
  } else if constexpr (N == 128) {
    TF32_RS_M64N128K8;
  } else {
    static_assert(N == 256, "N is 64, 128 or 256");
    const int scale_d = 1;
    TF32_RS_M64N256K8;
  }
}
#undef TF32_SS_M64N64K8
#undef TF32_SS_M64N32K8
#undef TF32_SS_M64N16K8
#undef TF32_RS_M64N64K8
#undef TF32_RS_M64N128K8
#undef TF32_RS_M64N256K8

// an accumulator's first NA / 2 columns (sc[0 .. NA - 1], NA / 4 blocks
// of 8 columns) split into TF32's register A operand of the next product:
// A column q <- accumulator column 2 q, A column q + 4 <- 2 q + 1 of each
// 8-column block (the B operand's k rows are permuted to match)
template <int NA>
__device__ __forceinline__ void split_p_tf32(const float* sc,
                                             uint32_t (&ph)[NA],
                                             uint32_t (&pl)[NA]) {
#pragma unroll
  for (int jb = 0; jb < NA / 4; ++jb) {
    split_tf32(sc[4 * jb], ph[4 * jb], pl[4 * jb]);
    split_tf32(sc[4 * jb + 2], ph[4 * jb + 1], pl[4 * jb + 1]);
    split_tf32(sc[4 * jb + 1], ph[4 * jb + 2], pl[4 * jb + 2]);
    split_tf32(sc[4 * jb + 3], ph[4 * jb + 3], pl[4 * jb + 3]);
  }
}

}  // namespace tf32
