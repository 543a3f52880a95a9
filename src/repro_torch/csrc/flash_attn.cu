// Fused softmax attention (flash attention) for Hopper (sm_90a): both
// dtypes on the tensor cores (bfloat16 wgmma, float32 as 3xTF32 wgmma),
// float32 softmax inside.
//
// Replaces the Pallas kernel repro/kernels/flash_attn/flash_attn.py::
// _flash_kernel (via flash_attention_pallas and flash_attn/ops.py::
// flash_attention_kernel).  That kernel walks a (B H, q block, kv block)
// grid whose kv axis runs in order on the TPU core, carrying the online
// softmax's m, l and acc in VMEM scratch from one grid step to the next.
// Blocks on the card run in parallel and carry nothing, so each block owns
// one (batch x head, query tile) and loops over the kv tiles itself, with
// m, l and acc in registers.  Every kernel keeps the reference's
// semantics: scores scaled by 1/sqrt(D), p = 0 under the causal mask,
// output acc / max(l, 1e-30) in the input type.  Under the causal mask
// the kv tiles wholly above the diagonal are skipped (there p is 0, m is
// unchanged and the correction is 1, so skipping is exact) and the
// heaviest query tiles are scheduled first.  A sliding window (``window``
// > 0, the band of the reference's model attention, layers.py::_mask: key
// j meets query i when i - window < j <= i) also starts each block's kv
// loop at the first tile that meets its first row's band, tile max(0, q0
// - window + 1) / TK, and masks the keys at or past ``window`` behind the
// row; m then starts at -1e30 rather than -inf, so that a row's tiles
// before its band leave it unchanged.  Rows and columns past S are
// zero-filled and masked, so any S works.  q and the output are read and
// written in the op's (B, S, H, D) layout, k and v in (B, S, H_kv, D) with
// H % H_kv == 0: query head h reads KV head h / (H / H_kv) in place, with
// the row stride H_kv D (the reference's model attention expands K and V
// to every query head with jnp.repeat first; reading the KV head in place
// computes the same function without the copy).  No transpose.
//
// The log-sum-exp.  Training's forward (flash_attn/ops.py, under grad)
// also stores each row's log-sum-exp of its scaled, masked scores, m +
// log(l) in natural-log units (m is kept in log2 units, so (m + log2 l)
// ln 2), as (B, H, S) float32, where each kernel finalises l; the
// backward (flash_attn_bwd.cu) recomputes P from it.  Serving passes no
// lse buffer: the D <= 128 kernels then skip the store on a branch, the D
// 256 kernels are instantiated without it.
//
// Bound: operations.  A causal prefill at S = 4096, 32 heads of 128 is
// 4 S^2 D H / 2 = 137 GFLOP, 139 us at the bf16 tensor-core rate, against
// 134 MB of bytes (40 us).  float32 at S = 1024 is 8.6 GFLOP: 128 us at
// the CUDA cores' float32 rate, 52 us for the three TF32 products of the
// split at the TF32 tensor-core rate.  RecurrentGemma's local prefill (4 x
// 4096, 10 heads of 256 over one KV head, window 2048: 6.29 M band pairs a
// head) is 258 GFLOP, 261 us in bf16 and 1.56 ms for three TF32 products.
//
// bfloat16, D <= 128 (flash_attn_wgmma_kernel).  A block is one warpgroup
// (128 threads) and one 64-row query tile, two blocks an SM, so one
// block's softmax runs beside the other's products; kv tiles are 64 rows.
// S = Q K^T is wgmma m64n64k16 with Q's operand in registers (loaded once
// from shared memory by ldmatrix) and K's tile ((kv, D) row-major, K-major
// for this product) in shared memory, into a float32 accumulator; D is
// zero-filled up to 64 or 128 (zero columns add nothing; the extra output
// columns are not stored).  The online softmax (exp2 of log2-scaled
// scores, one FFMA and one MUFU.EX2 a score, tree maxima and sums) turns
// the accumulator into p in registers, rounded to bf16, which is the A
// operand of O += P V (wgmma m64n64k16 with A in registers; V's tile is
// (kv, D) row-major, MN-major for this product, read with the transpose
// bit).  K and V tiles stream through a 3-stage ring in dynamic shared
// memory by 16-byte cp.async: tile j + 2 is copied as soon as
// P_{j-1} V_{j-1}, the last reader of its stage, retires.
// S_j = Q K_j^T is issued together with O += P_{j-1} V_{j-1}, and the
// softmax of S_j runs while the tensor cores finish P_{j-1} V_{j-1}.
// Numerics: each bf16 product is exact in the float32 accumulator, so
// Q K^T differs from the reference only in the order of its sums; p is
// rounded to bf16 before P V (the one new rounding; l sums the float32
// p); ex2.approx has a relative error of about 2^-22.  D % 8 != 0 or
// unaligned rows stage with plain loads instead of cp.async.
//
// bfloat16, 128 < D <= 256 (flash_attn_wgmma_d256_kernel: RecurrentGemma's
// local layers).  There a 64-row block of one warpgroup cannot hold Q's
// fragments beside O's 128 floats, so the block is warp-specialised: one
// producer warpgroup and two consumer warpgroups of 64 query rows each,
// which both read every K/V tile the producer lands.  With G = H / H_kv
// even, the consumers take the same 64 rows of two query heads that share
// a KV head (RecurrentGemma: 10 over 1, five pairs), so both walk the same
// tiles; with G odd, 128 rows of one head, both walking the block's tiles
// (a consumer's tiles wholly above its diagonal or behind its band are
// masked there: p = 0, correction 1, an exact no-op).  The producer gives
// its registers up (setmaxnreg 24) and keeps 64-row K tiles in a 3-stage
// ring and V tiles in a 2-stage one (32 KB a tile) in flight by TMA: one
// thread issues each tile as four boxes of 64 rows by 64 values (the
// 128-byte swizzle wgmma reads, zeros past S and D) against full / empty
// mbarriers, K and V each with their own, so that K_{j+2} is loaded as
// soon as both consumers' S_{j-1} has retired (two kv steps ahead; with
// one, the wait for K from L2 showed) and V_{j+1} once P_{j-1} V_{j-1}
// has; Q's two tiles come the same way.  The tensor maps are built at
// launch through the driver entry point that cudaGetDriverEntryPoint
// returns, so nothing links libcuda.
// The consumers (setmaxnreg 240: O's 128 floats, S's 32, two P's 16 each)
// run the D <= 128 kernel's loop, S_j = Q K_j^T (sixteen m64n64k16, Q as
// the shared-memory operand) issued with O += P_{j-1} V_{j-1} (four
// m64n256k16, P from registers, V read with the transpose bit), and they
// take turns to issue them (two named barriers): one consumer's softmax
// runs beside the other's products.  Shared memory: Q 2 x 32 KB, K 3 x 32
// KB and V 2 x 32 KB, 224 KB and the barriers: one block an SM.  D % 8
// != 0 or unaligned rows: the producer warpgroup stages with plain loads.
// ptxas serialises every wgmma of a kernel (a full wait after each) when
// an instruction inside a wgmma pipeline stage writes a register that a
// wgmma of the stage reads; three such writes are kept out here: each
// consumer is compiled for its index (its descriptors are the uniform
// base plus constants), descriptors are built from 32-bit addresses (no
// 64-bit add that rewrites a descriptor's registers in flight), and P
// alternates between two buffers over a loop unrolled by two (a copy
// from one to the other lets the next P land in the registers that
// P_{j-1} V_{j-1} still reads).
//
// float32, D <= 128 (flash_attn_tf32_kernel).  TF32 keeps 10 mantissa
// bits, too few for the float32 tolerance, so each operand x is split
// into x_hi = tf32(x) and x_lo = tf32(x - x_hi) (round to nearest), and
// each product takes the terms a_hi b_hi + a_hi b_lo + a_lo b_hi
// (wgmma m64nNk8 f32.tf32.tf32, float32 sums); the a_lo b_lo left out of
// P V is about 2^-22 relative.  The split operands double the shared
// memory (Q hi and lo are 64 KB for 64 rows at D = 128), and each block
// holds 128 query rows, one 32-row K tile and one V tile (193 KB), alone
// on its SM.  TF32
// wgmma has no transpose, and V is MN-major for P V, so V is stored
// transposed, which cp.async cannot do, and the split is arithmetic on
// each value anyway: a producer warpgroup loads K and V tiles with
// 16-byte loads into registers ahead of need, splits them and stores hi
// and lo (V transposed, its kv order permuted as below), handing the
// tiles to and from two consumer warpgroups through named barriers; K
// runs a tile ahead of V, so K_{j+1} is stored during the softmax of S_j
// and V_j while S_{j+1} runs.  Each consumer (64 query rows) runs the
// bf16 kernel's loop, and the two share the tensor cores, one's softmax
// beside the other's products: S_j = Q K_j^T issued together with O +=
// P_{j-1} V_{j-1}, the softmax of S_j while P_{j-1} V_{j-1} finishes,
// exp2 of log2-scaled scores, -inf masks on edge tiles only.  K hi and lo
// sit one above the other as one 64-row operand, so S_j is two 64-wide
// products a k step (Q_hi and Q_lo against [K_hi; K_lo], both in shared
// memory, K-major as they stand; the sum of the two 32-column halves
// takes all four terms) rather than three 32-wide ones.  O += P V is
// m64nDk8 (D zero-filled to 64 or 128) with P's hi and lo in registers.
// The score accumulator holds kv columns {2q, 2q + 1} of each 8-column
// block where TF32's register A operand wants {q, q + 4}: the kv rows of
// V^T are permuted the same way when they are staged, so P goes to the
// tensor cores without a shuffle.  Both consumers walk every kv tile of
// the block (tiles above the first one's causal diagonal are masked
// there, an exact no-op).  D % 4 != 0 or unaligned rows load element by
// element.
//
// float32, 128 < D <= 256 (flash_attn_tf32_d256_kernel: RecurrentGemma's
// local layers in float32).  Split in shared memory, Q alone would take
// 128 KB at 64 rows, so Q stays float32 there (64 rows padded to 260
// floats, 65 KB: the fragment loads are conflict-free) and is split into
// TF32's register A operand at each k step, 4 + 4 registers, two k steps
// a batch, the batches double-buffered so that one is split while the
// last runs.  A block is one consumer warpgroup of 64 query rows, whose
// O (64 x 256 float32) takes 128 registers a thread (a 256-thread block
// has 255 a thread, so no setmaxnreg is needed), and the D <= 128
// kernel's producer warpgroup: Q staged once, K_j split into [K_hi; K_lo]
// (32-row tiles, 64 KB), V_j^T split and permuted (64 KB), each a tile
// ahead of need, through named barriers.  S_j is Q_hi [K_hi; K_lo] + Q_lo
// [K_hi; K_lo], two m64n64k8 a k step (Q_lo K_lo, a fourth term below
// float32's rounding, costs less than a 32-wide product's own
// accumulator in registers), and O += P V three m64n256k8 a k step, once
// S_j has retired; p waits in float32 (16 registers) and is split for
// P V only then.  S is zeroed and every product accumulates: a first
// product that overwrites S (scale_d 0) leaves ptxas too few registers
// for the wgmma pipeline, and it serialises every wgmma.  Bound: the three
// TF32 products, 1.56 ms at RecurrentGemma's local prefill.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "sm90.cuh"
#include "tf32.cuh"

// ---------------------------------------------------------- bfloat16

namespace {

using bf16 = __nv_bfloat16;
// one warpgroup of 64 query rows a block, two blocks an SM
constexpr int TQ = 64, TK = 64, TC_THREADS = 128, KV_STAGES = 3;
constexpr float kNegInf = -__builtin_huge_valf();
constexpr float kLn2 = 0.6931471805599453f;
using sm90::bar_arrive;
using sm90::bar_sync;
using sm90::fast_exp2;
using sm90::opaque;
using sm90::pack_bf16;
using sm90::wgmma_rs_m64n64k16;
using sm90::wgmma_ss_m64n64k16;

// Shared memory of a block with NCH column blocks of 64 values (D <= 64
// NCH): the Q tile, then KV_STAGES pairs of K and V tiles, each stored as
// NCH swizzled blocks of (rows x 128 bytes) one after another
template <int NCH>
struct TcSmem {
  static constexpr int kQ = TQ * 128 * NCH;
  static constexpr int kKV = TK * 128 * NCH;
  static constexpr int kBytes = kQ + KV_STAGES * 2 * kKV + 1024;  // + align
};

// Stage rows [r0, r0 + ROWS) of one (batch, head) into a swizzled tile:
// with VEC (D % 8 == 0, 16-byte aligned rows) one cp.async per 8 values,
// else plain loads and stores; rows >= S and columns >= D are zeros.
template <int ROWS, int NCH, bool VEC>
__device__ __forceinline__ void stage_tc(uint8_t* tile, const bf16* src,
                                         int64_t row_stride, int r0, int S,
                                         int D, int tid) {
  if constexpr (VEC) {
    // thread tid copies 8-value chunk c of rows r, r + RS, ...: one row
    // address a thread and tile, then steps of RS rows (an address per
    // chunk held 31 registers more at NCH 2, ptxas)
    constexpr int CH = 8 * NCH, RS = TC_THREADS / CH;
    const uint32_t dst = sm90::smem_addr(tile);
    const int r = tid / CH, c = tid % CH;
    const bf16* row =
        src + static_cast<int64_t>(r0 + r) * row_stride + c * 8;
    const int64_t step = RS * row_stride;
    const bool cin = c * 8 < D;
#pragma unroll
    for (int x = 0; x < ROWS / RS; ++x) {
      const bool in = cin && r0 + r + x * RS < S;
      sm90::cp_async16(
          dst + (c / 8) * ROWS * 128 + sm90::sw128(r + x * RS, c % 8),
          in ? row + x * step : src, in ? 16 : 0);
    }
  } else {
    for (int e = tid; e < ROWS * 64 * NCH; e += TC_THREADS) {
      const int r = e / (64 * NCH), col = e % (64 * NCH);
      const bool in = r0 + r < S && col < D;
      *reinterpret_cast<bf16*>(tile + (col / 64) * ROWS * 128 +
                               sm90::sw128(r, (col % 64) / 8) +
                               (col % 8) * 2) =
          in ? src[static_cast<int64_t>(r0 + r) * row_stride + col]
             : __float2bfloat16_rn(0.f);
    }
  }
}

// four 8 x 8 bf16 matrices from shared memory, lane l giving the row
// address of matrix l / 8: the register operand of a 16 x 16 tile
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// max / sum over the 4 threads of a quad, which share two score rows
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(~0u, x, 1));
  return fmaxf(x, __shfl_xor_sync(~0u, x, 2));
}
// the row's log-sum-exp of the scaled, masked scores in natural-log
// units, from m (log2 units) and the quad's l
__device__ __forceinline__ float row_lse(float m, float l_safe) {
  return (m + log2f(l_safe)) * kLn2;
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(~0u, x, 1);
  return x + __shfl_xor_sync(~0u, x, 2);
}

// d (64 x 256, f32) += A (64 x 16 bf16, registers a[0-3]) * B (16 x 256
// at descriptor db: MN-major, four 64-wide column blocks lbo apart, read
// transposed)
#define BF16_RS_M64N256K16_TB                                                        \
  asm volatile(                                                              \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"                          \
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"              \
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
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"                  \
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
__device__ __forceinline__ void wgmma_rs_m64n256k16_tb(float (&d)[128],
                                                       const uint32_t* a,
                                                       uint64_t db) {
  const int scale_d = 1;
  BF16_RS_M64N256K16_TB;
}
#undef BF16_RS_M64N256K16_TB

// Online softmax of one 64-row tile's raw scores sc, in place: NK kv
// columns, this thread's NK / 2 of them in the accumulator's layout
// (element 4 j + 2 h + i at row row0 + 8 h, kv column k0 + 8 j + col0 +
// i), m in log2 units of the scaled scores, corr each row's correction of
// l (done here) and of acc (the caller's).  Masked scores (edge tiles
// only: past S, above the diagonal, at or past ``window`` behind the row;
// qt0 is the tile's first row) become -inf, so their p is exp2(-inf) = 0,
// as the reference's -1e30 gives; without a window no row's max is -inf
// after tile 0, whose column 0 every row keeps.  Maxima and sums are
// trees, p = exp2(s scale log2(e) - m) one FFMA and one MUFU.EX2.
template <int NK, bool WIN>
__device__ __forceinline__ void online_softmax(float* sc, float (&m)[2],
                                               float (&l)[2],
                                               float (&corr)[2], int k0,
                                               int qt0, int row0, int col0,
                                               int S, int causal, int window,
                                               float scale_log2) {
  constexpr int NV = NK / 4;         // a row's values in this thread
  if (k0 + NK > S || (causal && k0 + NK - 1 > qt0) ||
      (WIN && k0 <= qt0 + 63 - window)) {
#pragma unroll
    for (int e = 0; e < NK / 2; ++e) {
      const int row = row0 + 8 * ((e / 2) % 2);
      const int col = k0 + 8 * (e / 4) + col0 + e % 2;
      if (col >= S || (causal && col > row) ||
          (WIN && col <= row - window)) {
        sc[e] = kNegInf;
      }
    }
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    // the row's NV values: v(n) = sc[4 (n / 2) + 2 hh + n % 2]
    auto at = [&](int n) -> float& {
      return sc[4 * (n / 2) + 2 * hh + n % 2];
    };
    float t[NV / 2];
#pragma unroll
    for (int n = 0; n < NV / 2; ++n) t[n] = fmaxf(at(n), at(n + NV / 2));
#pragma unroll
    for (int w = NV / 4; w > 0; w /= 2) {
#pragma unroll
      for (int n = 0; n < w; ++n) t[n] = fmaxf(t[n], t[n + w]);
    }
    const float m_new = fmaxf(m[hh], quad_max(t[0]) * scale_log2);
    corr[hh] = fast_exp2(m[hh] - m_new);
    m[hh] = m_new;
#pragma unroll
    for (int n = 0; n < NV; ++n) {
      at(n) = fast_exp2(fmaf(at(n), scale_log2, -m_new));
    }
#pragma unroll
    for (int n = 0; n < NV / 2; ++n) t[n] = at(n) + at(n + NV / 2);
#pragma unroll
    for (int w = NV / 4; w > 0; w /= 2) {
#pragma unroll
      for (int n = 0; n < w; ++n) t[n] += t[n + w];
    }
    l[hh] = l[hh] * corr[hh] + t[0];   // this thread's part of the row
  }
}

}  // namespace

// Thread t holds accumulator element 4 j + 2 h + i at row 16 (t / 32) +
// (t % 32) / 4 + 8 h, column 8 j + 2 (t % 4) + i;
// wgmma's register A operand for k step ks is the same rows and columns
// 16 ks .. 16 ks + 15, so p packs straight from the score accumulator.
template <int NCH, bool VEC, bool WIN>
__global__ void __launch_bounds__(TC_THREADS, 2)
    flash_attn_wgmma_kernel(const bf16* __restrict__ q,
                            const bf16* __restrict__ k,
                            const bf16* __restrict__ v, bf16* __restrict__ o,
                            int S, int H, int Hkv, int D, float scale_log2,
                            int causal, int window, float* __restrict__ lse) {
  using L = TcSmem<NCH>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sq =
      smem_raw + ((1024 - (sm90::smem_addr(smem_raw) & 1023)) & 1023);
  auto sk = [&](int st) { return sq + L::kQ + st * 2 * L::kKV; };
  auto sv = [&](int st) { return sq + L::kQ + st * 2 * L::kKV + L::kKV; };
  const int tid = threadIdx.x;
  const int n_tiles = (S + TQ - 1) / TQ;
  const int q0 = (n_tiles - 1 - blockIdx.x) * TQ;   // longest first
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int64_t rs = static_cast<int64_t>(H) * D;
  const int64_t base = (static_cast<int64_t>(b) * S * H + h) * D;
  // K and V: KV head h / G of H_kv, rows H_kv D apart
  const int64_t krs = static_cast<int64_t>(Hkv) * D;
  const int64_t kbase = (static_cast<int64_t>(b) * S * Hkv + h / (H / Hkv)) * D;
  // kv tiles j0 .. j0 + n_kv - 1: from the first tile that meets the
  // window's band (0 without a window) to the last below the diagonal
  const int j0 = WIN ? max(0, q0 - window + 1) / TK : 0;
  const int n_kv = (causal ? min((S + TK - 1) / TK, (q0 + TQ - 1) / TK + 1)
                           : (S + TK - 1) / TK) - j0;
  const int row0 = q0 + 16 * (tid / 32) + (tid % 32) / 4;
  const int col0 = 2 * (tid % 4);

  stage_tc<TQ, NCH, VEC>(sq, q + base, rs, q0, S, D, tid);
  stage_tc<TK, NCH, VEC>(sk(0), k + kbase, krs, j0 * TK, S, D, tid);
  stage_tc<TK, NCH, VEC>(sv(0), v + kbase, krs, j0 * TK, S, D, tid);
  sm90::cp_async_commit();

  // under a window a row may meet a tile wholly outside its band before
  // its first key: m starts finite there, so that such a tile leaves
  // m, l and acc as they are (p = exp2(-inf) = 0, correction 1)
  const float m0 = WIN ? -1e30f : kNegInf;
  float acc[NCH][32], m[2] = {m0, m0}, l[2] = {0.f, 0.f};
  uint32_t qf[4 * NCH][4];          // Q's register operand, k step ks
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
  }
  // S = Q K^T of the kv tile in stage st, all 4 NCH k steps (the zero
  // columns past D add nothing), Q from registers, one wgmma group
  auto issue_qk = [&](float (&sc)[32], int st) {
    const uint32_t k_addr = sm90::smem_addr(sk(st));
#pragma unroll
    for (int ks = 0; ks < 4 * NCH; ++ks) {
      const int blk = ks / 4, off = (ks % 4) * 32;   // 16 d = 32 bytes
      wgmma_rs_m64n64k16<false>(
          sc, qf[ks],
          sm90::desc_sw128(k_addr + blk * TK * 128 + off, 16, 1024), ks > 0);
    }
    sm90::wgmma_commit();
  };
  // O += P V with V in stage st, one wgmma group
  auto issue_pv = [&](const uint32_t (&p)[16], int st) {
    const uint32_t v_addr = sm90::smem_addr(sv(st));
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
#pragma unroll
      for (int ks = 0; ks < TK / 16; ++ks) {
        wgmma_rs_m64n64k16<true>(
            acc[c], p + 4 * ks,
            sm90::desc_sw128(v_addr + c * TK * 128 + ks * 16 * 128, 1024,
                             1024),
            1);
      }
    }
    sm90::wgmma_commit();
  };
  // online softmax of tile j0 + j's raw scores sc, then p packed to bf16
  auto softmax = [&](float (&sc)[32], int j, uint32_t (&p)[16],
                     float (&corr)[2]) {
    online_softmax<TK, WIN>(sc, m, l, corr, (j0 + j) * TK, q0, row0, col0,
                            S, causal, window, scale_log2);
#pragma unroll
    for (int i = 0; i < 16; ++i) p[i] = pack_bf16(sc[2 * i], sc[2 * i + 1]);
  };
  // copy kv tile j into stage j % 3 as one commit group (empty past the
  // last tile); issued once P_{j-3} V_{j-3} has retired, so the copy has
  // a whole iteration to land
  auto load_tile = [&](int j) {
    if (j < n_kv) {
      const int st = j % KV_STAGES;
      stage_tc<TK, NCH, VEC>(sk(st), k + kbase, krs, (j0 + j) * TK, S, D,
                             tid);
      stage_tc<TK, NCH, VEC>(sv(st), v + kbase, krs, (j0 + j) * TK, S, D,
                             tid);
    }
    sm90::cp_async_commit();
  };
  // every thread's copies of the oldest pending tile have landed (the
  // newest group may still be in flight) and are visible to wgmma
  auto wait_tile = [&]() {
    sm90::cp_async_wait<1>();
    sm90::fence_proxy_async();
    __syncthreads();
  };

  float s[32], corr[2];
  uint32_t p_prev[16], p_cur[16];
  load_tile(1);
  wait_tile();                       // Q and tile 0
  // Q's register operand for every k step, loaded once: lane l reads the
  // row of matrix l / 8 (rows + 8 for odd matrices, d + 8 for the last two)
#pragma unroll
  for (int ks = 0; ks < 4 * NCH; ++ks) {
    const int lane = tid % 32, mat = lane / 8;
    const int row = 16 * (tid / 32) + 8 * (mat % 2) + lane % 8;
    const int chunk = 2 * ks + mat / 2;            // 8 d values a chunk
    ldmatrix_x4(qf[ks], sm90::smem_addr(sq) + (chunk / 8) * TQ * 128 +
                            sm90::sw128(row, chunk % 8));
  }
  sm90::wgmma_fence();
  issue_qk(s, 0);
  sm90::wgmma_wait<0>();
  sm90::fence_regs(s);
  softmax(s, 0, p_prev, corr);
  load_tile(2);
  for (int j = 1; j < n_kv; ++j) {
    // S_j = Q K_j^T and O += P_{j-1} V_{j-1} in flight together; the
    // softmax of S_j runs while the tensor cores finish P_{j-1} V_{j-1}
    wait_tile();                     // tile j
    sm90::wgmma_fence();
    issue_qk(s, j % KV_STAGES);
    issue_pv(p_prev, (j - 1) % KV_STAGES);
    sm90::wgmma_wait<1>();
    sm90::fence_regs(s);
    softmax(s, j, p_cur, corr);
    sm90::wgmma_wait<0>();
    sm90::fence_regs(p_prev);        // read by P_{j-1} V_{j-1} until here
#pragma unroll
    for (int c = 0; c < NCH; ++c) sm90::fence_regs(acc[c]);
    // P_{j-1} V_{j-1} is the warpgroup's last reader of stage (j - 1) % 3
    load_tile(j + 2);
    if (corr[0] != 1.f || corr[1] != 1.f) {   // x 1 is exact: skip it
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[c][i] *= corr[(i / 2) % 2];
      }
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) p_prev[i] = p_cur[i];
  }
  sm90::wgmma_fence();
  issue_pv(p_prev, (n_kv - 1) % KV_STAGES);
  sm90::wgmma_wait<0>();
  sm90::fence_regs(p_prev);
#pragma unroll
  for (int c = 0; c < NCH; ++c) sm90::fence_regs(acc[c]);

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row0 + 8 * hh;
    const float l_safe = fmaxf(quad_sum(l[hh]), 1e-30f);
    if (row >= S) continue;
    if (lse != nullptr && col0 == 0) {
      lse[(static_cast<int64_t>(b) * H + h) * S + row] =
          row_lse(m[hh], l_safe);
    }
    bf16* out = o + base + static_cast<int64_t>(row) * rs;
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
#pragma unroll
      for (int jb = 0; jb < 8; ++jb) {
        const int col = 64 * c + 8 * jb + col0;
        const float lo = acc[c][4 * jb + 2 * hh] / l_safe;
        const float hi = acc[c][4 * jb + 2 * hh + 1] / l_safe;
        if (VEC && col + 1 < D) {
          *reinterpret_cast<__nv_bfloat162*>(out + col) =
              __floats2bfloat162_rn(lo, hi);
        } else {
          if (col < D) out[col] = __float2bfloat16_rn(lo);
          if (col + 1 < D) out[col + 1] = __float2bfloat16_rn(hi);
        }
      }
    }
  }
}

// ------------------------ bfloat16, 128 < D <= 256: warp-specialised

namespace {

// A block: the producer warpgroup, then two consumer warpgroups of 64
// query rows; tiles of 64 rows by 256 values (four 128-byte column blocks)
constexpr int WS_THREADS = 384, WS_NCH = 4;
constexpr int kWsTile = 64 * 128 * WS_NCH;                  // 32 KB
// Q of each consumer, K of each of 3 stages, V of each of 2; the mbarriers
constexpr int WS_KST = 3, WS_VST = 2;
constexpr int kWsBars = (2 + WS_KST + WS_VST) * kWsTile;
constexpr int kWsBytes = kWsBars + 128 + 1024;              // + align
// mbarriers (8 bytes each): Q; K full (WS_KST), V full (WS_VST); K and
// V empty (released by both consumers), as many
constexpr int kMbQ = 0, kMbKFull = 1, kMbVFull = 4, kMbKEmpty = 6,
              kMbVEmpty = 9;
// arrivals that release a stage: lane 0 of each of the consumers' 8 warps
constexpr int kWsRelease = 8;
// named barriers (0 is __syncthreads'): consumer c waits on kBarTurn + c
// before it issues its products, and passes the turn to the other after
constexpr int kBarTurn = 1;
// registers a thread after setmaxnreg: 128 x 24 + 256 x 240 = 384 x 168,
// the pool __launch_bounds__(384, 1) gives the block
constexpr int kProducerRegs = 24, kConsumerRegs = 240;

}  // namespace

// The tensor maps tq (q: H heads) and tk, tv (k, v: H_kv heads) view the
// (B, S, heads, D) tensors as 4-d (D, heads, S, B) with boxes of 64 values
// by 1 head by 64 rows (unused, zeros, without VEC).  Consumer thread t
// holds S and O in the accumulator layout of the D <= 128 kernel: element
// 4 j + 2 h + i at row 16 (t / 32) + (t % 32) / 4 + 8 h, column 8 j +
// 2 (t % 4) + i.
template <bool VEC, bool WIN, bool LSE>
__global__ void __launch_bounds__(WS_THREADS, 1)
    flash_attn_wgmma_d256_kernel(const __grid_constant__ CUtensorMap tq,
                                 const __grid_constant__ CUtensorMap tk,
                                 const __grid_constant__ CUtensorMap tv,
                                 const bf16* __restrict__ q,
                                 const bf16* __restrict__ k,
                                 const bf16* __restrict__ v,
                                 bf16* __restrict__ o, int S, int H, int Hkv,
                                 int D, float scale_log2, int causal,
                                 int window, int pair,
                                 float* __restrict__ lse) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm =
      smem_raw + ((1024 - (sm90::smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t base = sm90::smem_addr(sm);
  auto sq = [&](int c) { return base + c * kWsTile; };
  auto sk = [&](int st) { return base + (2 + st) * kWsTile; };
  auto sv = [&](int st) { return base + (2 + WS_KST + st) * kWsTile; };
  auto mb = [&](int i) { return base + kWsBars + 8 * i; };
  // a block: the same 64 rows of heads h0 and h0 + 1 (pair), else rows
  // q0 .. q0 + 127 of head h0
  const int rows = pair ? TQ : 2 * TQ;
  const int n_tiles = (S + rows - 1) / rows;
  const int q0 = (n_tiles - 1 - blockIdx.x) * rows;   // longest first
  const int groups = pair ? H / 2 : H;
  const int b = blockIdx.y / groups;
  const int h0 = pair ? 2 * (blockIdx.y % groups) : blockIdx.y % groups;
  const int hk = h0 / (H / Hkv);
  auto head = [&](int c) { return pair ? h0 + c : h0; };
  auto first_row = [&](int c) { return pair ? q0 : q0 + TQ * c; };
  // kv tiles j0 .. j0 + n_kv - 1 of the block, as in the D <= 128 kernel
  const int j0 = WIN ? max(0, q0 - window + 1) / TK : 0;
  const int n_kv = (causal ? min((S + TK - 1) / TK, (q0 + rows - 1) / TK + 1)
                           : (S + TK - 1) / TK) - j0;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    // a full barrier completes on its TMA bytes (one arrival with them),
    // or on the producer warpgroup's 128 stores without VEC
    const uint32_t fill = VEC ? 1 : 128;
    sm90::mbar_init(mb(kMbQ), fill);
#pragma unroll
    for (int st = 0; st < WS_KST; ++st) {
      sm90::mbar_init(mb(kMbKFull + st), fill);
      sm90::mbar_init(mb(kMbKEmpty + st), kWsRelease);
    }
#pragma unroll
    for (int st = 0; st < WS_VST; ++st) {
      sm90::mbar_init(mb(kMbVFull + st), fill);
      sm90::mbar_init(mb(kMbVEmpty + st), kWsRelease);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {                     // producer
    sm90::setmaxnreg_dec<kProducerRegs>();
    // K_j goes to stage j % WS_KST once both consumers have released tile
    // j - WS_KST there (the phase of parity (j / WS_KST - 1) & 1 of its
    // empty barrier), V_j likewise in its WS_VST stages; K_j first, as it
    // is read first
    if constexpr (VEC) {
      if (threadIdx.x != 0) return;
      sm90::mbar_expect_tx(mb(kMbQ), 2 * kWsTile);
#pragma unroll
      for (int c = 0; c < 2; ++c) {
#pragma unroll
        for (int blk = 0; blk < WS_NCH; ++blk) {
          sm90::tma_load_4d(sq(c) + blk * TQ * 128, &tq, 64 * blk, head(c),
                            first_row(c), b, mb(kMbQ));
        }
      }
      for (int j = 0; j < n_kv; ++j) {
        const int ks = j % WS_KST, vs = j % WS_VST, r0 = (j0 + j) * TK;
        if (j >= WS_KST) {
          sm90::mbar_wait(mb(kMbKEmpty + ks), ((j / WS_KST) & 1) ^ 1);
        }
        sm90::mbar_expect_tx(mb(kMbKFull + ks), kWsTile);
#pragma unroll
        for (int blk = 0; blk < WS_NCH; ++blk) {
          sm90::tma_load_4d(sk(ks) + blk * TK * 128, &tk, 64 * blk, hk, r0,
                            b, mb(kMbKFull + ks));
        }
        if (j >= WS_VST) {
          sm90::mbar_wait(mb(kMbVEmpty + vs), ((j / WS_VST) & 1) ^ 1);
        }
        sm90::mbar_expect_tx(mb(kMbVFull + vs), kWsTile);
#pragma unroll
        for (int blk = 0; blk < WS_NCH; ++blk) {
          sm90::tma_load_4d(sv(vs) + blk * TK * 128, &tv, 64 * blk, hk, r0,
                            b, mb(kMbVFull + vs));
        }
      }
    } else {
      // plain loads by the whole warpgroup into the same swizzled tiles
      const int pt = threadIdx.x;
      const int64_t rs = static_cast<int64_t>(H) * D;
      const int64_t krs = static_cast<int64_t>(Hkv) * D;
      const int64_t kbase = (static_cast<int64_t>(b) * S * Hkv + hk) * D;
      for (int c = 0; c < 2; ++c) {
        stage_tc<TQ, WS_NCH, false>(
            sm + c * kWsTile,
            q + (static_cast<int64_t>(b) * S * H + head(c)) * D, rs,
            first_row(c), S, D, pt);
      }
      sm90::fence_proxy_async();
      sm90::mbar_arrive(mb(kMbQ));
      for (int j = 0; j < n_kv; ++j) {
        const int ks = j % WS_KST, vs = j % WS_VST, r0 = (j0 + j) * TK;
        if (j >= WS_KST) {
          sm90::mbar_wait(mb(kMbKEmpty + ks), ((j / WS_KST) & 1) ^ 1);
        }
        stage_tc<TK, WS_NCH, false>(sm + (sk(ks) - base), k + kbase, krs,
                                    r0, S, D, pt);
        sm90::fence_proxy_async();
        sm90::mbar_arrive(mb(kMbKFull + ks));
        if (j >= WS_VST) {
          sm90::mbar_wait(mb(kMbVEmpty + vs), ((j / WS_VST) & 1) ^ 1);
        }
        stage_tc<TK, WS_NCH, false>(sm + (sv(vs) - base), v + kbase, krs,
                                    r0, S, D, pt);
        sm90::fence_proxy_async();
        sm90::mbar_arrive(mb(kMbVFull + vs));
      }
    }
    return;
  }

  // consumer c (a compile-time index, so that its shared-memory addresses
  // and descriptors are the uniform base plus constants: built from a
  // per-thread index they would not be uniform, and ptxas would
  // serialise every wgmma)
  auto consumer = [&](auto index) {
    constexpr int c = decltype(index)::value;
    const int tid = threadIdx.x % 128;
    const int qc0 = first_row(c), hc = head(c);
    const int row0 = qc0 + 16 * (tid / 32) + (tid % 32) / 4;
    const int col0 = 2 * (tid % 4);
    const float m0 = WIN ? -1e30f : kNegInf;     // as in the D <= 128 kernel
    float acc[128], m[2] = {m0, m0}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;

    // S = Q K^T of the kv tile in stage st: 16 k steps, Q and K both from
    // shared memory, K-major; one wgmma group.  The descriptors are built
    // from 32-bit addresses at each k step (their high words are one
    // constant): a 64-bit add to a descriptor would rewrite the uniform
    // registers of a wgmma still in flight, and ptxas would serialise
    // every wgmma
    auto issue_qk = [&](float (&sc)[32], int st) {
#pragma unroll
      for (int ks = 0; ks < 4 * WS_NCH; ++ks) {
        const int off = (ks / 4) * 64 * 128 + (ks % 4) * 32;
        wgmma_ss_m64n64k16(sc, sm90::desc_sw128(sq(c) + off, 16, 1024),
                           sm90::desc_sw128(sk(st) + off, 16, 1024), ks > 0);
      }
      sm90::wgmma_commit();
    };
    // O += P V with V in stage st: one m64n256k16 a k step (V's column
    // blocks 64 rows x 128 bytes apart), one wgmma group
    auto issue_pv = [&](const uint32_t (&p)[16], int st) {
#pragma unroll
      for (int ks = 0; ks < TK / 16; ++ks) {
        wgmma_rs_m64n256k16_tb(
            acc, p + 4 * ks,
            sm90::desc_sw128(sv(st) + ks * 16 * 128, TK * 128, 1024));
      }
      sm90::wgmma_commit();
    };
    auto softmax = [&](float (&sc)[32], int j, uint32_t (&p)[16],
                       float (&corr)[2]) {
      online_softmax<TK, WIN>(sc, m, l, corr, (j0 + j) * TK, qc0, row0, col0,
                              S, causal, window, scale_log2);
#pragma unroll
      for (int i = 0; i < 16; ++i) p[i] = pack_bf16(sc[2 * i], sc[2 * i + 1]);
    };
    // tile j of K (V) has landed: phase j / stages of its stage's full
    // barrier
    auto wait_k = [&](int j) {
      sm90::mbar_wait(mb(kMbKFull + j % WS_KST), (j / WS_KST) & 1);
    };
    auto wait_v = [&](int j) {
      sm90::mbar_wait(mb(kMbVFull + j % WS_VST), (j / WS_VST) & 1);
    };
    // this consumer's products of a stage have retired (after wgmma_wait):
    // one arrival a warp
    auto release = [&](int bar) {
      if (tid % 32 == 0) sm90::mbar_arrive(mb(bar));
    };
    // turns: consumer c issues after the other has issued its last group;
    // consumer 1 lets consumer 0 go first, and both issue n_kv + 1 times
    auto my_turn = [&]() { bar_sync<256>(kBarTurn + c); };
    auto pass_turn = [&]() { bar_arrive<256>(kBarTurn + 1 - c); };

    // kv step j: S_j = Q K_j^T and O += P_{j-1} V_{j-1} in flight
    // together; the softmax of S_j (into p_out) runs while the tensor cores
    // finish P_{j-1} V_{j-1} (from p_in) and the other consumer's products
    float s[32], corr[2];
    auto step = [&](int j, uint32_t (&p_in)[16], uint32_t (&p_out)[16]) {
      wait_k(j);
      wait_v(j - 1);
      my_turn();
      sm90::wgmma_fence();
      issue_qk(s, j % WS_KST);
      issue_pv(p_in, (j - 1) % WS_VST);
      pass_turn();
      sm90::wgmma_wait<1>();
      sm90::fence_regs(s);
      release(kMbKEmpty + j % WS_KST);             // K_j read
      softmax(s, j, p_out, corr);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(p_in);          // read by P_{j-1} V_{j-1} until here
      sm90::fence_regs(acc);
      release(kMbVEmpty + (j - 1) % WS_VST);       // V_{j-1} read
      if (corr[0] != 1.f || corr[1] != 1.f) {   // x 1 is exact: skip it
#pragma unroll
        for (int i = 0; i < 128; ++i) acc[i] *= corr[(i / 2) % 2];
      }
    };
    // the last P V, from p
    auto last = [&](uint32_t (&p)[16]) {
      wait_v(n_kv - 1);
      my_turn();
      sm90::wgmma_fence();
      issue_pv(p, (n_kv - 1) % WS_VST);
      if (c == 0) pass_turn();         // consumer 1 waits for no more turns
      sm90::wgmma_wait<0>();
      sm90::fence_regs(p);
      sm90::fence_regs(acc);
    };

    // P alternates between two buffers, two kv steps a pass: a copy from
    // one to the other at each step lets the compiler write P into the
    // registers that P_{j-1} V_{j-1} still reads, and ptxas then
    // serialises every wgmma
    uint32_t pa[16], pb[16];
    if (c == 1) pass_turn();
    sm90::mbar_wait(mb(kMbQ), 0);
    wait_k(0);
    my_turn();
    sm90::wgmma_fence();
    issue_qk(s, 0);
    pass_turn();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(s);
    release(kMbKEmpty);
    softmax(s, 0, pa, corr);
    int j = 1;
    for (; j + 1 < n_kv; j += 2) {
      step(j, pa, pb);
      step(j + 1, pb, pa);
    }
    if (j < n_kv) {
      step(j, pa, pb);
      last(pb);
    } else {
      last(pa);
    }

#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = row0 + 8 * hh;
      const float l_safe = fmaxf(quad_sum(l[hh]), 1e-30f);
      if (row >= S) continue;
      if (LSE && col0 == 0) {
        lse[(static_cast<int64_t>(b) * H + hc) * S + row] =
            row_lse(m[hh], l_safe);
      }
      bf16* out =
          o + ((static_cast<int64_t>(b) * S + row) * H + hc) * D;
#pragma unroll
      for (int jb = 0; jb < 32; ++jb) {
        const int col = 8 * jb + col0;
        const float lo = acc[4 * jb + 2 * hh] / l_safe;
        const float hi = acc[4 * jb + 2 * hh + 1] / l_safe;
        if (VEC && col + 1 < D) {
          *reinterpret_cast<__nv_bfloat162*>(out + col) =
              __floats2bfloat162_rn(lo, hi);
        } else {
          if (col < D) out[col] = __float2bfloat16_rn(lo);
          if (col + 1 < D) out[col + 1] = __float2bfloat16_rn(hi);
        }
      }
    }
  };
  sm90::setmaxnreg_inc<kConsumerRegs>();
  if (wg == 1) {
    consumer(std::integral_constant<int, 0>());
  } else {
    consumer(std::integral_constant<int, 1>());
  }
}

// ---------------------------------------- float32, D <= 128: 3xTF32 wgmma

namespace {

using tf32::load4;
using tf32::RowTile;
using tf32::split4;
using tf32::split_p_tf32;
using tf32::split_tf32;
using tf32::tf32_rs_k8;
using tf32::tf32_ss_m64n64k8;

// A block: two consumer warpgroups (64 query rows each: wgmma, softmax),
// so that one's softmax runs beside the other's products, and one
// producer warpgroup (loads, 3xTF32 split, shared-memory stores); kv
// tiles of 32 rows, one stage of K and one of V
constexpr int FQ = 64, F_CONSUMERS = 2, FBQ = FQ * F_CONSUMERS, FK = 32;
constexpr int F_THREADS = 128 * (F_CONSUMERS + 1);
// named barriers (0 is __syncthreads' own), each for all threads: Q
// staged; the K (V) tile staged (full) or released by both consumers
// (empty)
constexpr int kBarQ = 1, kBarKFull = 2, kBarVFull = 3, kBarKEmpty = 4,
              kBarVEmpty = 5;

// Shared memory of a block with NCH column blocks of 32 floats (D <= 32
// NCH): Q hi and lo of each consumer (64 rows each), one K tile of 64
// rows (each column block: K hi's 32 rows, then K lo's) and V^T hi and lo
// (32 NCH rows of the 32 kv values of the tile, 128 bytes)
template <int NCH>
struct F32Smem {
  static constexpr int kQ = FQ * 128 * NCH;
  static constexpr int kK = 2 * FK * 128 * NCH;
  static constexpr int kV = 32 * NCH * 128;
  static constexpr int kBytes = 2 * F_CONSUMERS * kQ + kK + 2 * kV + 1024;
};

// kv rows [r0, r0 + 32) of V, transposed: V^T row d holds the tile's 32
// kv values in the order wgmma's register A operand needs (see the
// kernel): position 8 b + i (i < 4) holds kv row 8 b + 2 i, position
// 8 b + 4 + i kv row 8 b + 2 i + 1.  So 16-byte chunk c of a V^T row
// holds kv rows 8 (c / 2) + c % 2 + 2 i, i = 0-3: a thread loads those
// four rows at four d columns (4 g .. 4 g + 3), transposes the 4 x 4
// floats in registers and stores four chunks, one per d; THREADS threads
// (pt) share the 64 NCH such items.
template <int NCH, int THREADS>
struct VTile {
  static constexpr int kPer = 64 * NCH / THREADS;   // items a thread
  float4 v[kPer][4];

  __device__ __forceinline__ void load(const float* src, int64_t rs, int r0,
                                       int S, int D, int pt, bool vec) {
#pragma unroll
    for (int x = 0; x < kPer; ++x) {
      const int e = opaque(pt) + x * THREADS, c = e % 8, g = e / 8;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = r0 + 8 * (c / 2) + c % 2 + 2 * i;
        v[x][i] = load4(src + static_cast<int64_t>(r) * rs, 4 * g, D, r < S,
                        vec);
      }
    }
  }
  __device__ __forceinline__ void store(uint8_t* hi, uint8_t* lo,
                                        int pt) const {
#pragma unroll
    for (int x = 0; x < kPer; ++x) {
      const int e = opaque(pt) + x * THREADS, c = e % 8, g = e / 8;
      const float4* w = v[x];
      const float t[4][4] = {{w[0].x, w[1].x, w[2].x, w[3].x},
                             {w[0].y, w[1].y, w[2].y, w[3].y},
                             {w[0].z, w[1].z, w[2].z, w[3].z},
                             {w[0].w, w[1].w, w[2].w, w[3].w}};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t off = sm90::sw128(4 * g + j, c);
        uint4 h, l;
        split4(make_float4(t[j][0], t[j][1], t[j][2], t[j][3]), h, l);
        *reinterpret_cast<uint4*>(hi + off) = h;
        *reinterpret_cast<uint4*>(lo + off) = l;
      }
    }
  }
};

}  // namespace

// Consumer thread t holds score element 4 j + 2 h + i at row 16 (t / 32)
// + (t % 32) / 4 + 8 h, kv column 8 j + 2 (t % 4) + i.  TF32 wgmma's
// register A operand for k block j wants rows r, r + 8 and columns
// 8 j + t % 4 and 8 j + t % 4 + 4 of it: so column 2 q (q = t % 4) is
// passed as A column q and column 2 q + 1 as A column q + 4, and V^T's k
// positions are permuted to match (VTile).
template <int NCH, bool WIN>
__global__ void __launch_bounds__(F_THREADS, 1)
    flash_attn_tf32_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ o,
                           int S, int H, int Hkv, int D, float scale_log2,
                           int causal, int window, int vec,
                           float* __restrict__ lse) {
  using L = F32Smem<NCH>;
  constexpr int DN = 32 * NCH;       // O's columns: D zero-filled to DN
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sq =
      smem_raw + ((1024 - (sm90::smem_addr(smem_raw) & 1023)) & 1023);
  auto qh = [&](int w) { return sq + 2 * w * L::kQ; };
  auto ql = [&](int w) { return sq + (2 * w + 1) * L::kQ; };
  uint8_t* kt_s = sq + 2 * F_CONSUMERS * L::kQ;   // K hi rows, then lo
  uint8_t* vh = kt_s + L::kK;
  uint8_t* vl = vh + L::kV;
  const int n_tiles = (S + FBQ - 1) / FBQ;
  const int q0 = (n_tiles - 1 - blockIdx.x) * FBQ;   // longest first
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int64_t rs = static_cast<int64_t>(H) * D;
  const int64_t base = (static_cast<int64_t>(b) * S * H + h) * D;
  // K and V: KV head h / G of H_kv, rows H_kv D apart
  const int64_t krs = static_cast<int64_t>(Hkv) * D;
  const int64_t kbase = (static_cast<int64_t>(b) * S * Hkv + h / (H / Hkv)) * D;
  // both consumers walk every kv tile of the block, j0 .. j0 + n_kv - 1
  // (j0: the first tile that meets the band of the block's first row
  // under a window, else 0): tiles wholly above the first consumer's
  // rows, or wholly behind the second's band, are masked there (p = 0,
  // correction 1)
  const int j0 = WIN ? max(0, q0 - window + 1) / FK : 0;
  const int n_kv = (causal ? min((S + FK - 1) / FK, (q0 + FBQ - 1) / FK + 1)
                           : (S + FK - 1) / FK) - j0;
  const int wg = threadIdx.x / 128;

  if (wg == F_CONSUMERS) {           // producer
    const int pt = threadIdx.x - 128 * F_CONSUMERS;
#pragma unroll 1
    for (int x = 0; x < 2 * F_CONSUMERS; ++x) {   // 32 query rows at a time
      const int w = x / 2, r = (x % 2) * 32;
      RowTile<32, NCH, FQ, 128> qt;
      qt.load(q + base, rs, q0 + w * FQ + r, S, D, pt, vec);
      qt.store(qh(w) + r * 128, ql(w) + r * 128, pt);
    }
    sm90::fence_proxy_async();
    bar_arrive<F_THREADS>(kBarQ);
    // K runs one tile ahead of V: K_{j+1} is stored as soon as both
    // consumers have read K_j (S_j retired, mid iteration j), V_j once
    // they have read V_{j-1} (end of iteration j), each tile loaded into
    // registers beforehand
    RowTile<FK, NCH, 2 * FK, 128> kt;      // hi rows 0-31, lo rows 32-63
    VTile<NCH, 128> vt;
    kt.load(k + kbase, krs, j0 * FK, S, D, pt, vec);
    vt.load(v + kbase, krs, j0 * FK, S, D, pt, vec);
    kt.store(kt_s, kt_s + FK * 128, pt);
    sm90::fence_proxy_async();
    bar_arrive<F_THREADS>(kBarKFull);
    if (n_kv > 1) kt.load(k + kbase, krs, (j0 + 1) * FK, S, D, pt, vec);
    for (int j = 0; j < n_kv; ++j) {
      if (j + 1 < n_kv) {
        bar_sync<F_THREADS>(kBarKEmpty);
        kt.store(kt_s, kt_s + FK * 128, pt);
        sm90::fence_proxy_async();
        bar_arrive<F_THREADS>(kBarKFull);
        if (j + 2 < n_kv) {
          kt.load(k + kbase, krs, (j0 + j + 2) * FK, S, D, pt, vec);
        }
      }
      if (j > 0) bar_sync<F_THREADS>(kBarVEmpty);
      vt.store(vh, vl, pt);
      sm90::fence_proxy_async();
      bar_arrive<F_THREADS>(kBarVFull);
      if (j + 1 < n_kv) {
        vt.load(v + kbase, krs, (j0 + j + 1) * FK, S, D, pt, vec);
      }
    }
    return;
  }
  const int qw0 = q0 + wg * FQ;      // this consumer's first query row

  const int tid = threadIdx.x % 128;
  const int row0 = qw0 + 16 * (tid / 32) + (tid % 32) / 4;
  const int col0 = 2 * (tid % 4);
  // finite under a window, as in the bf16 kernel
  const float m0 = WIN ? -1e30f : kNegInf;
  float acc[DN / 2], m[2] = {m0, m0}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < DN / 2; ++i) acc[i] = 0.f;

  // S = Q K^T of the staged kv tile, as one 64-wide product per k
  // step and half: [Q_hi K_hi^T | Q_hi K_lo^T] + [Q_lo K_hi^T |
  // Q_lo K_lo^T] over all 4 NCH k steps (zero columns past D add
  // nothing), one wgmma group; the two halves are added by add_halves
  auto issue_qk = [&](float (&sc)[32]) {
    const uint32_t a_hi = opaque(sm90::smem_addr(qh(wg)));
    const uint32_t a_lo = opaque(sm90::smem_addr(ql(wg)));
    const uint32_t b = opaque(sm90::smem_addr(kt_s));
#pragma unroll
    for (int ks = 0; ks < 4 * NCH; ++ks) {
      const uint32_t oa = (ks / 4) * FQ * 128 + (ks % 4) * 32;
      const uint64_t db = sm90::desc_sw128(
          b + (ks / 4) * 2 * FK * 128 + (ks % 4) * 32, 16, 1024);
      tf32_ss_m64n64k8(sc, sm90::desc_sw128(a_hi + oa, 16, 1024), db,
                       ks > 0);
      tf32_ss_m64n64k8(sc, sm90::desc_sw128(a_lo + oa, 16, 1024), db, 1);
    }
    sm90::wgmma_commit();
  };
  // columns 0-31 of the 64-wide product (K_hi) plus columns 32-63 (K_lo),
  // into sc[0-15]
  auto add_halves = [&](float (&sc)[32]) {
#pragma unroll
    for (int e = 0; e < 16; ++e) sc[e] += sc[16 + e];
  };
  // O += P_hi V_hi + P_hi V_lo + P_lo V_hi with the staged V^T, one group
  auto issue_pv = [&](const uint32_t (&ph)[16], const uint32_t (&pl)[16]) {
    const uint32_t b_hi = opaque(sm90::smem_addr(vh));
    const uint32_t b_lo = opaque(sm90::smem_addr(vl));
#pragma unroll
    for (int ks = 0; ks < FK / 8; ++ks) {
      const uint64_t dbh = sm90::desc_sw128(b_hi + ks * 32, 16, 1024);
      tf32_rs_k8<DN>(acc, ph + 4 * ks, dbh);
      tf32_rs_k8<DN>(acc, ph + 4 * ks,
                     sm90::desc_sw128(b_lo + ks * 32, 16, 1024));
      tf32_rs_k8<DN>(acc, pl + 4 * ks, dbh);
    }
    sm90::wgmma_commit();
  };
  // online softmax of tile j0 + j's raw scores sc[0-15], in place
  auto softmax = [&](float (&sc)[32], int j, float (&corr)[2]) {
    online_softmax<FK, WIN>(sc, m, l, corr, (j0 + j) * FK, qw0, row0, col0,
                            S, causal, window, scale_log2);
  };

  // One stage of K and one of V: K_j is released once S_j has retired
  // (the producer stores K_{j+1} during the softmax of S_j), V_{j-1} once
  // P_{j-1} V_{j-1} has (V_j is stored while S_{j+1} runs)
  // p is split for P V once the previous P V has retired (its A operand
  // registers are free), so one set of them serves both
  float s2[32], corr[2];
  uint32_t ph[16], pl[16];
  bar_sync<F_THREADS>(kBarQ);
  bar_sync<F_THREADS>(kBarKFull);
  sm90::wgmma_fence();
  issue_qk(s2);
  sm90::wgmma_wait<0>();
  sm90::fence_regs(s2);
  if (n_kv > 1) bar_arrive<F_THREADS>(kBarKEmpty);
  add_halves(s2);
  softmax(s2, 0, corr);
  split_p_tf32(s2, ph, pl);
  for (int j = 1; j < n_kv; ++j) {
    // S_j = Q K_j^T and O += P_{j-1} V_{j-1} in flight together; the
    // softmax of S_j runs while the tensor cores finish P_{j-1} V_{j-1}
    bar_sync<F_THREADS>(kBarKFull);   // K_j
    sm90::wgmma_fence();
    issue_qk(s2);
    bar_sync<F_THREADS>(kBarVFull);   // V_{j-1}
    issue_pv(ph, pl);
    sm90::wgmma_wait<1>();
    sm90::fence_regs(s2);
    if (j + 1 < n_kv) bar_arrive<F_THREADS>(kBarKEmpty);     // K_j read
    add_halves(s2);
    softmax(s2, j, corr);
    sm90::wgmma_wait<0>();
    sm90::fence_regs(ph);            // read by P_{j-1} V_{j-1} until here
    sm90::fence_regs(pl);
    sm90::fence_regs(acc);
    bar_arrive<F_THREADS>(kBarVEmpty);                        // V_{j-1} read
    if (corr[0] != 1.f || corr[1] != 1.f) {   // x 1 is exact: skip it
#pragma unroll
      for (int i = 0; i < DN / 2; ++i) acc[i] *= corr[(i / 2) % 2];
    }
    split_p_tf32(s2, ph, pl);
  }
  bar_sync<F_THREADS>(kBarVFull);     // V_{n_kv - 1}
  sm90::wgmma_fence();
  issue_pv(ph, pl);
  sm90::wgmma_wait<0>();
  sm90::fence_regs(ph);
  sm90::fence_regs(pl);
  sm90::fence_regs(acc);

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row0 + 8 * hh;
    const float l_safe = fmaxf(quad_sum(l[hh]), 1e-30f);
    if (row >= S) continue;
    if (lse != nullptr && col0 == 0) {
      lse[(static_cast<int64_t>(b) * H + h) * S + row] =
          row_lse(m[hh], l_safe);
    }
    float* out = o + base + static_cast<int64_t>(row) * rs;
#pragma unroll
    for (int jb = 0; jb < DN / 8; ++jb) {
      const int col = 8 * jb + col0;
      const float lo = acc[4 * jb + 2 * hh] / l_safe;
      const float hi = acc[4 * jb + 2 * hh + 1] / l_safe;
      if (vec && col + 1 < D) {
        *reinterpret_cast<float2*>(out + col) = make_float2(lo, hi);
      } else {
        if (col < D) out[col] = lo;
        if (col + 1 < D) out[col + 1] = hi;
      }
    }
  }
}


// ------------------------------------ float32, 128 < D <= 256: 3xTF32 wgmma

namespace {

// A block: one consumer warpgroup of FQ query rows, then the producer
// warpgroup; kv tiles of FK rows; D 256 as 8 column blocks of 32 floats
constexpr int F2_THREADS = 256, F2_NCH = 8;
constexpr int F2_QB = 2;                         // k steps a group of S_j
constexpr int kF2QStride = 32 * F2_NCH + 4;      // Q's padded rows, floats
// Shared memory: [K_hi; K_lo] (each column block: K hi's 32 rows, then K
// lo's), V^T hi and lo (256 rows of the tile's 32 kv values), Q float32
struct F2Smem {
  static constexpr int kK = 2 * FK * 128 * F2_NCH;             // 64 KB
  static constexpr int kV = 32 * F2_NCH * 128;                 // 32 KB
  static constexpr int kQ = FQ * kF2QStride * 4;               // 65 KB
  static constexpr int kBytes = kK + 2 * kV + kQ + 1024;
};

}  // namespace

// Consumer thread t holds the scores and O in the accumulator layout of the
// D <= 128 kernel (element 4 j + 2 h + i at row 16 (t / 32) + (t % 32) / 4
// + 8 h, column 8 j + 2 (t % 4) + i), and P goes to TF32's register A
// operand as there (kv column 2 q as A column q, 2 q + 1 as q + 4, V^T
// permuted to match).  Q's A operand for k step ks is read from its
// float32 rows: a0 (r, 8 ks + q), a1 (r + 8, 8 ks + q), a2 (r, 8 ks + q +
// 4), a3 (r + 8, 8 ks + q + 4) with r = 16 (t / 32) + (t % 32) / 4, q = t
// % 4, then split into hi and lo.
template <bool WIN, bool LSE>
__global__ void __launch_bounds__(F2_THREADS, 1)
    flash_attn_tf32_d256_kernel(const float* __restrict__ q,
                                const float* __restrict__ k,
                                const float* __restrict__ v,
                                float* __restrict__ o, int S, int H, int Hkv,
                                int D, float scale_log2, int causal,
                                int window, int vec,
                                float* __restrict__ lse) {
  using L = F2Smem;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* kt_s =
      smem_raw + ((1024 - (sm90::smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* vh = kt_s + L::kK;
  uint8_t* vl = vh + L::kV;
  float* sqf = reinterpret_cast<float*>(vl + L::kV);
  const int n_tiles = (S + FQ - 1) / FQ;
  const int q0 = (n_tiles - 1 - blockIdx.x) * FQ;     // longest first
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int64_t rs = static_cast<int64_t>(H) * D;
  const int64_t base = (static_cast<int64_t>(b) * S * H + h) * D;
  const int64_t krs = static_cast<int64_t>(Hkv) * D;
  const int64_t kbase =
      (static_cast<int64_t>(b) * S * Hkv + h / (H / Hkv)) * D;
  const int j0 = WIN ? max(0, q0 - window + 1) / FK : 0;
  const int n_kv = (causal ? min((S + FK - 1) / FK, (q0 + FQ - 1) / FK + 1)
                           : (S + FK - 1) / FK) - j0;

  if (threadIdx.x >= 128) {          // producer
    const int pt = threadIdx.x - 128;
    // Q: 64 rows of float32 into rows of kF2QStride (zeros past S and D)
#pragma unroll 4
    for (int e = pt; e < FQ * 8 * F2_NCH; e += 128) {
      const int r = e / (8 * F2_NCH), c = e % (8 * F2_NCH);
      *reinterpret_cast<float4*>(sqf + r * kF2QStride + 4 * c) =
          load4(q + base + static_cast<int64_t>(q0 + r) * rs, 4 * c, D,
                q0 + r < S, vec);
    }
    bar_arrive<F2_THREADS>(kBarQ);
    // K a tile ahead of V, as in the D <= 128 kernel
    RowTile<FK, F2_NCH, 2 * FK, 128> kt;   // hi rows 0-31, lo rows 32-63
    VTile<F2_NCH, 128> vt;
    kt.load(k + kbase, krs, j0 * FK, S, D, pt, vec);
    vt.load(v + kbase, krs, j0 * FK, S, D, pt, vec);
    kt.store(kt_s, kt_s + FK * 128, pt);
    sm90::fence_proxy_async();
    bar_arrive<F2_THREADS>(kBarKFull);
    if (n_kv > 1) kt.load(k + kbase, krs, (j0 + 1) * FK, S, D, pt, vec);
    for (int j = 0; j < n_kv; ++j) {
      if (j + 1 < n_kv) {
        bar_sync<F2_THREADS>(kBarKEmpty);
        kt.store(kt_s, kt_s + FK * 128, pt);
        sm90::fence_proxy_async();
        bar_arrive<F2_THREADS>(kBarKFull);
        if (j + 2 < n_kv) {
          kt.load(k + kbase, krs, (j0 + j + 2) * FK, S, D, pt, vec);
        }
      }
      if (j > 0) bar_sync<F2_THREADS>(kBarVEmpty);
      vt.store(vh, vl, pt);
      sm90::fence_proxy_async();
      bar_arrive<F2_THREADS>(kBarVFull);
      if (j + 1 < n_kv) {
        vt.load(v + kbase, krs, (j0 + j + 1) * FK, S, D, pt, vec);
      }
    }
    return;
  }

  const int tid = threadIdx.x;
  const int row0 = q0 + 16 * (tid / 32) + (tid % 32) / 4;
  const int col0 = 2 * (tid % 4);
  const float m0 = WIN ? -1e30f : kNegInf;     // as in the bf16 kernels
  float acc[128], m[2] = {m0, m0}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  // this thread's first Q value of a k step: row r, column q
  const float* qa = sqf + (16 * (tid / 32) + (tid % 32) / 4) * kF2QStride +
                    tid % 4;

  // Q's A operand of the group's k steps F2_QB bi + kk, split into hi and
  // lo
  auto split_q = [&](uint32_t (&ah)[F2_QB][4], uint32_t (&al)[F2_QB][4],
                     int bi) {
#pragma unroll
    for (int kk = 0; kk < F2_QB; ++kk) {
      const float* x = qa + 8 * (F2_QB * bi + kk);
      split_tf32(x[0], ah[kk][0], al[kk][0]);
      split_tf32(x[8 * kF2QStride], ah[kk][1], al[kk][1]);
      split_tf32(x[4], ah[kk][2], al[kk][2]);
      split_tf32(x[8 * kF2QStride + 4], ah[kk][3], al[kk][3]);
    }
  };
  // S += [Q_hi K_hi^T | Q_hi K_lo^T] + [Q_lo K_hi^T | Q_lo K_lo^T] over
  // the group's k steps, one wgmma group
  auto issue_qk_group = [&](float (&sc)[32], const uint32_t (&ah)[F2_QB][4],
                            const uint32_t (&al)[F2_QB][4], int bi) {
    const uint32_t kb = opaque(sm90::smem_addr(kt_s));
#pragma unroll
    for (int kk = 0; kk < F2_QB; ++kk) {
      const int ks = F2_QB * bi + kk;
      const uint64_t db = sm90::desc_sw128(
          kb + (ks / 4) * 2 * FK * 128 + (ks % 4) * 32, 16, 1024);
      tf32_rs_k8<64>(sc, ah[kk], db);
      tf32_rs_k8<64>(sc, al[kk], db);
    }
    sm90::wgmma_commit();
  };
  // S = Q K^T of the staged kv tile: 32 / F2_QB groups, Q split for a
  // group while the one before it runs (two buffers: a buffer is
  // rewritten once the group that read it has retired; a register A
  // operand stays untouched until its wgmma retires).  All of S_j has
  // retired on return.  S is zeroed and every product accumulates: a
  // first product that overwrites S (scale_d 0) leaves ptxas too few
  // registers for the pipeline, and it serialises every wgmma
  uint32_t ah[2][F2_QB][4], al[2][F2_QB][4];
  auto fence_qa = [&](int x) {
#pragma unroll
    for (int kk = 0; kk < F2_QB; ++kk) {
      sm90::fence_regs(ah[x][kk]);
      sm90::fence_regs(al[x][kk]);
    }
  };
  auto issue_qk = [&](float (&sc)[32]) {
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
#pragma unroll
    for (int bi = 0; bi < 32 / F2_QB; ++bi) {
      const int x = bi % 2;
      if (bi >= 2) {
        sm90::wgmma_wait<1>();
        fence_qa(x);
      }
      split_q(ah[x], al[x], bi);
      sm90::wgmma_fence();
      issue_qk_group(sc, ah[x], al[x], bi);
    }
    sm90::wgmma_wait<0>();
    fence_qa(0);
    fence_qa(1);
    sm90::fence_regs(sc);
  };
  // columns 0-31 of the 64-wide product (K_hi) plus columns 32-63 (K_lo),
  // into sc[0-15]
  auto add_halves = [&](float (&sc)[32]) {
#pragma unroll
    for (int e = 0; e < 16; ++e) sc[e] += sc[16 + e];
  };
  // O += P_hi V_hi + P_hi V_lo + P_lo V_hi with the staged V^T, one group
  auto issue_pv = [&](const uint32_t (&ph)[16], const uint32_t (&pl)[16]) {
    const uint32_t b_hi = opaque(sm90::smem_addr(vh));
    const uint32_t b_lo = opaque(sm90::smem_addr(vl));
#pragma unroll
    for (int ks = 0; ks < FK / 8; ++ks) {
      const uint64_t dbh = sm90::desc_sw128(b_hi + ks * 32, 16, 1024);
      tf32_rs_k8<256>(acc, ph + 4 * ks, dbh);
      tf32_rs_k8<256>(acc, ph + 4 * ks,
                      sm90::desc_sw128(b_lo + ks * 32, 16, 1024));
      tf32_rs_k8<256>(acc, pl + 4 * ks, dbh);
    }
    sm90::wgmma_commit();
  };
  auto softmax = [&](float (&sc)[32], int j, float (&corr)[2]) {
    online_softmax<FK, WIN>(sc, m, l, corr, (j0 + j) * FK, q0, row0, col0,
                            S, causal, window, scale_log2);
  };

  // as in the D <= 128 kernel: K_j is released once S_j has retired, V_j
  // once P_j V_j has
  // p stays in float32 (16 registers) while S_{j+1} runs and is split
  // into hi and lo (32) only for P V, so that S_j's wgmma pipeline has
  // registers enough beside O
  float s2[32], corr[2], pf[16];
  uint32_t ph[16], pl[16];
  bar_sync<F2_THREADS>(kBarQ);
  bar_sync<F2_THREADS>(kBarKFull);
  issue_qk(s2);
  if (n_kv > 1) bar_arrive<F2_THREADS>(kBarKEmpty);
  add_halves(s2);
  softmax(s2, 0, corr);
#pragma unroll
  for (int i = 0; i < 16; ++i) pf[i] = s2[i];
  for (int j = 1; j < n_kv; ++j) {
    // S_j = Q K_j^T, then O += P_{j-1} V_{j-1} once S_j has retired (its
    // Q fragments are free then, which leaves registers for P V's
    // pipeline); the softmax of S_j runs while P_{j-1} V_{j-1} does
    bar_sync<F2_THREADS>(kBarKFull);   // K_j
    issue_qk(s2);
    if (j + 1 < n_kv) bar_arrive<F2_THREADS>(kBarKEmpty);     // K_j read
    bar_sync<F2_THREADS>(kBarVFull);   // V_{j-1}
    split_p_tf32(pf, ph, pl);
    sm90::wgmma_fence();
    issue_pv(ph, pl);
    add_halves(s2);
    softmax(s2, j, corr);
    sm90::wgmma_wait<0>();
    sm90::fence_regs(ph);            // read by P_{j-1} V_{j-1} until here
    sm90::fence_regs(pl);
    sm90::fence_regs(acc);
    bar_arrive<F2_THREADS>(kBarVEmpty);                       // V_{j-1} read
    if (corr[0] != 1.f || corr[1] != 1.f) {   // x 1 is exact: skip it
#pragma unroll
      for (int i = 0; i < 128; ++i) acc[i] *= corr[(i / 2) % 2];
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) pf[i] = s2[i];
  }
  bar_sync<F2_THREADS>(kBarVFull);     // V_{n_kv - 1}
  split_p_tf32(pf, ph, pl);
  sm90::wgmma_fence();
  issue_pv(ph, pl);
  sm90::wgmma_wait<0>();
  sm90::fence_regs(ph);
  sm90::fence_regs(pl);
  sm90::fence_regs(acc);

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row0 + 8 * hh;
    const float l_safe = fmaxf(quad_sum(l[hh]), 1e-30f);
    if (row >= S) continue;
    if (LSE && col0 == 0) {
      lse[(static_cast<int64_t>(b) * H + h) * S + row] =
          row_lse(m[hh], l_safe);
    }
    float* out = o + base + static_cast<int64_t>(row) * rs;
#pragma unroll
    for (int jb = 0; jb < 32; ++jb) {
      const int col = 8 * jb + col0;
      const float lo = acc[4 * jb + 2 * hh] / l_safe;
      const float hi = acc[4 * jb + 2 * hh + 1] / l_safe;
      if (vec && col + 1 < D) {
        *reinterpret_cast<float2*>(out + col) = make_float2(lo, hi);
      } else {
        if (col < D) out[col] = lo;
        if (col + 1 < D) out[col + 1] = hi;
      }
    }
  }
}

namespace {

constexpr float kLog2e = 1.4426950408889634f;
using sm90::allow_smem;
using sm90::bf16_tile_map;

template <int NCH, bool WIN>
int launch_f32(const void* q, const void* k, const void* v, void* o, int B,
               int S, int H, int Hkv, int D, float scale, int causal,
               int window, int vec, float* lse, cudaStream_t st) {
  auto kernel = flash_attn_tf32_kernel<NCH, WIN>;
  constexpr int smem = F32Smem<NCH>::kBytes;
  static bool configured = false;
  const cudaError_t err = allow_smem(kernel, smem, configured);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + FBQ - 1) / FBQ, B * H);
  kernel<<<grid, F_THREADS, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), S, H, Hkv, D,
      scale * kLog2e, causal, window, vec, lse);
  return static_cast<int>(cudaGetLastError());
}

// The D 256 kernels take the lse output as a template parameter: a
// runtime branch in their epilogues cost them 2-5 % with lse null (the
// warp-specialised consumers run at their register limits); the D <= 128
// kernels showed no cost and branch on the pointer
template <bool WIN, bool LSE>
int launch_f32_d256_impl(const void* q, const void* k, const void* v,
                         void* o, int B, int S, int H, int Hkv, int D,
                         float scale, int causal, int window, int vec,
                         float* lse, cudaStream_t st) {
  auto kernel = flash_attn_tf32_d256_kernel<WIN, LSE>;
  constexpr int smem = F2Smem::kBytes;
  static bool configured = false;
  const cudaError_t err = allow_smem(kernel, smem, configured);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + FQ - 1) / FQ, B * H);
  kernel<<<grid, F2_THREADS, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), S, H, Hkv, D,
      scale * kLog2e, causal, window, vec, lse);
  return static_cast<int>(cudaGetLastError());
}

template <bool WIN>
int launch_f32_d256(const void* q, const void* k, const void* v, void* o,
                    int B, int S, int H, int Hkv, int D, float scale,
                    int causal, int window, int vec, float* lse,
                    cudaStream_t st) {
  return lse ? launch_f32_d256_impl<WIN, true>(q, k, v, o, B, S, H, Hkv, D,
                                               scale, causal, window, vec,
                                               lse, st)
             : launch_f32_d256_impl<WIN, false>(q, k, v, o, B, S, H, Hkv, D,
                                                scale, causal, window, vec,
                                                lse, st);
}

template <int NCH, bool VEC, bool WIN>
int launch_tc(const void* q, const void* k, const void* v, void* o, int B,
              int S, int H, int Hkv, int D, float scale, int causal,
              int window, float* lse, cudaStream_t st) {
  auto kernel = flash_attn_wgmma_kernel<NCH, VEC, WIN>;
  constexpr int smem = TcSmem<NCH>::kBytes;
  static bool configured = false;
  const cudaError_t err = allow_smem(kernel, smem, configured);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + TQ - 1) / TQ, B * H);
  kernel<<<grid, TC_THREADS, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), S, H, Hkv, D,
      scale * kLog2e, causal, window, lse);
  return static_cast<int>(cudaGetLastError());
}

// G = H / H_kv even: a block takes 64 rows of a head pair, else 128 rows of
// one head
template <bool VEC, bool WIN, bool LSE>
int launch_d256_impl(const void* q, const void* k, const void* v, void* o,
                     int B, int S, int H, int Hkv, int D, float scale,
                     int causal, int window, float* lse, cudaStream_t st) {
  auto kernel = flash_attn_wgmma_d256_kernel<VEC, WIN, LSE>;
  static bool configured = false;
  const cudaError_t err = allow_smem(kernel, kWsBytes, configured);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap maps[3] = {};
  if (VEC && !(bf16_tile_map(&maps[0], q, B, S, H, D) &&
               bf16_tile_map(&maps[1], k, B, S, Hkv, D) &&
               bf16_tile_map(&maps[2], v, B, S, Hkv, D))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int pair = (H / Hkv) % 2 == 0;
  const int rows = pair ? TQ : 2 * TQ;
  const dim3 grid((S + rows - 1) / rows, B * (pair ? H / 2 : H));
  kernel<<<grid, WS_THREADS, kWsBytes, st>>>(
      maps[0], maps[1], maps[2], static_cast<const bf16*>(q),
      static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), S, H, Hkv, D, scale * kLog2e, causal, window,
      pair, lse);
  return static_cast<int>(cudaGetLastError());
}

template <bool VEC, bool WIN>
int launch_d256(const void* q, const void* k, const void* v, void* o, int B,
                int S, int H, int Hkv, int D, float scale, int causal,
                int window, float* lse, cudaStream_t st) {
  return lse ? launch_d256_impl<VEC, WIN, true>(q, k, v, o, B, S, H, Hkv, D,
                                                scale, causal, window, lse,
                                                st)
             : launch_d256_impl<VEC, WIN, false>(q, k, v, o, B, S, H, Hkv, D,
                                                 scale, causal, window, lse,
                                                 st);
}

}  // namespace

// q, o: (B, S, H, D), k, v: (B, S, Hkv, D), contiguous, H % Hkv == 0, D <=
// 256; window > 0: query i sees keys j > i - window only; bf16 != 0
// selects bfloat16, else float32.  Routes by dtype and D: bfloat16
// flash_attn_wgmma_kernel (D <= 128) or flash_attn_wgmma_d256_kernel,
// float32 flash_attn_tf32_kernel (D <= 128) or flash_attn_tf32_d256_kernel.
// lse_out, where not null, takes each row's float32 log-sum-exp of its
// scaled, masked scores, (B, H, S), natural log (the backward's input);
// null leaves every kernel as it runs for serving
extern "C" int repro_flash_attn(const void* q, const void* k, const void* v,
                                void* o, int32_t B, int32_t S, int32_t H,
                                int32_t Hkv, int32_t D, float scale,
                                int32_t causal, int32_t window, int32_t bf16,
                                void* lse_out, void* stream) {
  float* lse = static_cast<float*>(lse_out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool aligned = ((reinterpret_cast<uintptr_t>(q) |
                         reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v) |
                         reinterpret_cast<uintptr_t>(o)) & 15) == 0;
  // each kernel has an instantiation without the window's arithmetic
  // (window 0: the causal kernels as they were) and one with it
  const bool win = window > 0;
  if (!bf16) {
    const int vec = D % 4 == 0 && aligned;
    if (D > 128) {
      return win ? launch_f32_d256<true>(q, k, v, o, B, S, H, Hkv, D, scale,
                                         causal, window, vec, lse, st)
                 : launch_f32_d256<false>(q, k, v, o, B, S, H, Hkv, D, scale,
                                          causal, window, vec, lse, st);
    }
    if (D <= 64) {
      return win ? launch_f32<2, true>(q, k, v, o, B, S, H, Hkv, D, scale,
                                       causal, window, vec, lse, st)
                 : launch_f32<2, false>(q, k, v, o, B, S, H, Hkv, D, scale,
                                        causal, window, vec, lse, st);
    }
    return win ? launch_f32<4, true>(q, k, v, o, B, S, H, Hkv, D, scale,
                                     causal, window, vec, lse, st)
               : launch_f32<4, false>(q, k, v, o, B, S, H, Hkv, D, scale,
                                      causal, window, vec, lse, st);
  }
  const bool vec = D % 8 == 0 && aligned;
  if (D > 128) {
    if (vec) {
      return win ? launch_d256<true, true>(q, k, v, o, B, S, H, Hkv, D, scale,
                                           causal, window, lse, st)
                 : launch_d256<true, false>(q, k, v, o, B, S, H, Hkv, D,
                                            scale, causal, window, lse, st);
    }
    return win ? launch_d256<false, true>(q, k, v, o, B, S, H, Hkv, D, scale,
                                          causal, window, lse, st)
               : launch_d256<false, false>(q, k, v, o, B, S, H, Hkv, D, scale,
                                           causal, window, lse, st);
  }
  if (D <= 64) {
    if (vec) {
      return win ? launch_tc<1, true, true>(q, k, v, o, B, S, H, Hkv, D,
                                            scale, causal, window, lse, st)
                 : launch_tc<1, true, false>(q, k, v, o, B, S, H, Hkv, D,
                                             scale, causal, window, lse, st);
    }
    return win ? launch_tc<1, false, true>(q, k, v, o, B, S, H, Hkv, D, scale,
                                           causal, window, lse, st)
               : launch_tc<1, false, false>(q, k, v, o, B, S, H, Hkv, D,
                                            scale, causal, window, lse, st);
  }
  if (vec) {
    return win ? launch_tc<2, true, true>(q, k, v, o, B, S, H, Hkv, D, scale,
                                          causal, window, lse, st)
               : launch_tc<2, true, false>(q, k, v, o, B, S, H, Hkv, D, scale,
                                           causal, window, lse, st);
  }
  return win ? launch_tc<2, false, true>(q, k, v, o, B, S, H, Hkv, D, scale,
                                         causal, window, lse, st)
             : launch_tc<2, false, false>(q, k, v, o, B, S, H, Hkv, D, scale,
                                          causal, window, lse, st);
}
