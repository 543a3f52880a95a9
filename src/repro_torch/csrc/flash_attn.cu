// Fused softmax attention (flash attention) for Hopper (sm_90a):
// bfloat16 on the tensor cores, float32 on the CUDA cores; float32 inside.
//
// Replaces the Pallas kernel repro/kernels/flash_attn/flash_attn.py::
// _flash_kernel (via flash_attention_pallas and flash_attn/ops.py::
// flash_attention_kernel).  That kernel walks a (B H, q block, kv block)
// grid whose kv axis runs in order on the TPU core, carrying the online
// softmax's m, l and acc in VMEM scratch from one grid step to the next.
// Blocks on the card run in parallel and carry nothing, so each block owns
// one (batch x head, query tile) and loops over the kv tiles itself, with
// m, l and acc in registers.  Both versions keep the reference's
// semantics: scores scaled by 1/sqrt(D) and masked to -1e30, p = 0 under
// the mask, output acc / max(l, 1e-30) in the input type.  Under the
// causal mask the kv tiles wholly above the diagonal are skipped (there
// p is 0, m is unchanged and the correction is 1, so skipping is exact)
// and the heaviest query tiles are scheduled first.  Rows and columns past
// S are zero-filled and masked, so any S works.  q, k, v and the output
// are read and written in the op's (B, S, H, D) layout, without a
// transpose.
//
// Bound: operations.  A causal prefill at S = 4096, 32 heads of 128 is
// 4 S^2 D H / 2 = 137 GFLOP, 139 us at the bf16 tensor-core rate, against
// 134 MB of bytes (40 us).
//
// bfloat16 (flash_attn_wgmma_kernel).  A block is one warpgroup (128
// threads) and one 64-row query tile, two blocks an SM, so one block's
// softmax runs beside the other's products; kv tiles are 64 rows.
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
// float32 (flash_attn_kernel) stays on the CUDA cores: TF32 keeps about
// three decimal digits, too few for the float32 tolerance.  Per 64 x 64
// tile it stages K in shared memory, computes its scores (each of 256
// threads a 4 x 4 sub-tile), takes the row max and sum with shuffles
// across the 16 threads of a row, writes p to shared memory, stages V
// over K and adds p V into acc (each thread 4 rows x D/16 columns).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "sm90.cuh"

namespace {

constexpr int BQ = 64, BK = 64, THREADS = 256;   // BQ == BK: stage()
constexpr float kNeg = -1e30f;     // the reference's mask value

// max / sum over the 16 threads of one score row (lanes 0-15 or 16-31);
// the xor butterfly leaves the same value in every lane
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(~0u, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(~0u, x, o);
  return x;
}

// Shared memory of one block: Q (BQ x ld), K or V (BK x ld), P (BQ x BK+1)
constexpr size_t smem_bytes(int nc) {
  return (static_cast<size_t>(BQ + BK) * (16 * nc + 1) +
          static_cast<size_t>(BQ) * (BK + 1)) *
         sizeof(float);
}

// Stage rows [r0, r0 + 64) of one (batch, head) as float; zeros past S.
// Threads (ty, tx) take rows ty + 16 i and columns tx + 16 j.
template <typename T>
__device__ __forceinline__ void stage(float* dst, int ld, const T* src,
                                      int64_t row_stride, int r0, int S,
                                      int D, int tx, int ty) {
  for (int r = ty; r < BQ; r += 16) {
    const bool in = r0 + r < S;
    const T* row = src + static_cast<int64_t>(r0 + r) * row_stride;
    for (int c = tx; c < D; c += 16) {
      dst[r * ld + c] = in ? row[c] : 0.f;
    }
  }
}

}  // namespace

// NC = columns of D per thread / 16: D <= 16 NC
template <typename T, int NC>
__global__ void __launch_bounds__(THREADS)
    flash_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ o, int S,
                      int H, int D, float scale, int causal) {
  constexpr int LD = 16 * NC + 1;  // padded row stride: no bank conflicts
  constexpr int LDP = BK + 1;
  extern __shared__ float smem[];
  float* qs = smem;
  float* kvs = qs + BQ * LD;
  float* ps = kvs + BK * LD;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int n_tiles = (S + BQ - 1) / BQ;
  const int q0 = (n_tiles - 1 - blockIdx.x) * BQ;   // longest first
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int64_t row_stride = static_cast<int64_t>(H) * D;
  const int64_t base = (static_cast<int64_t>(b) * S * H + h) * D;
  stage(qs, LD, q + base, row_stride, q0, S, D, tx, ty);

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }
  const int n_kv = causal ? min(n_tiles, (q0 + BQ - 1) / BK + 1)
                          : (S + BK - 1) / BK;
  for (int kt = 0; kt < n_kv; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();                 // the last tile's P V has finished
    stage(kvs, LD, k + base, row_stride, k0, S, D, tx, ty);
    __syncthreads();
    float s[4][4] = {};
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = kvs[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      bool keep[4];
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        keep[j] = col < S && (!causal || col <= row);
        s[i][j] = keep[j] ? s[i][j] * scale : kNeg;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = keep[j] ? expf(s[i][j] - m_new) : 0.f;
        ps[(ty + 16 * i) * LDP + tx + 16 * j] = p;
        sum += p;
      }
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();                 // K is read, P is written
    stage(kvs, LD, v + base, row_stride, k0, S, D, tx, ty);
    __syncthreads();
    for (int j = 0; j < BK; ++j) {
      float pv[4], vv[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty + 16 * i) * LDP + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) vv[c] = kvs[j * LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= S) continue;
    const float l_safe = fmaxf(l[i], 1e-30f);
    T* out = o + base + static_cast<int64_t>(row) * row_stride;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (col < D) out[col] = acc[i][c] / l_safe;
    }
  }
}

// ---------------------------------------------------------- bfloat16

namespace {

using bf16 = __nv_bfloat16;
// one warpgroup of 64 query rows a block, two blocks an SM
constexpr int TQ = 64, TK = 64, TC_THREADS = 128, KV_STAGES = 3;
constexpr float kNegInf = -__builtin_huge_valf();

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
    const uint32_t dst = sm90::smem_addr(tile);
#pragma unroll
    for (int x = 0; x < ROWS * 8 * NCH / TC_THREADS; ++x) {
      const int e = tid + x * TC_THREADS;
      const int r = e / (8 * NCH), c = e % (8 * NCH);   // c: 8-value chunk
      const bool in = r0 + r < S && c * 8 < D;
      sm90::cp_async16(
          dst + (c / 8) * ROWS * 128 + sm90::sw128(r, c % 8),
          in ? src + static_cast<int64_t>(r0 + r) * row_stride + c * 8 : src,
          in ? 16 : 0);
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

// d (64 x 64, f32) (+)= A (64 x 16 bf16, registers a[0-3] in the
// accumulator's row / column order) * B (16 x 64 at descriptor db:
// K-major, or MN-major read transposed with TB); scale_d = 0 overwrites d
template <bool TB>
__device__ __forceinline__ void wgmma_rs_m64n64k16(float (&d)[32],
                                                   const uint32_t* a,
                                                   uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
        "n"(TB ? 1 : 0));
}

// four 8 x 8 bf16 matrices from shared memory, lane l giving the row
// address of matrix l / 8: the register operand of a 16 x 16 tile
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// 2^x in one MUFU.EX2 (relative error about 2^-22; 2^-inf = 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// max / sum over the 4 threads of a quad, which share two score rows
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(~0u, x, 1));
  return fmaxf(x, __shfl_xor_sync(~0u, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(~0u, x, 1);
  return x + __shfl_xor_sync(~0u, x, 2);
}

}  // namespace

// Thread t holds accumulator element 4 j + 2 h + i at row 16 (t / 32) +
// (t % 32) / 4 + 8 h, column 8 j + 2 (t % 4) + i;
// wgmma's register A operand for k step ks is the same rows and columns
// 16 ks .. 16 ks + 15, so p packs straight from the score accumulator.
template <int NCH, bool VEC>
__global__ void __launch_bounds__(TC_THREADS, 2)
    flash_attn_wgmma_kernel(const bf16* __restrict__ q,
                            const bf16* __restrict__ k,
                            const bf16* __restrict__ v, bf16* __restrict__ o,
                            int S, int H, int D, float scale_log2,
                            int causal) {
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
  const int n_kv = causal ? min((S + TK - 1) / TK, (q0 + TQ - 1) / TK + 1)
                          : (S + TK - 1) / TK;
  const int row0 = q0 + 16 * (tid / 32) + (tid % 32) / 4;
  const int col0 = 2 * (tid % 4);

  stage_tc<TQ, NCH, VEC>(sq, q + base, rs, q0, S, D, tid);
  stage_tc<TK, NCH, VEC>(sk(0), k + base, rs, 0, S, D, tid);
  stage_tc<TK, NCH, VEC>(sv(0), v + base, rs, 0, S, D, tid);
  sm90::cp_async_commit();

  float acc[NCH][32], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  uint32_t qf[4 * NCH][4];           // Q's register operand, k step ks
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
          sc, qf[ks], sm90::desc_sw128(k_addr + blk * TK * 128 + off, 16,
                                       1024),
          ks > 0);
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
  // online softmax of tile j's raw scores sc, m in log2 units of the
  // scaled scores.  Masked scores (edge tiles only) become -inf, so their
  // p is exp2(-inf) = 0, as the reference's -1e30 gives; no row's max is
  // -inf after tile 0, whose column 0 every row keeps.  Maxima and sums
  // are trees, p = exp2(s scale log2(e) - m) one FFMA and one MUFU.EX2.
  auto softmax = [&](float (&sc)[32], int j, uint32_t (&p)[16],
                     float (&corr)[2]) {
    const int k0 = j * TK;
    if (k0 + TK > S || (causal && k0 + TK - 1 > q0)) {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int row = row0 + 8 * ((e / 2) % 2);
        const int col = k0 + 8 * (e / 4) + col0 + e % 2;
        if (col >= S || (causal && col > row)) sc[e] = kNegInf;
      }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      // the row's 16 values: v(n) = sc[4 (n / 2) + 2 hh + n % 2]
      auto at = [&](int n) -> float& {
        return sc[4 * (n / 2) + 2 * hh + n % 2];
      };
      float t[8];
#pragma unroll
      for (int n = 0; n < 8; ++n) t[n] = fmaxf(at(n), at(n + 8));
#pragma unroll
      for (int w = 4; w > 0; w /= 2) {
#pragma unroll
        for (int n = 0; n < w; ++n) t[n] = fmaxf(t[n], t[n + w]);
      }
      const float m_new = fmaxf(m[hh], quad_max(t[0]) * scale_log2);
      corr[hh] = fast_exp2(m[hh] - m_new);
      m[hh] = m_new;
#pragma unroll
      for (int n = 0; n < 16; ++n) {
        at(n) = fast_exp2(fmaf(at(n), scale_log2, -m_new));
      }
#pragma unroll
      for (int n = 0; n < 8; ++n) t[n] = at(n) + at(n + 8);
#pragma unroll
      for (int w = 4; w > 0; w /= 2) {
#pragma unroll
        for (int n = 0; n < w; ++n) t[n] += t[n + w];
      }
      l[hh] = l[hh] * corr[hh] + t[0];   // this thread's part of the row
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) p[i] = pack_bf16(sc[2 * i], sc[2 * i + 1]);
  };
  // copy kv tile j into stage j % 3 as one commit group (empty past the
  // last tile); issued once P_{j-3} V_{j-3} has retired, so the copy has
  // a whole iteration to land
  auto load_tile = [&](int j) {
    if (j < n_kv) {
      const int st = j % KV_STAGES;
      stage_tc<TK, NCH, VEC>(sk(st), k + base, rs, j * TK, S, D, tid);
      stage_tc<TK, NCH, VEC>(sv(st), v + base, rs, j * TK, S, D, tid);
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

namespace {

template <typename T, int NC>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int S, int H, int D, float scale, int causal, cudaStream_t st) {
  auto kernel = flash_attn_kernel<T, NC>;
  const size_t smem = smem_bytes(NC);
  static bool configured = false;    // above 48 KB only when allowed
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid((S + BQ - 1) / BQ, B * H);
  kernel<<<grid, THREADS, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, H, D, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_nc(const void* q, const void* k, const void* v, void* o, int B,
              int S, int H, int D, float scale, int causal, cudaStream_t st) {
  if (D <= 16) return launch<T, 1>(q, k, v, o, B, S, H, D, scale, causal, st);
  if (D <= 32) return launch<T, 2>(q, k, v, o, B, S, H, D, scale, causal, st);
  if (D <= 64) return launch<T, 4>(q, k, v, o, B, S, H, D, scale, causal, st);
  return launch<T, 8>(q, k, v, o, B, S, H, D, scale, causal, st);
}

template <int NCH, bool VEC>
int launch_tc(const void* q, const void* k, const void* v, void* o, int B,
              int S, int H, int D, float scale, int causal, cudaStream_t st) {
  auto kernel = flash_attn_wgmma_kernel<NCH, VEC>;
  constexpr int smem = TcSmem<NCH>::kBytes;
  static bool configured = false;    // above 48 KB only when allowed
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid((S + TQ - 1) / TQ, B * H);
  kernel<<<grid, TC_THREADS, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), S, H, D,
      scale * 1.4426950408889634f, causal);      // log2(e)
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, o: (B, S, H, D) contiguous, D <= 128; bf16 != 0 selects
// bfloat16 (tensor cores), else float32
extern "C" int repro_flash_attn(const void* q, const void* k, const void* v,
                                void* o, int32_t B, int32_t S, int32_t H,
                                int32_t D, float scale, int32_t causal,
                                int32_t bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!bf16) return launch_nc<float>(q, k, v, o, B, S, H, D, scale, causal,
                                     st);
  const bool vec = D % 8 == 0 &&
                   ((reinterpret_cast<uintptr_t>(q) |
                     reinterpret_cast<uintptr_t>(k) |
                     reinterpret_cast<uintptr_t>(v) |
                     reinterpret_cast<uintptr_t>(o)) & 15) == 0;
  if (D <= 64) {
    return vec ? launch_tc<1, true>(q, k, v, o, B, S, H, D, scale, causal, st)
               : launch_tc<1, false>(q, k, v, o, B, S, H, D, scale, causal,
                                     st);
  }
  return vec ? launch_tc<2, true>(q, k, v, o, B, S, H, D, scale, causal, st)
             : launch_tc<2, false>(q, k, v, o, B, S, H, D, scale, causal, st);
}
