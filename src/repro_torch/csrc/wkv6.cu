// The WKV recurrence of RWKV-6's time mixing ("Finch", arXiv:2404.05892)
// for Hopper (sm_90a): a sequential kernel for decode and short inputs, a
// chunked one for prefill.
//
// Replaces no Pallas kernel: the reference computes the recurrence as
// chunked einsums over a (B, C, C, H, D) decay tensor
// (repro/models/rwkv6.py::wkv_chunked) for prefill and as a lax.scan of
// its oracle (::wkv_sequential) for decode.  On the card a scan on the hot
// path is a kernel: a host loop over 4096 positions in each of 24 layers
// would be ~10^5 launches a prefill.
//
// Per (batch, head), state S (D x D, k index first), in float32:
//   y_t = r_t S_{t-1} + (r_t . (u * k_t)) v_t
//   S_t = diag(exp(lw_t)) S_{t-1} + k_t v_t^T
// r, k, v in the activation dtype (bfloat16 or float32, widened exactly),
// lw (the log decay, <= 0) and u in float32.
//
// Routes (kernels/wkv6/ops.py picks one by shape): D = 64 and S >= 64
// take wkv6_chunked_kernel, every other shape (decode's S = 1 among them)
// the sequential wkv6_kernel.
//
// wkv6_kernel: one block per (batch, head), one thread per value column
// j, which keeps column S[:, j] (D floats) in registers.  Each step the
// thread of index i stages r_i, k_i, exp(lw_i) and u_i k_i in shared
// memory (two buffers, so one barrier a step), and every thread reads
// them back as broadcasts; the next step's loads are issued before this
// step's arithmetic.  The state update is a product and a sum each
// rounded (no FMA), as the plain version's S * w + k v^T, and exp is
// expf, as torch.exp: the state matches it bit for bit; y sums its D
// products in four interleaved chains.  128 blocks walking 4096 steps
// in order are latency-bound (3.07 ms at RWKV-6-1.6B's prefill, 19x the
// bound below): the chunked kernel takes prefill.
//
// wkv6_chunked_kernel: the reference's chunked algebra (rwkv6.py:117-134)
// over chunks of C = 64 positions, each cut into NS = 4 sub-chunks of
// 16.  With w = exp(lw) (expf) and every decay factor formed as a product
// of w's (<= 1: the reference's exponents <= 0, without the cancellation
// of differences of long log sums), per chunk:
//   within sub-chunk I, per channel: H_i = prod of w over [start(I), i),
//     G_j = prod over (j, end(I)], T_I = prod over the sub-chunk;
//   Q_i = r_i H_i, K~_j = k_j G_j; pre_I = prod_{M<I} T_M,
//     suf_J = prod_{M>J} T_M, decay = prod T_M;
//   inter-chunk  y_i += (Q_i pre_I) . S_prev
//   off-diagonal sub-blocks (J < I): A_ij = Q_i . (K~_j g_IJ),
//     g_IJ = prod_{J<M<I} T_M (the pair weight factored through the
//     sub-chunk boundary: both factors <= 1)
//   diagonal sub-blocks: A_ij = sum_k r_ik k_jk prod_{j<s<i} w_sk, the
//     pairwise form, by a running product down each row j; A_ii = r_i .
//     (u k_i), the bonus
//   y_i += sum_{j<=i} A_ij v_j;  S = diag(decay) S_prev + (K~ suf)^T V.
// Design.  One block of 512 threads per (batch, head) walks the chunks:
// only the carry of S from chunk to chunk is serial, and S stays in the
// tensor cores' accumulators (and a copy in shared memory for y).  Each
// chunk's r, k, v and lw are copied by 16-byte cp.async (zero-filled past
// S) while the previous chunk computes; then four steps, a barrier each:
// widen and exp; the running products down each channel (two warps
// forward, two backward, two the bonus); side by side, y's inter-chunk
// product (Q pre) S_prev (warps 0-7) and A's six off-diagonal 16 x 16
// tiles (warps 8-11) on the tensor cores, and A's diagonal sub-blocks on
// the CUDA cores (warps 12-15: a lane walks two rows of a pair at once
// over 8 channels, the partial sums reduce-scattered across 8 lanes);
// and y += A V (warps 0-7) beside the state's product (warps 8-15).
// Products run in 3xTF32 on mma.sync (m16n8k8, fragments by
// ldmatrix from rows padded to 68 floats: every fragment load hits 32
// banks): plain TF32 or bf16 is too coarse for the limit below, and bf16
// v is exact in TF32, so A V and (K~ suf)^T V take two products.  y and
// the state agree with the sequential form within 2^-16 of their largest
// magnitudes (another summation order), not bit for bit.
//
// Bound: at RWKV-6-1.6B's prefill (B 4, S 4096, 32 heads of 64) about
// 5 D^2 float32 operations a token and head, 10.7 GFLOP, 160 us at the
// CUDA cores' rate; bytes (bf16 r, k, v, float32 lw and y) 470 MB, 140
// us.  The chunked form does ~2.6 D^2 multiply-adds a token (two D x D
// products, the intra-chunk pairs) and the chunk states never leave the
// SM.  What holds it back (scripts/wkv6_steps.py reads the SM clock at
// each step's end): one block an SM, so each step's latency is exposed
// at its barrier; the three TF32 products a product on mma.sync; the
// diagonal walk's shared-memory traffic.  At RWKV-6-1.6B's prefill it
// takes ~2.8x the bound above.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

}  // namespace

template <int D, typename T>
__global__ void __launch_bounds__(D)
    wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ lw,
                const float* __restrict__ u,
                const float* __restrict__ state0, float* __restrict__ y,
                float* __restrict__ state, int S, int H) {
  __shared__ float sr[2][D], sk[2][D], sw[2][D], suk[2][D];
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int j = threadIdx.x;
  const int64_t rs = static_cast<int64_t>(H) * D;
  const int64_t base = (static_cast<int64_t>(b) * S * H + h) * D + j;
  const float* s0 = state0 + static_cast<int64_t>(bh) * D * D;
  float st[D];
#pragma unroll
  for (int i = 0; i < D; ++i) st[i] = s0[i * D + j];
  const float uj = u[h * D + j];
  // this thread's element of step t: r, k, lw at index j (staged for
  // all), v at column j (its own)
  float nr = 0.f, nk = 0.f, nw = 0.f, nv = 0.f;
  auto load = [&](int t) {
    const int64_t at = base + t * rs;
    nr = widen(r[at]);
    nk = widen(k[at]);
    nw = __ldg(lw + at);
    nv = widen(v[at]);
  };
  if (S > 0) load(0);
  for (int t = 0; t < S; ++t) {
    const int buf = t & 1;
    sr[buf][j] = nr;
    sk[buf][j] = nk;
    sw[buf][j] = expf(nw);
    suk[buf][j] = uj * nk;
    const float vj = nv;
    if (t + 1 < S) load(t + 1);
    // the buffer written two steps ago was last read before this barrier
    __syncthreads();
    float acc[4] = {0.f, 0.f, 0.f, 0.f}, bonus[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < D; ++i) {
      acc[i % 4] = fmaf(sr[buf][i], st[i], acc[i % 4]);
      bonus[i % 4] = fmaf(sr[buf][i], suk[buf][i], bonus[i % 4]);
    }
    const float ra = (acc[0] + acc[1]) + (acc[2] + acc[3]);
    const float rb = (bonus[0] + bonus[1]) + (bonus[2] + bonus[3]);
    y[base + t * rs] = ra + rb * vj;
#pragma unroll
    for (int i = 0; i < D; ++i) {
      st[i] = __fadd_rn(__fmul_rn(st[i], sw[buf][i]),
                        __fmul_rn(sk[buf][i], vj));
    }
  }
  float* sT = state + static_cast<int64_t>(bh) * D * D;
#pragma unroll
  for (int i = 0; i < D; ++i) sT[i * D + j] = st[i];
}

namespace {

// the chunked kernel's fixed sizes: head size, chunk, sub-chunk
namespace wkvc {
constexpr int D = 64, C = 64, TS = 16, NS = C / TS, THREADS = 512;
constexpr int PITCH = 68;             // floats a row of a [64][.] buffer
constexpr int BUF = 64 * PITCH;
// float buffers: r, k, w, Q by [position][channel], v by [channel]
// [position], K~ by [position][channel], A by [i][j], S by [v][k]: every
// tensor-core operand is read along its k dimension, where a row pitch of
// 68 puts the 32 lanes of a fragment load on 32 banks
enum { RF, KF, VT, WF, QB, KB, AB, SB, NBUF };
// per-channel vectors: pre_I, suf_I, decay, g of 6 tiles, u
constexpr int SMALL = (2 * NS + 1 + 6 + 1) * D;
template <typename T>
constexpr int smem_bytes() {
  return (NBUF * BUF + SMALL) * 4 + 3 * C * D * static_cast<int>(sizeof(T)) +
         C * D * 4;
}
static_assert(smem_bytes<float>() <= 232448, "shared memory");

__device__ __forceinline__ void cp_async16(const void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&w.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&w.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

// 3xTF32: x = hi + lo, hi = x rounded to TF32 (nearest, ties away, on
// the bit pattern as flash_attn.cu's float32 kernel does), lo = x - hi
// exactly in float32, passed as it is: the tensor core reads its top 19
// bits, so lo loses at most 2^-10 of itself, 2^-21 of x (two integer
// operations an element fewer than rounding lo too)
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}
__device__ __forceinline__ void split4(const float (&x)[4], uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    hi[e] = to_tf32(x[e]);
    lo[e] = __float_as_uint(x[e] - __uint_as_float(hi[e]));
  }
}
// d += a b, one m16n8k8 TF32 product accumulated in float32.  Fragments
// (lane = 4 g + t): a (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4); b
// (t, g), (t + 4, g); d (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1)
__device__ __forceinline__ void mma8(float (&d)[4], const uint32_t (&a)[4],
                                     uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// d += a b in three TF32 products, the small ones first; b exact in TF32
// (bf16 values widened) takes two
template <bool B_EXACT>
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], float b0,
                                     float b1) {
  if (B_EXACT) {
    mma8(d, al, __float_as_uint(b0), __float_as_uint(b1));
    mma8(d, ah, __float_as_uint(b0), __float_as_uint(b1));
  } else {
    const uint32_t h0 = to_tf32(b0), h1 = to_tf32(b1);
    mma8(d, al, h0, h1);
    mma8(d, ah, __float_as_uint(b0 - __uint_as_float(h0)),
         __float_as_uint(b1 - __uint_as_float(h1)));
    mma8(d, ah, h0, h1);
  }
}
// fragments from a buffer with rows of PITCH floats: A at (m0, k0) from
// the transpose, a [K][M] buffer, by 32-bit loads; from an [M][K] buffer
// (A) or an [N][K] one (B) by ldmatrix
__device__ __forceinline__ void frag_a_t(float (&a)[4], const float* buf,
                                         int m0, int k0, int lane) {
  const float* p = buf + (k0 + (lane & 3)) * PITCH + m0 + (lane >> 2);
  a[0] = p[0], a[1] = p[8], a[2] = p[4 * PITCH], a[3] = p[4 * PITCH + 8];
}
// ldmatrix reads 8 x 8 16-bit matrices, a 16-byte row from each lane's
// address; for 32-bit values a matrix is 8 rows x 4 columns and lane 4g +
// t receives (g, t): the TF32 fragments above.  A at (m0, k0): lane L
// addresses row m0 + L % 8 + 8 (L / 8 % 2), column k0 + 4 (L / 16)
__device__ __forceinline__ void ldsm_a(float (&a)[4], const float* buf,
                                       int m0, int k0, int lane) {
  const float* p = buf + (m0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * PITCH +
                   k0 + 4 * (lane >> 4);
  uint32_t r0, r1, r2, r3;
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))));
  a[0] = __uint_as_float(r0), a[1] = __uint_as_float(r1);
  a[2] = __uint_as_float(r2), a[3] = __uint_as_float(r3);
}
// B of the two n8 tiles at (k0, n0) and (k0, n0 + 8): b[0], b[1] and
// b[2], b[3]; lane L addresses row n0 + L % 8 + 8 (L / 16), column k0 +
// 4 (L / 8 % 2)
__device__ __forceinline__ void ldsm_b2(float (&b)[4], const float* buf,
                                        int n0, int k0, int lane) {
  const float* p = buf + (n0 + (lane & 7) + 8 * (lane >> 4)) * PITCH + k0 +
                   4 * ((lane >> 3) & 1);
  uint32_t r0, r1, r2, r3;
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))));
  b[0] = __uint_as_float(r0), b[1] = __uint_as_float(r1);
  b[2] = __uint_as_float(r2), b[3] = __uint_as_float(r3);
}
// B of the n8 tile at (k0, n0) alone (lanes 0-15 address)
__device__ __forceinline__ void ldsm_b(float& b0, float& b1, const float* buf,
                                       int n0, int k0, int lane) {
  const float* p =
      buf + (n0 + (lane & 7)) * PITCH + k0 + 4 * ((lane >> 3) & 1);
  uint32_t r0, r1;
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))));
  b0 = __uint_as_float(r0), b1 = __uint_as_float(r1);
}

}  // namespace wkvc

}  // namespace

template <typename T>
__global__ void __launch_bounds__(wkvc::THREADS, 1)
    wkv6_chunked_kernel(const T* __restrict__ r, const T* __restrict__ k,
                        const T* __restrict__ v, const float* __restrict__ lw,
                        const float* __restrict__ u,
                        const float* __restrict__ state0,
                        float* __restrict__ y, float* __restrict__ state,
                        int S, int H) {
  using namespace wkvc;
  constexpr bool V_EXACT = sizeof(T) == 2;    // bf16 v is exact in TF32
  extern __shared__ __align__(16) unsigned char smem[];
  float* const fb = reinterpret_cast<float*>(smem);
  float* const rf = fb + RF * BUF;
  float* const kf = fb + KF * BUF;
  float* const vt = fb + VT * BUF;
  float* const wf = fb + WF * BUF;
  float* const qb = fb + QB * BUF;
  float* const kb = fb + KB * BUF;
  float* const ab = fb + AB * BUF;
  float* const sb = fb + SB * BUF;
  float* const pre = fb + NBUF * BUF;       // [NS][D]
  float* const suf = pre + NS * D;          // [NS][D]
  float* const decay = suf + NS * D;        // [D]
  float* const gfac = decay + D;            // [6][D]
  float* const us = gfac + 6 * D;           // [D]
  T* const raw_r = reinterpret_cast<T*>(us + D);   // [C][D] each
  T* const raw_k = raw_r + C * D;
  T* const raw_v = raw_k + C * D;
  float* const raw_w = reinterpret_cast<float*>(raw_v + C * D);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int64_t rs = static_cast<int64_t>(H) * D;
  const int64_t base = (static_cast<int64_t>(b) * S * H + h) * D;
  const int n_chunks = (S + C - 1) / C;

  // chunk n's r, k, v, lw into the raw buffers, one commit group
  auto copy_chunk = [&](int n) {
    constexpr int PR = D * static_cast<int>(sizeof(T)) / 16;  // a row
    constexpr int PW = D * 4 / 16;
    for (int e = tid; e < C * PR; e += THREADS) {
      const int row = e / PR, piece = e % PR, pos = n * C + row;
      const int64_t at = base + static_cast<int64_t>(pos < S ? pos : 0) * rs +
                         piece * (16 / static_cast<int>(sizeof(T)));
      const int dst = row * D + piece * (16 / static_cast<int>(sizeof(T)));
      const int bytes = pos < S ? 16 : 0;
      cp_async16(raw_r + dst, r + at, bytes);
      cp_async16(raw_k + dst, k + at, bytes);
      cp_async16(raw_v + dst, v + at, bytes);
    }
    for (int e = tid; e < C * PW; e += THREADS) {
      const int row = e / PW, piece = e % PW, pos = n * C + row;
      const int64_t at =
          base + static_cast<int64_t>(pos < S ? pos : 0) * rs + piece * 4;
      cp_async16(raw_w + row * D + piece * 4, lw + at, pos < S ? 16 : 0);
    }
    cp_async_commit();
  };

  // warps 0-7 compute y (m-tile mt: the chunk's positions 16 mt..), warps
  // 8-15 the state (m-tile: its rows k = 16 mt..); each 32 columns (nb..)
  // as four n8 tiles.  The state lives in warps 8-15's accumulators, st[nt]
  // = S[m0 + g][n + 2t, +1], S[m0 + g + 8][n + 2t, +1], n = nb + 8 nt
  const int mt = (warp & 7) >> 1, m0 = 16 * mt, nb = 32 * (warp & 1);
  float st[4][4];
  auto store_state = [&](float* sT, bool global) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int c = nb + 8 * nt + 2 * t;
      if (global) {
        store2(sT + (m0 + g) * D + c, st[nt][0], st[nt][1]);
        store2(sT + (m0 + g + 8) * D + c, st[nt][2], st[nt][3]);
      } else {
        sT[c * PITCH + m0 + g] = st[nt][0];
        sT[(c + 1) * PITCH + m0 + g] = st[nt][1];
        sT[c * PITCH + m0 + g + 8] = st[nt][2];
        sT[(c + 1) * PITCH + m0 + g + 8] = st[nt][3];
      }
    }
  };
  if (warp >= 8) {
    const float* s0 = state0 + static_cast<int64_t>(bh) * D * D;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int c = nb + 8 * nt + 2 * t;
      const float2 x0 = *reinterpret_cast<const float2*>(s0 + (m0 + g) * D +
                                                         c);
      const float2 x1 = *reinterpret_cast<const float2*>(
          s0 + (m0 + g + 8) * D + c);
      st[nt][0] = x0.x, st[nt][1] = x0.y, st[nt][2] = x1.x, st[nt][3] = x1.y;
    }
    store_state(sb, false);
  }
  if (tid < D) us[tid] = u[h * D + tid];
  for (int e = tid; e < BUF; e += THREADS) ab[e] = 0.f;  // j > i stays 0
  copy_chunk(0);

  for (int n = 0; n < n_chunks; ++n) {
    cp_async_wait_all();
    __syncthreads();
    if (warp >= 8 && n > 0) store_state(sb, false);
    // 1. widen r, k, v (v transposed); w = exp(lw)
#pragma unroll
    for (int m = 0; m < C * D / 4 / THREADS; ++m) {
      const int e = tid + THREADS * m, row = e >> 4, c4 = (e & 15) * 4;
      store4(rf + row * PITCH + c4, load4(raw_r + row * D + c4));
      store4(kf + row * PITCH + c4, load4(raw_k + row * D + c4));
      const float4 l = load4(raw_w + row * D + c4);
      store4(wf + row * PITCH + c4,
             make_float4(expf(l.x), expf(l.y), expf(l.z), expf(l.w)));
    }
    {
      const int c = tid & 63, j0 = 8 * (tid >> 6);
      float x[8];
#pragma unroll
      for (int a = 0; a < 8; ++a) x[a] = widen(raw_v[(j0 + a) * D + c]);
      store4(vt + c * PITCH + j0, make_float4(x[0], x[1], x[2], x[3]));
      store4(vt + c * PITCH + j0 + 4, make_float4(x[4], x[5], x[6], x[7]));
    }
    __syncthreads();
    if (n + 1 < n_chunks) copy_chunk(n + 1);   // lands during 2.-4.
    // 2. running products down each channel: warps 0-1 forward (Q = r H
    // within each sub-chunk, T_I, pre_I, decay, g), warps 2-3 backward
    // (K~ = k G, suf_J), warps 4-5 the bonus A_ii = r_i . (u k_i)
    if (warp < 2) {
      const int c = tid;
      float e = 1.f, tot[NS];
#pragma unroll
      for (int I = 0; I < NS; ++I) {
        // a sub-chunk's loads ahead of its stores (the buffers may alias
        // for the compiler)
        float x[TS], w[TS];
#pragma unroll
        for (int s2 = 0; s2 < TS; ++s2) {
          x[s2] = rf[(I * TS + s2) * PITCH + c];
          w[s2] = wf[(I * TS + s2) * PITCH + c];
        }
        pre[I * D + c] = e;
        float run = 1.f;
#pragma unroll
        for (int s2 = 0; s2 < TS; ++s2) {
          qb[(I * TS + s2) * PITCH + c] = x[s2] * run;
          run = run * w[s2];
        }
        tot[I] = run;
        e = e * run;
      }
      decay[c] = e;
      // tiles 0 (1,0), 1 (2,0), 2 (2,1), 3 (3,0), 4 (3,1), 5 (3,2): the
      // product of T_M over J < M < I
      gfac[0 * D + c] = 1.f;
      gfac[1 * D + c] = tot[1];
      gfac[2 * D + c] = 1.f;
      gfac[3 * D + c] = tot[1] * tot[2];
      gfac[4 * D + c] = tot[2];
      gfac[5 * D + c] = 1.f;
    } else if (warp < 4) {
      const int c = tid - 64;
      float f = 1.f;
#pragma unroll
      for (int J = NS - 1; J >= 0; --J) {
        float x[TS], w[TS];
#pragma unroll
        for (int s2 = 0; s2 < TS; ++s2) {
          x[s2] = kf[(J * TS + s2) * PITCH + c];
          w[s2] = wf[(J * TS + s2) * PITCH + c];
        }
        suf[J * D + c] = f;
        float run = 1.f;
#pragma unroll
        for (int s2 = TS - 1; s2 >= 0; --s2) {
          kb[(J * TS + s2) * PITCH + c] = x[s2] * run;
          run = run * w[s2];
        }
        f = f * run;
      }
    } else if (warp < 6) {
      const int i = tid - 128;
      float a4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
      for (int c = 0; c < D; c += 4) {
        const float4 r4 = load4(rf + i * PITCH + c);
        const float4 k4 = load4(kf + i * PITCH + c);
        const float4 u4 = load4(us + c);
        a4[0] = fmaf(r4.x, u4.x * k4.x, a4[0]);
        a4[1] = fmaf(r4.y, u4.y * k4.y, a4[1]);
        a4[2] = fmaf(r4.z, u4.z * k4.z, a4[2]);
        a4[3] = fmaf(r4.w, u4.w * k4.w, a4[3]);
      }
      ab[i * PITCH + i] = (a4[0] + a4[1]) + (a4[2] + a4[3]);
    }
    __syncthreads();
    // 3. warps 0-7 on the tensor cores: y = (Q pre) S_prev, which does not
    // need A, into registers that step 4 finishes; A below the diagonal
    // (A[i][j]): warps 8-11 its off-diagonal tiles on the tensor cores,
    // warps 12-15 its diagonal sub-blocks on the CUDA cores
    float ya[4][4] = {};
    if (warp < 8) {
      const float* pv = pre + mt * D;
#pragma unroll 2
      for (int k0 = 0; k0 < D; k0 += 8) {
        float a[4];
        uint32_t ah[4], al[4];
        ldsm_a(a, qb, m0, k0, lane);
        const float p0 = pv[k0 + t], p1 = pv[k0 + t + 4];
        a[0] *= p0, a[1] *= p0, a[2] *= p1, a[3] *= p1;
        split4(a, ah, al);
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          float b[4];
          ldsm_b2(b, sb, nb + 16 * h2, k0, lane);
          mma3<false>(ya[2 * h2], ah, al, b[0], b[1]);
          mma3<false>(ya[2 * h2 + 1], ah, al, b[2], b[3]);
        }
      }
    } else if (warp < 12) {
      // off-diagonal n8 units: tile p = unit / 2 (rows 16 I.., columns
      // 16 J..), its n8 tile unit % 2; Q (K~ g)^T, units warp - 8 + 4 e
#pragma unroll 1
      for (int unit = warp - 8; unit < 12; unit += 4) {
        const int p = unit >> 1;
        const int I = p == 0 ? 1 : (p < 3 ? 2 : 3), J = p - I * (I - 1) / 2;
        const int c0 = 16 * J + 8 * (unit & 1);
        const float* gp = gfac + p * D;
        float acc[4] = {};
#pragma unroll 4
        for (int k0 = 0; k0 < D; k0 += 8) {
          float a[4], b0, b1;
          uint32_t ah[4], al[4];
          ldsm_a(a, qb, 16 * I, k0, lane);
          split4(a, ah, al);
          ldsm_b(b0, b1, kb, c0, k0, lane);
          mma3<false>(acc, ah, al, b0 * gp[k0 + t], b1 * gp[k0 + t + 4]);
        }
        store2(ab + (16 * I + g) * PITCH + c0 + 2 * t, acc[0], acc[1]);
        store2(ab + (16 * I + g + 8) * PITCH + c0 + 2 * t, acc[2], acc[3]);
      }
    } else {
      // diagonal tile I = warp - 12, pairwise on the CUDA cores: the 8
      // lanes of group q walk rows 2q, 2q + 1, then 14 - 2q, 15 - 2q (16
      // steps in all), an eighth of the channels each; a step loads r_i
      // and w_{i-1} once for the two chains of a row pair, and leaves two
      // partial sums, reduced across the 8 lanes after the walk
      const int I = warp - 12, q = lane >> 3, c8 = lane & 7, cb = 8 * c8;
      const int r0 = I * TS, split_at = TS - 1 - 2 * q;
      float kp[2][8] = {}, part[2 * TS];
      auto load_k = [&](float (&x)[8], int row) {
        const float4 lo = load4(kf + (r0 + row) * PITCH + cb);
        const float4 hi = load4(kf + (r0 + row) * PITCH + cb + 4);
        x[0] = lo.x, x[1] = lo.y, x[2] = lo.z, x[3] = lo.w;
        x[4] = hi.x, x[5] = hi.y, x[6] = hi.z, x[7] = hi.w;
      };
#pragma unroll
      for (int s2 = 0; s2 < TS; ++s2) {
        // rows j0, j0 + 1 of the current pair; step e of that pair
        const bool second = s2 >= split_at;
        const int j0 = second ? TS - 2 - 2 * q : 2 * q;
        const int e = second ? s2 - split_at : s2;
        const int il = j0 + 1 + e;
        if (e == 0) {
          load_k(kp[0], j0);
        } else {
          const float4 lo = load4(wf + (r0 + il - 1) * PITCH + cb);
          const float4 hi = load4(wf + (r0 + il - 1) * PITCH + cb + 4);
          const float w8[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
          for (int c = 0; c < 8; ++c) kp[0][c] *= w8[c];
          if (e == 1) {
            load_k(kp[1], j0 + 1);
          } else {
#pragma unroll
            for (int c = 0; c < 8; ++c) kp[1][c] *= w8[c];
          }
        }
        const float4 lo = load4(rf + (r0 + il) * PITCH + cb);
        const float4 hi = load4(rf + (r0 + il) * PITCH + cb + 4);
        const float r8[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          part[2 * s2 + m] =
              ((r8[0] * kp[m][0] + r8[1] * kp[m][1]) +
               (r8[2] * kp[m][2] + r8[3] * kp[m][3])) +
              ((r8[4] * kp[m][4] + r8[5] * kp[m][5]) +
               (r8[6] * kp[m][6] + r8[7] * kp[m][7]));
        }
      }
      // reduce-scatter the 32 partial sums over the group's 8 lanes:
      // lane c8 keeps the sums of entries 16 c8_2 + 8 c8_1 + 4 c8_0 + r
      float h16[16], h8[8], h4[4];
      {
        const bool b = c8 & 4;
#pragma unroll
        for (int e = 0; e < 16; ++e)
          h16[e] = (b ? part[16 + e] : part[e]) +
                   __shfl_xor_sync(0xffffffffu, b ? part[e] : part[16 + e],
                                   4);
      }
      {
        const bool b = c8 & 2;
#pragma unroll
        for (int e = 0; e < 8; ++e)
          h8[e] = (b ? h16[8 + e] : h16[e]) +
                  __shfl_xor_sync(0xffffffffu, b ? h16[e] : h16[8 + e], 2);
      }
      {
        const bool b = c8 & 1;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          h4[e] = (b ? h8[4 + e] : h8[e]) +
                  __shfl_xor_sync(0xffffffffu, b ? h8[e] : h8[4 + e], 1);
      }
      const int v0 = 16 * ((c8 >> 2) & 1) + 8 * ((c8 >> 1) & 1) + 4 * (c8 & 1);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        // entry v: step v / 2, chain v % 2 (chain j0 + 1 starts a step
        // after chain j0)
        const int s2 = (v0 + r) >> 1, m = r & 1;
        const bool second = s2 >= split_at;
        const int j0 = second ? TS - 2 - 2 * q : 2 * q;
        const int e = second ? s2 - split_at : s2;
        if (e >= m) ab[(r0 + j0 + 1 + e) * PITCH + r0 + j0 + m] = h4[r];
      }
    }
    __syncthreads();
    // 4. warps 0-7: y += A V; warps 8-15: S = diag(decay) S + (K~ suf)^T
    // V; 3xTF32 on the tensor cores (two products where v is exact)
    if (warp < 8) {
      for (int j0 = 0; j0 < m0 + 16; j0 += 8) {
        float a[4];
        uint32_t ah[4], al[4];
        ldsm_a(a, ab, m0, j0, lane);
        split4(a, ah, al);
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          float b[4];
          ldsm_b2(b, vt, nb + 16 * h2, j0, lane);
          mma3<V_EXACT>(ya[2 * h2], ah, al, b[0], b[1]);
          mma3<V_EXACT>(ya[2 * h2 + 1], ah, al, b[2], b[3]);
        }
      }
      const int p0 = n * C + m0 + g;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int c = nb + 8 * nt + 2 * t;
        if (p0 < S)
          store2(y + base + static_cast<int64_t>(p0) * rs + c, ya[nt][0],
                 ya[nt][1]);
        if (p0 + 8 < S)
          store2(y + base + static_cast<int64_t>(p0 + 8) * rs + c,
                 ya[nt][2], ya[nt][3]);
      }
    } else {
      const float d0 = decay[m0 + g], d1 = decay[m0 + g + 8];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        st[nt][0] *= d0, st[nt][1] *= d0, st[nt][2] *= d1, st[nt][3] *= d1;
      }
#pragma unroll 2
      for (int j0 = 0; j0 < C; j0 += 8) {
        float a[4];
        uint32_t ah[4], al[4];
        frag_a_t(a, kb, m0, j0, lane);
        const float* sv = suf + (j0 / TS) * D + m0 + g;
        const float s0 = sv[0], s1 = sv[8];
        a[0] *= s0, a[1] *= s1, a[2] *= s0, a[3] *= s1;
        split4(a, ah, al);
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          float b[4];
          ldsm_b2(b, vt, nb + 16 * h2, j0, lane);
          mma3<V_EXACT>(st[2 * h2], ah, al, b[0], b[1]);
          mma3<V_EXACT>(st[2 * h2 + 1], ah, al, b[2], b[3]);
        }
      }
    }
  }
  if (warp >= 8)
    store_state(state + static_cast<int64_t>(bh) * D * D, true);
}

namespace {

template <int D, typename T>
int launch(const void* r, const void* k, const void* v, const void* lw,
           const void* u, const void* s0, void* y, void* sT, int B, int S,
           int H, cudaStream_t st) {
  wkv6_kernel<D, T><<<B * H, D, 0, st>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(lw),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<float*>(y), static_cast<float*>(sT), S, H);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* r, const void* k, const void* v, const void* lw,
             const void* u, const void* s0, void* y, void* sT, int B, int S,
             int H, int D, cudaStream_t st) {
  switch (D) {
    case 8: return launch<8, T>(r, k, v, lw, u, s0, y, sT, B, S, H, st);
    case 16: return launch<16, T>(r, k, v, lw, u, s0, y, sT, B, S, H, st);
    case 32: return launch<32, T>(r, k, v, lw, u, s0, y, sT, B, S, H, st);
    case 64: return launch<64, T>(r, k, v, lw, u, s0, y, sT, B, S, H, st);
    case 128: return launch<128, T>(r, k, v, lw, u, s0, y, sT, B, S, H, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch_chunked(const void* r, const void* k, const void* v,
                   const void* lw, const void* u, const void* s0, void* y,
                   void* sT, int B, int S, int H, cudaStream_t st) {
  constexpr int smem = wkvc::smem_bytes<T>();
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        wkv6_chunked_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  wkv6_chunked_kernel<T><<<B * H, wkvc::THREADS, smem, st>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(lw),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<float*>(y), static_cast<float*>(sT), S, H);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// r, k, v: (B, S, H, D) contiguous, bfloat16 (bf16 != 0) or float32; lw,
// y: (B, S, H, D) float32; u: (H, D) float32; state0, state: (B, H, D, D)
// float32, k index first; D one of 8, 16, 32, 64, 128
extern "C" int repro_wkv6(const void* r, const void* k, const void* v,
                          const void* lw, const void* u, const void* state0,
                          void* y, void* state, int32_t B, int32_t S,
                          int32_t H, int32_t D, int32_t bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch<__nv_bfloat16>(r, k, v, lw, u, state0, y, state, B,
                                        S, H, D, st)
              : dispatch<float>(r, k, v, lw, u, state0, y, state, B, S, H,
                                D, st);
}

// the chunked kernel: arguments as repro_wkv6's, D = 64 and S >= 64 only,
// every pointer 16-byte aligned
extern "C" int repro_wkv6_chunked(const void* r, const void* k,
                                  const void* v, const void* lw,
                                  const void* u, const void* state0, void* y,
                                  void* state, int32_t B, int32_t S,
                                  int32_t H, int32_t D, int32_t bf16,
                                  void* stream) {
  if (D != wkvc::D || S < wkvc::C)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_chunked<__nv_bfloat16>(r, k, v, lw, u, state0, y,
                                              state, B, S, H, st)
              : launch_chunked<float>(r, k, v, lw, u, state0, y, state, B, S,
                                      H, st);
}
