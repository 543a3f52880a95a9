// WKV-6's backward by chunks for Hopper (sm_90a): the route of
// kernels/wkv6/ops.py's wkv6_bwd at head size 64 and S >= 64, beside
// wkv6_bwd.cu's walk (every other shape).
//
// Replaces no Pallas kernel: the reference differentiates its chunked
// einsums (repro/models/rwkv6.py::wkv_chunked) with jax.grad.  Gradients
// as wkv6_bwd.cu's header states them, per (batch, head), with S_t the
// state after position t, dS_t its cotangent, w = exp(lw).
//
// Why chunks.  The walk (one block of 128 threads a (batch, head), 4096
// positions in order, a few dependent dot products and a barrier pair
// every 4 positions) is latency-bound: 32 blocks on 132 SMs at
// RWKV-6-1.6B's 1 x 4096 x 32 x 64, about 1.8 us a position.  Here only
// two short scans over the chunks of C = 64 positions are serial; every
// chunk's gradients are independent once its boundary state and
// cotangent are known, and its products run on the tensor cores.
//
// Two kernels (three past 3 chunks), chunk n of (batch, head) bh,
// positions past S zero-filled (r = k = v = dy = 0, w = 1: they change no
// state and no cotangent):
//   1. wkv6_bwd_state_kernel, a block of 256 a (bh, n): A_i = prod_{s<i}
//      w_s and Z_j = prod_{s>j} w_s down and up the chunk, decay_n =
//      prod w; the chunk's own state (k Z)^T V and cotangent (r A)^T dY
//      (D x C x D products) into the two scratch buffers, decay_n beside.
//      Then bh's two scans over its chunks:
//        S_{n+1} = decay_n S_n + (k Z)^T V from state0, each S_n written
//        over slot n (S_N into slot N);
//        dS_{n-1} = decay_n dS_n + (r A)^T dY from dstate, each chunk's
//        end cotangent over slot n, dstate0 the last;
//      at most 3 chunks (the wrapper's FUSED_SCAN_CHUNKS; S <= 192, a
//      training step's 8 x 128) by the last of bh's blocks to finish (an
//      atomic count of finished blocks after a memory fence; which block
//      it is varies, the arithmetic does not); more (64 steps at 1 x
//      4096) by wkv6_bwd_scan_kernel, 8 blocks a bh, the loads of 8
//      chunks issued together: a long scan moves 4 D^2 floats a chunk,
//      more than one SM's bandwidth carries (on an NVIDIA H100 80GB HBM3
//      at 1 x 4096 x 32 x 64: one SM a bh 656 us, the scan kernel 90);
//   2. wkv6_bwd_chunk_kernel, a block of 512 a (bh, n), the chunk's
//      gradients from S_n, S_{n+1} and dS_n with the forward's algebra
//      (wkv6.cu: sub-chunks of T = 16, H_i, G_j, T_I, pre_I, suf_J, g_IJ,
//      every decay factor a product of w's, never a quotient):
//        B = dY V^T; A the forward's (off-diagonal sub-blocks Q (K~ g)^T
//        with Q = r H, K~ = k G; diagonal sub-blocks by running products;
//        A_ii = r_i . (u k_i));
//        dr~ = H (pre (dY S_n^T) + sum_{J<I} B_IJ (K~_J g_IJ)) + pairs,
//        dk~ = G (suf (V dS_n^T) + sum_{L>I} B_LI^T (Q_L g_LI)) + pairs,
//        dv = (K~ suf) dS_n + A^T dY (the bonus in A's diagonal),
//      the pairs of the diagonal sub-blocks by running products on the
//      CUDA cores; dlw by the identity restarted at the chunk's end,
//        phi = sum_v S_{n+1} o dS_n,
//        dlw_i = phi + sum_{s>i} (r dr~ - k dk~)_s - k_i dk~_i
//      (w_t sum_v S_{t-1} o dS_t = phi_t - k_t dk~_t and phi_{t-1} = phi_t
//      - k_t dk~_t + r_t dr~_t: sums of at most 64 terms, not of the whole
//      sequence; scripts/wkv6_dlw_forms.py measures it against float64);
//      the bonus u k_i (v_i . dy_i) on dr, u r_i (v_i . dy_i) on dk; du a
//      partial a (bh, n, sub-chunk), summed in a fixed order by the
//      wrapper.  No sum takes an atomic: two calls give the same bits.
// Products in 3xTF32 on mma.sync (m16n8k8; fragments by 32-bit shared
// loads from rows padded to 68 floats): plain TF32 or bf16 is too coarse
// for the gradient tests' 2^-16; a bf16 r, k or v operand is exact in
// TF32 and takes two products.  The tests of tests/test_torch_recurrent_
// grads.py hold a torch transcription of these kernels
// (wkv6_bwd_chunk_algebra) against jax.vjp of the reference.
//
// Scratch: two (B H, N (+1), D, D) float32 buffers (S_n over the chunk
// states, dS_n over the chunk cotangents), 33 MB each at 1 x 4096 x 32 x
// 64, and the decays (B H, N, D).
//
// Bound: the walk's (wkv6_bwd.cu): 14 D^2 float32 operations a token and
// head at the CUDA cores' rate, 112 us at 1 x 4096 x 32 heads of 64; the
// chunked form does ~22 D^2 multiply-adds a token on the tensor cores
// (three TF32 terms each) and moves the scratch (4 x 33 MB) besides the
// inputs and outputs.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

namespace wkvb {

constexpr int D = 64, C = 64, TS = 16, NS = C / TS;
constexpr int PITCH = 68;              // floats a row of a [64][.] buffer
constexpr int BUF = 64 * PITCH;
constexpr int STATE_THREADS = 256, CHUNK_THREADS = 512, SCAN_THREADS = 256;
constexpr int SCAN_SLAB = SCAN_THREADS * 4;   // elements a scan block
constexpr int SCAN_AHEAD = 8;                 // chunks a scan loads at once

template <typename T>
__device__ __forceinline__ T narrow(float x);
template <>
__device__ __forceinline__ float narrow<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 w = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&w.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&w.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// 3xTF32 (wkv6.cu's): hi = x rounded to TF32 on the bit pattern, lo = x -
// hi passed as it is (the tensor core reads its top 19 bits)
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}
__device__ __forceinline__ uint32_t tf32_lo(float x, uint32_t hi) {
  return __float_as_uint(x - __uint_as_float(hi));
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

// acc[nt] += A (16 x [k0, k1)) B ([k0, k1) x 8 NT), the warp's tile, in
// three TF32 products, the small ones first (two where an operand is
// exact in TF32).  fa(m, k) and fb(k, n) give the operands' elements (m
// < 16, n < 8 NT: the tile's own rows and columns), so that a product
// reads a buffer as it lies, transposed or scaled
template <bool A_EXACT, bool B_EXACT, int NT, typename FA, typename FB>
__device__ __forceinline__ void mma_tile(float (&acc)[NT][4], int k0, int k1,
                                         FA fa, FB fb, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll 2
  for (int k = k0; k < k1; k += 8) {
    const float a[4] = {fa(g, k + t), fa(g + 8, k + t), fa(g, k + t + 4),
                        fa(g + 8, k + t + 4)};
    uint32_t ah[4], al[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      ah[e] = A_EXACT ? __float_as_uint(a[e]) : to_tf32(a[e]);
      al[e] = tf32_lo(a[e], ah[e]);
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float b0 = fb(k + t, 8 * nt + g), b1 = fb(k + t + 4, 8 * nt + g);
      const uint32_t h0 = B_EXACT ? __float_as_uint(b0) : to_tf32(b0);
      const uint32_t h1 = B_EXACT ? __float_as_uint(b1) : to_tf32(b1);
      if (!A_EXACT) mma8(acc[nt], al, h0, h1);
      if (!B_EXACT) mma8(acc[nt], ah, tf32_lo(b0, h0), tf32_lo(b1, h1));
      mma8(acc[nt], ah, h0, h1);
    }
  }
}

// chunk n's r, k, v, w = exp(lw) and dy into [position][channel] buffers
// (zeros and w = 1 past S), by THREADS threads, 4 channels a load
template <typename T, int THREADS>
__device__ __forceinline__ void load_chunk(const T* r, const T* k, const T* v,
                                           const float* lw, const float* dy,
                                           float* rb, float* kb, float* vb,
                                           float* wb, float* yb, int64_t base,
                                           int64_t rs, int n, int S,
                                           int tid) {
#pragma unroll
  for (int m = 0; m < C * D / 4 / THREADS; ++m) {
    const int e = tid + THREADS * m, row = e >> 4, c4 = (e & 15) * 4;
    const int pos = n * C + row;
    float4 xr = make_float4(0.f, 0.f, 0.f, 0.f), xk = xr, xv = xr, xy = xr;
    float4 xw = make_float4(1.f, 1.f, 1.f, 1.f);
    if (pos < S) {
      const int64_t at = base + pos * rs + c4;
      xr = load4(r + at), xk = load4(k + at), xv = load4(v + at);
      xy = load4(dy + at);
      const float4 l = load4(lw + at);
      xw = make_float4(expf(l.x), expf(l.y), expf(l.z), expf(l.w));
    }
    const int o = row * PITCH + c4;
    store4(rb + o, xr), store4(kb + o, xk), store4(vb + o, xv);
    store4(wb + o, xw), store4(yb + o, xy);
  }
}

constexpr int STATE_SMEM = 5 * BUF * 4;
constexpr int CHUNK_SMEM = (11 * BUF + 20 * D) * 4;
static_assert(CHUNK_SMEM <= 232448, "shared memory");

}  // namespace wkvb

}  // namespace

// 1. each chunk's own state (k Z)^T V and cotangent (r A)^T dY, and its
// decay; with fused the last block of each bh then runs the two scans over
// its chunks: blockIdx.x = bh N + n; done: (B H) zeros (the launcher's
// memset)
template <typename T>
__global__ void __launch_bounds__(wkvb::STATE_THREADS, 2)
    wkv6_bwd_state_kernel(const T* __restrict__ r, const T* __restrict__ k,
                          const T* __restrict__ v,
                          const float* __restrict__ lw,
                          const float* __restrict__ dy,
                          const float* __restrict__ state0,
                          const float* __restrict__ dstate,
                          float* __restrict__ sbuf, float* __restrict__ dsbuf,
                          float* __restrict__ decay,
                          float* __restrict__ dstate0,
                          unsigned* __restrict__ done, int S, int H, int N,
                          bool fused) {
  using namespace wkvb;
  constexpr bool EXACT = sizeof(T) == 2;      // bf16 v is exact in TF32
  extern __shared__ __align__(16) float smem[];
  float* const rb = smem;
  float* const kb = rb + BUF;
  float* const vb = kb + BUF;
  float* const wb = vb + BUF;
  float* const yb = wb + BUF;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.x / N, n = blockIdx.x % N, b = bh / H, h = bh % H;
  const int64_t rs = static_cast<int64_t>(H) * D;
  const int64_t base = (static_cast<int64_t>(b) * S * H + h) * D;
  load_chunk<T, STATE_THREADS>(r, k, v, lw, dy, rb, kb, vb, wb, yb, base, rs,
                               n, S, tid);
  __syncthreads();
  // r A down the chunk (threads 0-63), k Z up it (64-127), a channel each;
  // a sub-chunk's loads ahead of its products
  if (tid < 2 * D) {
    const int c = tid & 63;
    const bool up = tid >= D;
    float* const xb = up ? kb : rb;
    float run = 1.f;
#pragma unroll
    for (int I = 0; I < NS; ++I) {
      float x[TS], w[TS];
#pragma unroll
      for (int s = 0; s < TS; ++s) {
        const int i = up ? C - 1 - (I * TS + s) : I * TS + s;
        x[s] = xb[i * PITCH + c];
        w[s] = wb[i * PITCH + c];
      }
#pragma unroll
      for (int s = 0; s < TS; ++s) {
        const int i = up ? C - 1 - (I * TS + s) : I * TS + s;
        xb[i * PITCH + c] = x[s] * run;
        run = run * w[s];
      }
    }
    if (!up) decay[(static_cast<int64_t>(bh) * N + n) * D + c] = run;
  }
  __syncthreads();
  // warps 0-3: (k Z)^T V, warps 4-7: (r A)^T dY; rows 16 mt.. (k index),
  // every column
  const int mt = warp & 3;
  const float* const xa = warp < 4 ? kb : rb;
  const float* const xb = warp < 4 ? vb : yb;
  float acc[8][4] = {};
  auto fa = [&](int m, int j) { return xa[j * PITCH + 16 * mt + m]; };
  auto fb = [&](int j, int c) { return xb[j * PITCH + c]; };
  if (warp < 4)
    mma_tile<false, EXACT, 8>(acc, 0, C, fa, fb, lane);
  else
    mma_tile<false, false, 8>(acc, 0, C, fa, fb, lane);
  float* const out = (warp < 4 ? sbuf : dsbuf) +
                     (static_cast<int64_t>(bh) * (N + (warp < 4)) + n) * D * D;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int c = 8 * nt + 2 * t;
    store2(out + (16 * mt + g) * D + c, acc[nt][0], acc[nt][1]);
    store2(out + (16 * mt + g + 8) * D + c, acc[nt][2], acc[nt][3]);
  }

  // with fused, the last of bh's N blocks to finish runs its two scans
  // (the threadFenceReduction pattern: every block's writes made visible
  // before it counts itself; the last reads them through L2).  Which block
  // is last varies; the scans' arithmetic does not
  if (!fused) return;
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(done + bh, 1u) == static_cast<unsigned>(N - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  // a thread 4 floats of each of the 4 row bands (16 rows apart) of S and
  // of dS: S_{m+1} = decay_m S_m + (k Z)^T V up the chunks, each S_m over
  // slot m (S_N into slot N); dS_{m-1} = decay_m dS_m + (r A)^T dY down
  // them, each over slot m, dstate0 the last
  constexpr int BANDS = D * D / (4 * STATE_THREADS);
  const int64_t dd = static_cast<int64_t>(D) * D;
  float* const sb = sbuf + static_cast<int64_t>(bh) * (N + 1) * dd;
  float* const db = dsbuf + static_cast<int64_t>(bh) * N * dd;
  const float* const dec = decay + static_cast<int64_t>(bh) * N * D;
  float4 sf[BANDS], sr[BANDS];
#pragma unroll
  for (int q = 0; q < BANDS; ++q) {
    const int e = 4 * tid + 4 * STATE_THREADS * q;
    sf[q] = load4(state0 + bh * dd + e);
    sr[q] = load4(dstate + bh * dd + e);
  }
  for (int j = 0; j < N; ++j) {
    const int mf = j, mr = N - 1 - j;
    float4 xf[BANDS], xr[BANDS];
    float df[BANDS], dr_[BANDS];
#pragma unroll
    for (int q = 0; q < BANDS; ++q) {
      const int e = 4 * tid + 4 * STATE_THREADS * q, row = e / D;
      xf[q] = __ldcg(reinterpret_cast<const float4*>(sb + mf * dd + e));
      xr[q] = __ldcg(reinterpret_cast<const float4*>(db + mr * dd + e));
      df[q] = __ldcg(dec + mf * D + row);
      dr_[q] = __ldcg(dec + mr * D + row);
    }
#pragma unroll
    for (int q = 0; q < BANDS; ++q) {
      const int e = 4 * tid + 4 * STATE_THREADS * q;
      store4(sb + mf * dd + e, sf[q]);
      store4(db + mr * dd + e, sr[q]);
      sf[q] = make_float4(fmaf(df[q], sf[q].x, xf[q].x),
                          fmaf(df[q], sf[q].y, xf[q].y),
                          fmaf(df[q], sf[q].z, xf[q].z),
                          fmaf(df[q], sf[q].w, xf[q].w));
      sr[q] = make_float4(fmaf(dr_[q], sr[q].x, xr[q].x),
                          fmaf(dr_[q], sr[q].y, xr[q].y),
                          fmaf(dr_[q], sr[q].z, xr[q].z),
                          fmaf(dr_[q], sr[q].w, xr[q].w));
    }
  }
#pragma unroll
  for (int q = 0; q < BANDS; ++q) {
    const int e = 4 * tid + 4 * STATE_THREADS * q;
    store4(sb + N * dd + e, sf[q]);
    store4(dstate0 + bh * dd + e, sr[q]);
  }
}

// 1'. without fused, the chunk boundaries' states (forward, blockIdx.y 0)
// and cotangents (reverse, 1) as the state kernel's last block computes
// them, SCAN_SLAB elements of a (bh)'s D x D a block, the loads of
// SCAN_AHEAD chunks issued together: blockIdx.x = bh (D^2 / SCAN_SLAB) +
// slab
__global__ void __launch_bounds__(wkvb::SCAN_THREADS)
    wkv6_bwd_scan_kernel(const float* __restrict__ state0,
                         const float* __restrict__ dstate,
                         const float* __restrict__ decay,
                         float* __restrict__ sbuf, float* __restrict__ dsbuf,
                         float* __restrict__ dstate0, int N) {
  using namespace wkvb;
  constexpr int SLABS = D * D / SCAN_SLAB;
  const int bh = blockIdx.x / SLABS;
  const int e = (blockIdx.x % SLABS) * SCAN_SLAB + threadIdx.x * 4;
  const int row = e / D;
  const bool reverse = blockIdx.y == 1;
  const int slots = reverse ? N : N + 1;
  float* const buf = (reverse ? dsbuf : sbuf) +
                     static_cast<int64_t>(bh) * slots * D * D + e;
  const float* const dec = decay + static_cast<int64_t>(bh) * N * D + row;
  const int64_t at = static_cast<int64_t>(bh) * D * D + e;
  float4 s = load4((reverse ? dstate : state0) + at);
  for (int m0 = 0; m0 < N; m0 += SCAN_AHEAD) {
    float4 x[SCAN_AHEAD];
    float d[SCAN_AHEAD];
#pragma unroll
    for (int q = 0; q < SCAN_AHEAD; ++q) {
      const int m = reverse ? N - 1 - (m0 + q) : m0 + q;
      if (m0 + q < N) {
        x[q] = *reinterpret_cast<const float4*>(buf + static_cast<int64_t>(
                                                    m) * D * D);
        d[q] = dec[m * D];
      }
    }
#pragma unroll
    for (int q = 0; q < SCAN_AHEAD; ++q) {
      const int m = reverse ? N - 1 - (m0 + q) : m0 + q;
      if (m0 + q < N) {
        store4(buf + static_cast<int64_t>(m) * D * D, s);
        s = make_float4(fmaf(d[q], s.x, x[q].x), fmaf(d[q], s.y, x[q].y),
                        fmaf(d[q], s.z, x[q].z), fmaf(d[q], s.w, x[q].w));
      }
    }
  }
  if (reverse)
    store4(dstate0 + at, s);
  else
    store4(buf + static_cast<int64_t>(N) * D * D, s);
}

// 2. a chunk's gradients from its boundary states and cotangent:
// blockIdx.x = bh N + n
template <typename T>
__global__ void __launch_bounds__(wkvb::CHUNK_THREADS, 1)
    wkv6_bwd_chunk_kernel(const T* __restrict__ r, const T* __restrict__ k,
                          const T* __restrict__ v,
                          const float* __restrict__ lw,
                          const float* __restrict__ u,
                          const float* __restrict__ dy,
                          const float* __restrict__ sbuf,
                          const float* __restrict__ dsbuf,
                          T* __restrict__ dr, T* __restrict__ dk,
                          T* __restrict__ dv, float* __restrict__ dlw,
                          float* __restrict__ du_part, int S, int H, int N) {
  using namespace wkvb;
  constexpr bool EXACT = sizeof(T) == 2;      // bf16 r, k, v exact in TF32
  extern __shared__ __align__(16) float smem[];
  float* const rb = smem;                     // r [position][channel]
  float* const kb = rb + BUF;                 // k
  float* const vb = kb + BUF;                 // v
  float* const wb = vb + BUF;                 // w = exp(lw)
  float* const yb = wb + BUF;                 // dy
  float* const s0 = yb + BUF;                 // S_n [k][v], then dr~
  float* const ds = s0 + BUF;                 // dS_n [k][v], then dk~
  float* const hb = ds + BUF;                 // H [position][channel]
  float* const gb = hb + BUF;                 // G
  float* const am = gb + BUF;                 // A [i][j]
  float* const bm = am + BUF;                 // B [i][j] = dy_i . v_j
  float* const pre = bm + BUF;                // [NS][D]
  float* const suf = pre + NS * D;            // [NS][D]
  float* const gf = suf + NS * D;             // [6][D]: g of pairs J < I
  float* const us = gf + 6 * D;               // [D]
  float* const phi = us + D;                  // [D]
  float* const seg = phi + D;                 // [NS][D]
  float* const drb = s0;
  float* const dkb = ds;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x / N, n = blockIdx.x % N, b = bh / H, h = bh % H;
  const int64_t rs = static_cast<int64_t>(H) * D;
  const int64_t base = (static_cast<int64_t>(b) * S * H + h) * D;
  const float* const sn = sbuf + (static_cast<int64_t>(bh) * (N + 1) + n) *
                                     D * D;     // S_n, then S_{n+1}
  const float* const dsn = dsbuf + (static_cast<int64_t>(bh) * N + n) * D * D;

  // 0. the chunk, S_n and dS_n into shared memory; A zeroed; phi = sum_v
  // S_{n+1} o dS_n, a row by 8 lanes
  load_chunk<T, CHUNK_THREADS>(r, k, v, lw, dy, rb, kb, vb, wb, yb, base, rs,
                               n, S, tid);
#pragma unroll
  for (int m = 0; m < D * D / 4 / CHUNK_THREADS; ++m) {
    const int e = tid + CHUNK_THREADS * m, row = e >> 4, c4 = (e & 15) * 4;
    store4(s0 + row * PITCH + c4, load4(sn + row * D + c4));
    store4(ds + row * PITCH + c4, load4(dsn + row * D + c4));
  }
  for (int e = tid; e < BUF; e += CHUNK_THREADS) am[e] = 0.f;
  if (tid < D) us[tid] = u[h * D + tid];
  {
    const int row = tid >> 3, c8 = (tid & 7) * 8;
    const float* a = sn + D * D + row * D + c8;
    const float* d = dsn + row * D + c8;
    const float4 a0 = load4(a), a1 = load4(a + 4);
    const float4 d0 = load4(d), d1 = load4(d + 4);
    float p = ((a0.x * d0.x + a0.y * d0.y) + (a0.z * d0.z + a0.w * d0.w)) +
              ((a1.x * d1.x + a1.y * d1.y) + (a1.z * d1.z + a1.w * d1.w));
    p += __shfl_xor_sync(0xffffffffu, p, 1);
    p += __shfl_xor_sync(0xffffffffu, p, 2);
    p += __shfl_xor_sync(0xffffffffu, p, 4);
    if ((tid & 7) == 0) phi[row] = p;
  }
  __syncthreads();

  // 1. running products down each channel, as wkv6.cu's: warps 0-1
  // forward (H within each sub-chunk, T_I, pre_I, g), warps 2-3 backward
  // (G, suf_J), warps 4-5 the bonus A_ii = r_i . (u k_i)
  if (warp < 2) {
    const int c = tid;
    float e = 1.f, tot[NS];
#pragma unroll
    for (int I = 0; I < NS; ++I) {
      float w[TS];
#pragma unroll
      for (int s = 0; s < TS; ++s) w[s] = wb[(I * TS + s) * PITCH + c];
      pre[I * D + c] = e;
      float run = 1.f;
#pragma unroll
      for (int s = 0; s < TS; ++s) {
        hb[(I * TS + s) * PITCH + c] = run;
        run = run * w[s];
      }
      tot[I] = run;
      e = e * run;
    }
    // pairs 0 (1,0), 1 (2,0), 2 (2,1), 3 (3,0), 4 (3,1), 5 (3,2): the
    // product of T_M over J < M < I
    gf[0 * D + c] = 1.f;
    gf[1 * D + c] = tot[1];
    gf[2 * D + c] = 1.f;
    gf[3 * D + c] = tot[1] * tot[2];
    gf[4 * D + c] = tot[2];
    gf[5 * D + c] = 1.f;
  } else if (warp < 4) {
    const int c = tid - 64;
    float f = 1.f;
#pragma unroll
    for (int J = NS - 1; J >= 0; --J) {
      float w[TS];
#pragma unroll
      for (int s = 0; s < TS; ++s) w[s] = wb[(J * TS + s) * PITCH + c];
      suf[J * D + c] = f;
      float run = 1.f;
#pragma unroll
      for (int s = TS - 1; s >= 0; --s) {
        gb[(J * TS + s) * PITCH + c] = run;
        run = run * w[s];
      }
      f = f * run;
    }
  } else if (warp < 6) {
    const int i = tid - 128;
    float a4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int c = 0; c < D; c += 4) {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        a4[q] = fmaf(rb[i * PITCH + c + q], us[c + q] * kb[i * PITCH + c + q],
                     a4[q]);
    }
    am[i * PITCH + i] = (a4[0] + a4[1]) + (a4[2] + a4[3]);
  }
  __syncthreads();

  // 2. warp (I, cb) owns rows 16 I.. and columns 16 cb.. of dr, dk and dv:
  // their inter-chunk products; then each warp one tile of B (warps 0-9,
  // J <= I) or of A off the diagonal (10-15); then A's diagonal sub-blocks
  // on the CUDA cores
  const int I = warp >> 2, cb = 16 * (warp & 3), r0 = 16 * I;
  float acc_r[2][4] = {}, acc_k[2][4] = {}, acc_v[2][4] = {};
  {
    const float* const pv = pre + I * D + cb;
    const float* const sv = suf + I * D;
    mma_tile<false, false, 2>(
        acc_r, 0, D, [&](int m, int x) { return yb[(r0 + m) * PITCH + x]; },
        [&](int x, int c) { return s0[(cb + c) * PITCH + x] * pv[c]; }, lane);
    mma_tile<EXACT, false, 2>(
        acc_k, 0, D, [&](int m, int x) { return vb[(r0 + m) * PITCH + x]; },
        [&](int x, int c) { return ds[(cb + c) * PITCH + x] * sv[cb + c]; },
        lane);
    mma_tile<false, false, 2>(
        acc_v, 0, D,
        [&](int m, int c) {
          const int o = (r0 + m) * PITCH + c;
          return kb[o] * gb[o] * sv[c];
        },
        [&](int c, int x) { return ds[c * PITCH + cb + x]; }, lane);
  }
  if (warp < 10) {
    // B tile p: (I2, J2) with J2 <= I2, rows of I2 by rows of J2
    const int I2 = warp < 1 ? 0 : warp < 3 ? 1 : warp < 6 ? 2 : 3;
    const int J2 = warp - I2 * (I2 + 1) / 2;
    float acc[2][4] = {};
    mma_tile<false, EXACT, 2>(
        acc, 0, D, [&](int m, int x) { return yb[(16 * I2 + m) * PITCH + x]; },
        [&](int x, int j) { return vb[(16 * J2 + j) * PITCH + x]; }, lane);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int c = 16 * J2 + 8 * nt + 2 * t;
      store2(bm + (16 * I2 + g) * PITCH + c, acc[nt][0], acc[nt][1]);
      store2(bm + (16 * I2 + g + 8) * PITCH + c, acc[nt][2], acc[nt][3]);
    }
  } else {
    // A off-diagonal tile p: Q_I2 (K~_J2 g)^T
    const int p = warp - 10;
    const int I2 = p == 0 ? 1 : (p < 3 ? 2 : 3), J2 = p - I2 * (I2 - 1) / 2;
    const float* const gp = gf + p * D;
    float acc[2][4] = {};
    mma_tile<false, false, 2>(
        acc, 0, D,
        [&](int m, int c) {
          const int o = (16 * I2 + m) * PITCH + c;
          return rb[o] * hb[o];
        },
        [&](int c, int j) {
          const int o = (16 * J2 + j) * PITCH + c;
          return kb[o] * gb[o] * gp[c];
        },
        lane);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int c = 16 * J2 + 8 * nt + 2 * t;
      store2(am + (16 * I2 + g) * PITCH + c, acc[nt][0], acc[nt][1]);
      store2(am + (16 * I2 + g + 8) * PITCH + c, acc[nt][2], acc[nt][3]);
    }
  }
  {
    // A's diagonal sub-block I, pairwise: lanes 8 q.. of warp (I, jb) walk
    // row j = 4 jb + q of the sub-block, 8 channels each (c8..), a running
    // product of k_j by the w's between; every lane steps i = 1 .. 15 (a
    // pair counts where i > j), the 8 partial sums reduced by shuffles
    const int j = 4 * (warp & 3) + (lane >> 3), c8 = 8 * (lane & 7);
    float p8[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) p8[c] = kb[(r0 + j) * PITCH + c8 + c];
#pragma unroll 1
    for (int i = 1; i < TS; ++i) {
      if (i > j + 1) {
#pragma unroll
        for (int c = 0; c < 8; ++c) p8[c] *= wb[(r0 + i - 1) * PITCH + c8 + c];
      }
      const float* ri = rb + (r0 + i) * PITCH + c8;
      float part = ((ri[0] * p8[0] + ri[1] * p8[1]) +
                    (ri[2] * p8[2] + ri[3] * p8[3])) +
                   ((ri[4] * p8[4] + ri[5] * p8[5]) +
                    (ri[6] * p8[6] + ri[7] * p8[7]));
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      part += __shfl_xor_sync(0xffffffffu, part, 4);
      if (i > j && (lane & 7) == 0) am[(r0 + i) * PITCH + r0 + j] = part;
    }
  }
  __syncthreads();

  // 3. the intra-chunk products of warp (I, cb)'s tiles: dr~ = H (acc_r +
  // sum_{J<I} B_IJ (K~_J g_IJ)), dk~ = G (acc_k + sum_{L>I} B_LI^T (Q_L
  // g_LI)) into shared memory (over S_n and dS_n); dv = acc_v + sum_{L>=I}
  // A_LI^T dY_L, stored
  for (int J = 0; J < I; ++J) {
    const float* const gp = gf + (I * (I - 1) / 2 + J) * D + cb;
    mma_tile<false, false, 2>(
        acc_r, 0, TS,
        [&](int m, int j) { return bm[(r0 + m) * PITCH + 16 * J + j]; },
        [&](int j, int c) {
          const int o = (16 * J + j) * PITCH + cb + c;
          return kb[o] * gb[o] * gp[c];
        },
        lane);
  }
  for (int L = I + 1; L < NS; ++L) {
    const float* const gp = gf + (L * (L - 1) / 2 + I) * D + cb;
    mma_tile<false, false, 2>(
        acc_k, 0, TS,
        [&](int m, int l) { return bm[(16 * L + l) * PITCH + r0 + m]; },
        [&](int l, int c) {
          const int o = (16 * L + l) * PITCH + cb + c;
          return rb[o] * hb[o] * gp[c];
        },
        lane);
  }
  mma_tile<false, false, 2>(
      acc_v, r0, C, [&](int m, int l) { return am[l * PITCH + r0 + m]; },
      [&](int l, int x) { return yb[l * PITCH + cb + x]; }, lane);
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    const int c = cb + 8 * nt + 2 * t;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = r0 + g + 8 * half, o = row * PITCH + c, e = 2 * half;
      store2(drb + o, hb[o] * acc_r[nt][e], hb[o + 1] * acc_r[nt][e + 1]);
      store2(dkb + o, gb[o] * acc_k[nt][e], gb[o + 1] * acc_k[nt][e + 1]);
      const int pos = n * C + row;
      if (pos < S)
        store2(dv + base + pos * rs + c, acc_v[nt][e], acc_v[nt][e + 1]);
    }
  }
  __syncthreads();

  // 4. the diagonal sub-blocks' pairs on the CUDA cores, a thread a
  // (sub-chunk, channel): threads 0-255 dr~_i += sum_{j<i} B_ij k_j
  // prod_{j<s<i} w_s, threads 256-511 dk~_i += sum_{l>i} B_li r_l
  // prod_{i<s<l} w_s, by running products
  {
    const bool up = tid >= 4 * D;
    const int I4 = (tid >> 6) & 3, c = tid & 63, q0 = 16 * I4;
    const float* const xs = up ? rb : kb;
    float* const out = up ? dkb : drb;
    float x[TS], w[TS], acc[TS];
#pragma unroll
    for (int s = 0; s < TS; ++s) {
      x[s] = xs[(q0 + s) * PITCH + c];
      w[s] = wb[(q0 + s) * PITCH + c];
      acc[s] = 0.f;
    }
    if (!up) {
#pragma unroll
      for (int j = 0; j < TS - 1; ++j) {
        float p = x[j];
#pragma unroll
        for (int i = j + 1; i < TS; ++i) {
          if (i > j + 1) p *= w[i - 1];
          acc[i] = fmaf(bm[(q0 + i) * PITCH + q0 + j], p, acc[i]);
        }
      }
    } else {
#pragma unroll
      for (int l = TS - 1; l > 0; --l) {
        float p = x[l];
#pragma unroll
        for (int i = l - 1; i >= 0; --i) {
          if (i < l - 1) p *= w[i + 1];
          acc[i] = fmaf(bm[(q0 + l) * PITCH + q0 + i], p, acc[i]);
        }
      }
    }
#pragma unroll
    for (int s = 0; s < TS; ++s) out[(q0 + s) * PITCH + c] += acc[s];
  }
  __syncthreads();

  // 5. dlw, a thread a (sub-chunk, channel): each sub-chunk's sum of r dr~
  // - k dk~; then from phi and the later sub-chunks' sums a walk up the
  // sub-chunk; the bonus on dr and dk; du's partial
  const int I4 = tid >> 6, c = tid & 63, q0 = 16 * I4;
  if (tid < 4 * D) {
    float sum = 0.f;
#pragma unroll
    for (int s = TS - 1; s >= 0; --s) {
      const int o = (q0 + s) * PITCH + c;
      sum += rb[o] * drb[o] - kb[o] * dkb[o];
    }
    seg[I4 * D + c] = sum;
  }
  __syncthreads();
  if (tid < 4 * D) {
    float acc = phi[c];
    for (int M = NS - 1; M > I4; --M) acc += seg[M * D + c];
    const float uc = us[c];
    float dusum = 0.f;
#pragma unroll 4
    for (int s = TS - 1; s >= 0; --s) {
      const int row = q0 + s, o = row * PITCH + c;
      const float ri = rb[o], ki = kb[o], dri = drb[o], dki = dkb[o];
      const float vdy = bm[row * PITCH + row];
      const float kdk = ki * dki;
      const int pos = n * C + row;
      if (pos < S) {
        const int64_t at = base + pos * rs + c;
        dlw[at] = acc - kdk;
        dr[at] = narrow<T>(dri + uc * ki * vdy);
        dk[at] = narrow<T>(dki + uc * ri * vdy);
      }
      acc += ri * dri - kdk;
      dusum += ri * ki * vdy;
    }
    du_part[(static_cast<int64_t>(bh) * N + n) * NS * D + I4 * D + c] = dusum;
  }
}

namespace {

template <typename K>
cudaError_t allow_smem(K kernel, int bytes, bool& configured) {
  if (configured) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  configured = err == cudaSuccess;
  return err;
}

template <typename T>
int launch_chunked_bwd(const void* r, const void* k, const void* v,
                       const void* lw, const void* u, const void* s0,
                       const void* dy, const void* dsT, void* dr, void* dk,
                       void* dv, void* dlw, void* du_part, void* ds0,
                       void* sbuf, void* dsbuf, void* decay, void* done,
                       int B, int S, int H, bool fused, cudaStream_t st) {
  using namespace wkvb;
  static bool state_ok = false, chunk_ok = false;
  cudaError_t err = allow_smem(wkv6_bwd_state_kernel<T>, STATE_SMEM,
                               state_ok);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = allow_smem(wkv6_bwd_chunk_kernel<T>, CHUNK_SMEM, chunk_ok);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int N = (S + C - 1) / C, BH = B * H;
  const T* tr = static_cast<const T*>(r);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const float* flw = static_cast<const float*>(lw);
  const float* fdy = static_cast<const float*>(dy);
  float* fs = static_cast<float*>(sbuf);
  float* fds = static_cast<float*>(dsbuf);
  float* fdec = static_cast<float*>(decay);
  if (fused) {
    err = cudaMemsetAsync(done, 0, sizeof(unsigned) * BH, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  wkv6_bwd_state_kernel<T><<<BH * N, STATE_THREADS, STATE_SMEM, st>>>(
      tr, tk, tv, flw, fdy, static_cast<const float*>(s0),
      static_cast<const float*>(dsT), fs, fds, fdec, static_cast<float*>(ds0),
      static_cast<unsigned*>(done), S, H, N, fused);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!fused) {
    wkv6_bwd_scan_kernel<<<dim3(BH * (D * D / SCAN_SLAB), 2), SCAN_THREADS,
                           0, st>>>(static_cast<const float*>(s0),
                                    static_cast<const float*>(dsT), fdec, fs,
                                    fds, static_cast<float*>(ds0), N);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  wkv6_bwd_chunk_kernel<T><<<BH * N, CHUNK_THREADS, CHUNK_SMEM, st>>>(
      tr, tk, tv, flw, static_cast<const float*>(u), fdy, fs, fds,
      static_cast<T*>(dr), static_cast<T*>(dk), static_cast<T*>(dv),
      static_cast<float*>(dlw), static_cast<float*>(du_part), S, H, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// the chunked route: arguments as repro_wkv6_bwd's (wkv6_bwd.cu) but for
// the scratch: sbuf (B H, N + 1, D, D), dsbuf (B H, N, D, D), decay (B H,
// N, D) float32 with N = ceil(S / 64), done (B H) uint32 (zeroed here
// before the state kernel when the scans are fused); du_part
// (B H, N, 4, D); D = 64 and S >= 64 only, every pointer 16-byte aligned.
// fused_scan != 0: the scans in the state kernel's last block a (batch,
// head), two launches; else in wkv6_bwd_scan_kernel, three
extern "C" int repro_wkv6_bwd_chunked(
    const void* r, const void* k, const void* v, const void* lw,
    const void* u, const void* state0, const void* dy, const void* dstate,
    void* dr, void* dk, void* dv, void* dlw, void* du_part, void* dstate0,
    void* sbuf, void* dsbuf, void* decay, void* done, int32_t B, int32_t S,
    int32_t H, int32_t D, int32_t bf16, int32_t fused_scan, void* stream) {
  if (D != wkvb::D || S < wkvb::C)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_chunked_bwd<__nv_bfloat16>(
                    r, k, v, lw, u, state0, dy, dstate, dr, dk, dv, dlw,
                    du_part, dstate0, sbuf, dsbuf, decay, done, B, S, H,
                    fused_scan != 0, st)
              : launch_chunked_bwd<float>(r, k, v, lw, u, state0, dy, dstate,
                                          dr, dk, dv, dlw, du_part, dstate0,
                                          sbuf, dsbuf, decay, done, B, S, H,
                                          fused_scan != 0, st);
}
