// The RG-LRU recurrence of RecurrentGemma's recurrent blocks (Griffin,
// arXiv:2402.19427), gates and scan in one pass, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the reference computes the recurrence with a
// chunked jax.lax.associative_scan (repro/models/rglru.py::rg_lru, its
// gates in ::_gates), which XLA lowers to a tree of elementwise passes.
// On the card a scan on the hot path is a kernel: a host loop over 4096
// positions in each of 18 layers would be ~10^5 launches a prefill.
//
// Per (batch b, channel c), in float32:
//   i_t = sigmoid(xi_t), g_t = sigmoid(xa_t)      (xi, xa: the gates'
//                                                  pre-activations u W + b)
//   log a_t = -8 softplus(lam_c) g_t,  a_t = exp(log a_t)
//   b_t = sqrt(max(1 - exp(2 log a_t), 1e-12)) i_t u_t
//   h_t = a_t h_{t-1} + b_t,  y_t = h_t
// with the reference's operation order; h_t is a product and a sum, each
// rounded (no FMA), as the plain version computes it, so y and h_final
// equal the plain version's bit for bit.
//
// Design.  Only h_t = a_t h_{t-1} + b_t is serial; a_t and b_t depend on
// the inputs alone.  One block per (batch, stripe of 32 channels) walks S
// in tiles of 32 positions x 32 channels through a ring of 6 stages in
// shared memory (12 KB a stage: xi, xa, u).  Warps 1-8 are producers: each
// copies its 4 rows of a tile with 4-byte cp.async (zero bytes past S and
// W are never read), 4 tiles ahead, so a block keeps 48 KB in flight and
// an SM with its 2-3 blocks over 100 KB; then each computes a_t and b_t
// for the rows it copied, in place over xi and xa, with the exact float32
// operations of the plain version.  Warp 0 walks the previous tile's 32
// positions, two dependent operations a position, and stores each
// position's row of 32 channels (one coalesced 128-byte line) to y.  One
// barrier a tile hands a computed tile to the walker and a walked stage
// back to the copies.  S = 1 (decode) runs the same kernel: one row, two
// barriers.
//
// Bound: bytes.  At RecurrentGemma-2B's prefill (B 4, S 4096, w 2560) the
// kernel reads three float32 (B, S, w) tensors and writes one: 671 MB,
// 200 us at 3.35 TB/s; its ~18 operations an element are 11 us of the
// float32 rate.  The walk is ~10 cycles a position, 4096 positions
// ~20 us a block, far below the bytes.
//
// linear_scan_bwd_kernel, the backward (kernels/linear_scan/ops.py's
// LinearScan), from the forward's inputs, its y and the cotangents dy and
// dh_final:
//   g_t = dy_t + a_{t+1} g_{t+1}  (g at the last position: dy + dh_final)
//   da_t = g_t h_{t-1}, db_t = g_t  (h_{-1} = h0), dh0 = a_0 g_0
//   du = g beta i, dxi = g beta u i (1 - i),
//   dlog a = da a - g i u exp(2 log a) / beta  (the second term 0 where
//            the 1e-12 clamp holds),
//   dxa = dlog a (-8 softplus(lam)) g (1 - g),
//   dlam = sum over (B, S) of dlog a g (-8 sigmoid(lam)).
// Same layout as the forward, walking S backwards: a block per (batch,
// 32-channel stripe), tiles of 32 positions through a ring of 6 stages
// (24 KB a stage: xi, xa, u, y shifted by one position (h_{t-1}, h0 at
// t = 0), dy, a), 3 tiles ahead.  In iteration n the producer warps copy
// tile n + 3, compute a_t of tile n with the forward's exact operations,
// and finish tile n - 2 (every derivative above, elementwise, stored as
// coalesced rows); the walker runs the reverse scan over tile n - 1,
// writing g over dy.  dlam: each producer thread sums its rows' dlog a g
// over the tiles in a fixed order, the eight warps' sums add in warp
// order, and each block writes its batch's partial (B, w); the wrapper
// sums the partials over B.  No atomics: two calls give the same bits.
// Bound: bytes.  It reads xi, xa, u, y and dy and writes dxi, dxa and du:
// 8 x 4 B a (b, s, channel), 335 MB and 100 us at 1 x 4096 x 2560.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int LS_STRIPE = 32;            // channels a block (one a lane)
constexpr int LS_P = 32;                 // positions a tile
constexpr int LS_STAGES = 6;             // ring of tiles in shared memory
constexpr int LS_PRODUCERS = 8;          // warps that copy and compute
constexpr int LS_ROWS = LS_P / LS_PRODUCERS;   // rows a producer warp
constexpr int LS_THREADS = 32 * (1 + LS_PRODUCERS);
constexpr int LS_TILE = LS_P * LS_STRIPE;      // floats of one tensor a tile

// log(1 + exp(x)) as jax.nn.softplus computes it: max(x, 0) +
// log1p(exp(-|x|))
__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

// copy 4 bytes global -> shared, or nothing (the slot keeps stale data
// that no thread reads)
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace

__global__ void __launch_bounds__(LS_THREADS)
    linear_scan_kernel(const float* __restrict__ xi,
                       const float* __restrict__ xa,
                       const float* __restrict__ u,
                       const float* __restrict__ lam,
                       const float* __restrict__ h0, float* __restrict__ y,
                       float* __restrict__ h_final, int S, int W) {
  // stage s: [0] xi then a, [1] xa then b, [2] u; each [LS_P][LS_STRIPE]
  extern __shared__ float ring[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = blockIdx.x * LS_STRIPE + lane;
  const int b = blockIdx.y;
  const bool live = c < W;
  const int64_t base = static_cast<int64_t>(b) * S * W + c;
  const int n_tiles = (S + LS_P - 1) / LS_P;
  auto stage = [&](int tile, int which) {
    return ring + ((tile % LS_STAGES) * 3 + which) * LS_TILE;
  };

  if (warp > 0) {
    // producer: rows r0 .. r0 + LS_ROWS - 1 of every tile, channel c
    const int r0 = (warp - 1) * LS_ROWS;
    const float neg_c_sp = live ? -8.f * softplus(lam[c]) : 0.f;
    auto copy = [&](int tile) {
      if (tile < n_tiles && live) {
#pragma unroll
        for (int j = 0; j < LS_ROWS; ++j) {
          const int t = tile * LS_P + r0 + j;
          if (t < S) {
            const int64_t at = base + static_cast<int64_t>(t) * W;
            const int slot = (r0 + j) * LS_STRIPE + lane;
            cp_async4(stage(tile, 0) + slot, xi + at);
            cp_async4(stage(tile, 1) + slot, xa + at);
            cp_async4(stage(tile, 2) + slot, u + at);
          }
        }
      }
      cp_async_commit();
    };
#pragma unroll
    for (int n = 0; n < LS_STAGES - 2; ++n) copy(n);
    for (int n = 0; n <= n_tiles; ++n) {
      if (n < n_tiles) {
        // stage (n + 4) % 6 was walked in iteration n - 1
        copy(n + LS_STAGES - 2);
        cp_async_wait<LS_STAGES - 2>();   // this thread's tile n landed
        if (live) {
#pragma unroll
          for (int j = 0; j < LS_ROWS; ++j) {
            const int t = n * LS_P + r0 + j;
            if (t < S) {
              const int slot = (r0 + j) * LS_STRIPE + lane;
              float* sa = stage(n, 0) + slot;
              float* sb = stage(n, 1) + slot;
              const float gate_i = sigmoid(*sa);
              const float gate_a = sigmoid(*sb);
              const float log_a = neg_c_sp * gate_a;
              const float a = expf(log_a);
              const float beta =
                  sqrtf(fmaxf(1.f - expf(2.f * log_a), 1e-12f));
              *sb = __fmul_rn(__fmul_rn(beta, gate_i), stage(n, 2)[slot]);
              *sa = a;
            }
          }
        }
      }
      __syncthreads();
    }
    cp_async_wait<0>();
  } else {
    // walker: tile n - 1 in iteration n
    float h = live ? h0[static_cast<int64_t>(b) * W + c] : 0.f;
    for (int n = 0; n <= n_tiles; ++n) {
      if (n > 0 && live) {
        const int tile = n - 1, t0 = tile * LS_P;
        const float* sa = stage(tile, 0) + lane;
        const float* sb = stage(tile, 1) + lane;
        float* yt = y + base + static_cast<int64_t>(t0) * W;
        if (t0 + LS_P <= S) {
#pragma unroll
          for (int j = 0; j < LS_P; ++j) {
            h = __fadd_rn(__fmul_rn(sa[j * LS_STRIPE], h),
                          sb[j * LS_STRIPE]);
            yt[static_cast<int64_t>(j) * W] = h;
          }
        } else {
          for (int j = 0; j < S - t0; ++j) {
            h = __fadd_rn(__fmul_rn(sa[j * LS_STRIPE], h),
                          sb[j * LS_STRIPE]);
            yt[static_cast<int64_t>(j) * W] = h;
          }
        }
      }
      __syncthreads();
    }
    if (live) h_final[static_cast<int64_t>(b) * W + c] = h;
  }
}

// xi, xa, u, y: (B, S, W) float32 contiguous; lam: (W,); h0, h_final:
// (B, W)
extern "C" int repro_linear_scan(const void* xi, const void* xa,
                                 const void* u, const void* lam,
                                 const void* h0, void* y, void* h_final,
                                 int32_t B, int32_t S, int32_t W,
                                 void* stream) {
  constexpr int smem = LS_STAGES * 3 * LS_TILE * sizeof(float);
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        linear_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid((W + LS_STRIPE - 1) / LS_STRIPE, B);
  linear_scan_kernel<<<grid, LS_THREADS, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xi), static_cast<const float*>(xa),
      static_cast<const float*>(u), static_cast<const float*>(lam),
      static_cast<const float*>(h0), static_cast<float*>(y),
      static_cast<float*>(h_final), S, W);
  return static_cast<int>(cudaGetLastError());
}

namespace {

constexpr int LB_STAGES = 6;             // backward ring: copy 3 ahead,
constexpr int LB_AHEAD = 3;              // a, walk, finish: 3 + 3 stages
constexpr int LB_SLOTS = 6;              // xi, xa, u, h_{t-1}, dy -> g, a
static_assert(LB_STAGES >= LB_AHEAD + 3, "a stage is reused after finish");

}  // namespace

__global__ void __launch_bounds__(LS_THREADS)
    linear_scan_bwd_kernel(const float* __restrict__ xi,
                           const float* __restrict__ xa,
                           const float* __restrict__ u,
                           const float* __restrict__ lam,
                           const float* __restrict__ h0,
                           const float* __restrict__ y,
                           const float* __restrict__ dy,
                           const float* __restrict__ dh_final,
                           float* __restrict__ dxi, float* __restrict__ dxa,
                           float* __restrict__ du,
                           float* __restrict__ dlam_part,
                           float* __restrict__ dh0, int S, int W) {
  extern __shared__ float ring[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = blockIdx.x * LS_STRIPE + lane;
  const int b = blockIdx.y;
  const bool live = c < W;
  const int64_t base = static_cast<int64_t>(b) * S * W + c;
  const int n_tiles = (S + LS_P - 1) / LS_P;
  // the n-th tile walked is tile n_tiles - 1 - n: the last positions first
  auto stage = [&](int n, int which) {
    return ring + ((n % LB_STAGES) * LB_SLOTS + which) * LS_TILE;
  };
  auto rows_of = [&](int n) {
    return min(LS_P, S - (n_tiles - 1 - n) * LS_P);
  };
  const int r0 = (warp - 1) * LS_ROWS;   // a producer's rows of a tile
  const float neg_c_sp = live ? -8.f * softplus(lam[c]) : 0.f;
  float lam_acc = 0.f;                   // a producer's sum of dlog a g

  auto copy = [&](int n) {
    if (n < n_tiles && live) {
      const int t0 = (n_tiles - 1 - n) * LS_P;
#pragma unroll
      for (int j = 0; j < LS_ROWS; ++j) {
        const int t = t0 + r0 + j;
        if (t < S) {
          const int64_t at = base + static_cast<int64_t>(t) * W;
          const int slot = (r0 + j) * LS_STRIPE + lane;
          cp_async4(stage(n, 0) + slot, xi + at);
          cp_async4(stage(n, 1) + slot, xa + at);
          cp_async4(stage(n, 2) + slot, u + at);
          cp_async4(stage(n, 3) + slot,
                    t > 0 ? y + at - W : h0 + static_cast<int64_t>(b) * W + c);
          cp_async4(stage(n, 4) + slot, dy + at);
        }
      }
    }
    cp_async_commit();
  };
  // a_t of this producer's rows of tile n, the forward's operations
  auto coeff = [&](int n) {
    if (!live) return;
#pragma unroll
    for (int j = 0; j < LS_ROWS; ++j) {
      if (r0 + j < rows_of(n)) {
        const int slot = (r0 + j) * LS_STRIPE + lane;
        stage(n, 5)[slot] = expf(neg_c_sp * sigmoid(stage(n, 1)[slot]));
      }
    }
  };
  // every derivative of this producer's rows of tile n, g in slot 4
  auto finish = [&](int n) {
    if (!live) return;
    const int t0 = (n_tiles - 1 - n) * LS_P;
#pragma unroll
    for (int j = 0; j < LS_ROWS; ++j) {
      if (r0 + j < rows_of(n)) {
        const int slot = (r0 + j) * LS_STRIPE + lane;
        const float gate_i = sigmoid(stage(n, 0)[slot]);
        const float gate_a = sigmoid(stage(n, 1)[slot]);
        const float uu = stage(n, 2)[slot], hp = stage(n, 3)[slot];
        const float g = stage(n, 4)[slot], a = stage(n, 5)[slot];
        const float log_a = neg_c_sp * gate_a;
        const float e2 = expf(2.f * log_a);
        const float m = 1.f - e2;
        const float beta = sqrtf(fmaxf(m, 1e-12f));
        const float gb = __fmul_rn(g, beta);
        const float dbeta = __fmul_rn(__fmul_rn(g, gate_i), uu);
        float dla = __fmul_rn(__fmul_rn(g, hp), a);
        if (m > 1e-12f) dla = __fadd_rn(dla, -(__fmul_rn(dbeta, e2) / beta));
        const int64_t at = base + static_cast<int64_t>(t0 + r0 + j) * W;
        dxi[at] = __fmul_rn(__fmul_rn(gb, uu),
                            __fmul_rn(gate_i, 1.f - gate_i));
        dxa[at] = __fmul_rn(__fmul_rn(dla, neg_c_sp),
                            __fmul_rn(gate_a, 1.f - gate_a));
        du[at] = __fmul_rn(gb, gate_i);
        lam_acc = __fadd_rn(lam_acc, __fmul_rn(dla, gate_a));
      }
    }
  };

  float g = 0.f, a_next = 1.f;           // the walker's carry
  if (warp == 0 && live) g = dh_final[static_cast<int64_t>(b) * W + c];
  if (warp > 0) {
#pragma unroll
    for (int n = 0; n < LB_AHEAD; ++n) copy(n);
  }
  for (int n = 0; n < n_tiles + 2; ++n) {
    if (warp > 0) {
      if (n < n_tiles) {
        copy(n + LB_AHEAD);
        cp_async_wait<LB_AHEAD>();       // this thread's tile n landed
        coeff(n);
      }
      if (n >= 2) finish(n - 2);
    } else if (n >= 1 && n <= n_tiles && live) {
      const int tile = n - 1, rows = rows_of(tile);
      float* sg = stage(tile, 4) + lane;
      const float* sa = stage(tile, 5) + lane;
      for (int j = rows - 1; j >= 0; --j) {
        g = __fadd_rn(sg[j * LS_STRIPE], __fmul_rn(a_next, g));
        sg[j * LS_STRIPE] = g;
        a_next = sa[j * LS_STRIPE];
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();
  // dlam: the producers' sums in warp order; dh0 = a_0 g_0
  float* red = ring;                     // every stage was finished above
  if (warp > 0) red[(warp - 1) * LS_STRIPE + lane] = lam_acc;
  __syncthreads();
  if (warp == 0 && live) {
    float sum = 0.f;
    for (int w = 0; w < LS_PRODUCERS; ++w)
      sum = __fadd_rn(sum, red[w * LS_STRIPE + lane]);
    dlam_part[static_cast<int64_t>(b) * W + c] =
        __fmul_rn(sum, -8.f * sigmoid(lam[c]));
    dh0[static_cast<int64_t>(b) * W + c] = __fmul_rn(a_next, g);
  }
}

// the backward: xi, xa, u, y, dy, dxi, dxa, du (B, S, W) float32
// contiguous; lam (W,); h0, dh_final, dlam_part, dh0 (B, W)
extern "C" int repro_linear_scan_bwd(const void* xi, const void* xa,
                                     const void* u, const void* lam,
                                     const void* h0, const void* y,
                                     const void* dy, const void* dh_final,
                                     void* dxi, void* dxa, void* du,
                                     void* dlam_part, void* dh0, int32_t B,
                                     int32_t S, int32_t W, void* stream) {
  constexpr int smem = LB_STAGES * LB_SLOTS * LS_TILE * sizeof(float);
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        linear_scan_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid((W + LS_STRIPE - 1) / LS_STRIPE, B);
  linear_scan_bwd_kernel<<<grid, LS_THREADS, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xi), static_cast<const float*>(xa),
      static_cast<const float*>(u), static_cast<const float*>(lam),
      static_cast<const float*>(h0), static_cast<const float*>(y),
      static_cast<const float*>(dy), static_cast<const float*>(dh_final),
      static_cast<float*>(dxi), static_cast<float*>(dxa),
      static_cast<float*>(du), static_cast<float*>(dlam_part),
      static_cast<float*>(dh0), S, W);
  return static_cast<int>(cudaGetLastError());
}
