// The backward of RWKV-6's WKV recurrence (wkv6.cu) for Hopper (sm_90a):
// dr, dk, dv, dlw, du and dstate0 from the forward's inputs and the
// cotangents dy of y and dstate of the final state
// (kernels/wkv6/ops.py's WKV6, backward of both forward routes).
//
// Replaces no Pallas kernel: the reference differentiates its chunked
// einsums (repro/models/rwkv6.py::wkv_chunked) with jax.grad.  Per (batch,
// head), with S_t the state after position t (S_0 = state0, k index
// first), w = exp(lw) and dS_T = dstate:
//   dr_t = S_{t-1} dy_t + u k_t (v_t . dy_t)
//   dS_{t-1} = diag(w_t) dS_t + r_t^T dy_t
//   dk_t = dS_t v_t + u r_t (v_t . dy_t)
//   dv_t = dS_t^T k_t + (r_t . (u k_t)) dy_t
//   dlw_t = w_t o sum_v S_{t-1} o dS_t
//   du = sum over (B, S) of r_t k_t (v_t . dy_t), dstate0 = dS_0.
// dlw is taken from the states themselves, which the kernel rebuilds, not
// from the identity that writes it as a difference of two running sums
// over the sequence: in float32 at S 4096 that identity lands 2-9x
// further from float64 (scripts/wkv6_dlw_forms.py), though within the
// gradient tests' 1e-5.
//
// wkv6_bwd_kernel: one block per (batch, head) of 2 D threads.  Threads
// 0 .. D-1 own a row i of dS (k index), threads D .. 2D-1 a column j of
// dS and of S (v index), each in registers.  Two walks:
//   1. forward, the column threads: S from state0 as the forward kernel
//      computes it (a product and a sum each rounded, bit for bit the
//      plain version's), written to a scratch at the start of every chunk
//      of CH positions;
//   2. backward, a chunk at a time, the last first: every thread stages
//      the chunk's r, k, v, w, u k and dy in shared memory; the column
//      threads rebuild the chunk's states S_{t-1} from its checkpoint into
//      shared memory (rows padded to D + 1 floats: a row thread reading
//      its row meets no bank conflict); then, without a barrier, each
//      row thread walks the chunk backwards for dr, dk and dlw (three dot
//      products of D a step) and its row of dS, and each column thread
//      for dv and its column of dS.  The two copies of dS take the same
//      rounded operations and hold the same bits.
// Every sum is float32 in an order fixed by the shape; du's per-(batch,
// head) partials are summed over the batch by the wrapper: no atomics, two
// calls give the same bits.  r, k, v in bfloat16 or float32 (widened
// exactly), dr, dk and dv written in their dtype.
//
// Bound: operations.  The backward needs S_{t-1} again (the forward's
// update, 3 D^2: a product, a product, a sum an element), four dot
// products of D a row or column (dr, dk, dv, dlw: 8 D^2) and dS's update
// (3 D^2): 14 D^2 float32 operations a token and head, 7.5 GFLOP at
// 1 x 4096 x 32 heads of 64, 112 us at the CUDA cores' rate; its bytes
// (bf16 r, k, v, dr, dk, dv; float32 lw, dy, dlw) are 201 MB, 60 us.  The
// kernel does 20 D^2 (the states twice, the bonus dot products) and, like
// the sequential forward, is a latency-bound walk: each position is a few
// dependent dot products, on B H blocks of 2 D threads.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T narrow(float x);
template <>
__device__ __forceinline__ float narrow<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// positions a chunk: the rebuilt states take CH D (D + 1) floats of
// shared memory (66.6 KB at D 64)
template <int D>
__host__ __device__ constexpr int bwd_chunk() { return D >= 64 ? 4 : 16; }

// a dot product of D terms in four interleaved chains
template <int D, typename F>
__device__ __forceinline__ float dot(F term) {
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < D; ++i) acc[i % 4] += term(i);
  return (acc[0] + acc[1]) + (acc[2] + acc[3]);
}

}  // namespace

template <int D, typename T>
__global__ void __launch_bounds__(2 * D)
    wkv6_bwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
                    const T* __restrict__ v, const float* __restrict__ lw,
                    const float* __restrict__ u,
                    const float* __restrict__ state0,
                    const float* __restrict__ dy,
                    const float* __restrict__ dstate, T* __restrict__ dr,
                    T* __restrict__ dk, T* __restrict__ dv,
                    float* __restrict__ dlw, float* __restrict__ du_part,
                    float* __restrict__ dstate0, float* __restrict__ ckpt,
                    int S, int H) {
  constexpr int CH = bwd_chunk<D>(), LD = D + 1;
  extern __shared__ float smem[];
  // staged chunk, [position][channel]: r, k, v, w, u k, dy; then the
  // rebuilt states S_{t-1}, [position][row i][column j], rows LD apart
  float* sr = smem;
  float* sk = sr + CH * D;
  float* sv = sk + CH * D;
  float* sw = sv + CH * D;
  float* suk = sw + CH * D;
  float* sdy = suk + CH * D;
  float* sS = sdy + CH * D;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const bool row = threadIdx.x < D;
  const int i = row ? threadIdx.x : threadIdx.x - D;   // row or column
  const int64_t rs = static_cast<int64_t>(H) * D;     // a position's stride
  const int64_t base = (static_cast<int64_t>(b) * S * H + h) * D;
  const int n_chunks = (S + CH - 1) / CH;
  float* ck = ckpt + static_cast<int64_t>(bh) * n_chunks * D * D;
  const float ui = u[h * D + i];

  // stage positions t0 .. t0 + n - 1 (all 2 D threads); with_r: r, u k
  // and dy too
  auto stage = [&](int t0, int n, bool with_r) {
    for (int e = threadIdx.x; e < n * D; e += 2 * D) {
      const int p = e / D, c = e % D;
      const int64_t at = base + (t0 + p) * rs + c;
      const float kk = widen(k[at]);
      sk[e] = kk;
      sv[e] = widen(v[at]);
      sw[e] = expf(lw[at]);
      if (with_r) {
        sr[e] = widen(r[at]);
        suk[e] = u[h * D + c] * kk;
        sdy[e] = dy[at];
      }
    }
  };

  // 1. the forward walk: column i of S, checkpointed at each chunk start
  float s[D];
  if (!row) {
    const float* s0 = state0 + static_cast<int64_t>(bh) * D * D;
#pragma unroll
    for (int a = 0; a < D; ++a) s[a] = s0[a * D + i];
  }
  for (int n = 0; n < n_chunks; ++n) {
    const int t0 = n * CH, len = min(CH, S - t0);
    if (!row) {
#pragma unroll
      for (int a = 0; a < D; ++a)
        ck[(static_cast<int64_t>(n) * D + a) * D + i] = s[a];
    }
    if (n == n_chunks - 1) break;          // the last chunk's states: unused
    __syncthreads();                       // the last chunk's readers done
    stage(t0, len, false);
    __syncthreads();
    if (!row) {
      for (int p = 0; p < len; ++p) {
        const float vi = sv[p * D + i];
#pragma unroll
        for (int a = 0; a < D; ++a)
          s[a] = __fadd_rn(__fmul_rn(s[a], sw[p * D + a]),
                           __fmul_rn(sk[p * D + a], vi));
      }
    }
  }

  // 2. the backward walk, a chunk at a time from the last
  float dS[D];                             // row i or column i of dS
  const float* dT = dstate + static_cast<int64_t>(bh) * D * D;
#pragma unroll
  for (int a = 0; a < D; ++a) dS[a] = row ? dT[i * D + a] : dT[a * D + i];
  float du_acc = 0.f;
  for (int n = n_chunks - 1; n >= 0; --n) {
    const int t0 = n * CH, len = min(CH, S - t0);
    __syncthreads();                       // the last chunk's readers done
    stage(t0, len, true);
    __syncthreads();
    if (!row) {
      // S_{t-1} of each position, column i, from the chunk's checkpoint
#pragma unroll
      for (int a = 0; a < D; ++a)
        s[a] = ck[(static_cast<int64_t>(n) * D + a) * D + i];
      for (int p = 0; p < len; ++p) {
        float* out = sS + p * D * LD + i;
        const float vi = sv[p * D + i];
#pragma unroll
        for (int a = 0; a < D; ++a) {
          out[a * LD] = s[a];
          s[a] = __fadd_rn(__fmul_rn(s[a], sw[p * D + a]),
                           __fmul_rn(sk[p * D + a], vi));
        }
      }
    }
    __syncthreads();
    for (int p = len - 1; p >= 0; --p) {
      const float* pr = sr + p * D;
      const float* pk = sk + p * D;
      const float* pv = sv + p * D;
      const float* pw = sw + p * D;
      const float* pdy = sdy + p * D;
      const int64_t at = base + (t0 + p) * rs + i;
      if (row) {
        const float* sp = sS + p * D * LD + i * LD;
        const float drt = dot<D>([&](int a) { return sp[a] * pdy[a]; });
        const float dkt = dot<D>([&](int a) { return dS[a] * pv[a]; });
        const float dw = dot<D>([&](int a) { return sp[a] * dS[a]; });
        const float vdy = dot<D>([&](int a) { return pv[a] * pdy[a]; });
        const float ri = pr[i], ki = pk[i], wi = pw[i];
        dr[at] = narrow<T>(drt + ui * ki * vdy);
        dk[at] = narrow<T>(dkt + ui * ri * vdy);
        dlw[at] = wi * dw;
        du_acc += ri * ki * vdy;
#pragma unroll
        for (int a = 0; a < D; ++a)
          dS[a] = __fadd_rn(__fmul_rn(dS[a], wi), __fmul_rn(ri, pdy[a]));
      } else {
        const float dvt = dot<D>([&](int a) { return dS[a] * pk[a]; });
        const float* puk = suk + p * D;
        const float rku = dot<D>([&](int a) { return pr[a] * puk[a]; });
        const float dyi = pdy[i];
        dv[at] = narrow<T>(dvt + rku * dyi);
#pragma unroll
        for (int a = 0; a < D; ++a)
          dS[a] = __fadd_rn(__fmul_rn(dS[a], pw[a]), __fmul_rn(pr[a], dyi));
      }
    }
  }
  if (row) {
    float* d0 = dstate0 + static_cast<int64_t>(bh) * D * D + i * D;
#pragma unroll
    for (int a = 0; a < D; ++a) d0[a] = dS[a];
    du_part[static_cast<int64_t>(bh) * D + i] = du_acc;
  }
}

namespace {

template <int D>
constexpr int bwd_smem() {
  return (6 * bwd_chunk<D>() * D + bwd_chunk<D>() * D * (D + 1)) * 4;
}

template <int D, typename T>
int launch_bwd(const void* r, const void* k, const void* v, const void* lw,
               const void* u, const void* s0, const void* dy,
               const void* dsT, void* dr, void* dk, void* dv, void* dlw,
               void* du_part, void* ds0, void* ckpt, int B, int S, int H,
               int chunk, cudaStream_t st) {
  if (chunk != bwd_chunk<D>()) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int smem = bwd_smem<D>();
  static_assert(smem <= 232448, "shared memory");
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        wkv6_bwd_kernel<D, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  wkv6_bwd_kernel<D, T><<<B * H, 2 * D, smem, st>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(lw),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<const float*>(dy), static_cast<const float*>(dsT),
      static_cast<T*>(dr), static_cast<T*>(dk), static_cast<T*>(dv),
      static_cast<float*>(dlw), static_cast<float*>(du_part),
      static_cast<float*>(ds0), static_cast<float*>(ckpt), S, H);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_bwd(const void* r, const void* k, const void* v, const void* lw,
                 const void* u, const void* s0, const void* dy,
                 const void* dsT, void* dr, void* dk, void* dv, void* dlw,
                 void* du_part, void* ds0, void* ckpt, int B, int S, int H,
                 int D, int chunk, cudaStream_t st) {
#define WKV6_BWD_CASE(N)                                                  \
  case N:                                                                 \
    return launch_bwd<N, T>(r, k, v, lw, u, s0, dy, dsT, dr, dk, dv, dlw, \
                            du_part, ds0, ckpt, B, S, H, chunk, st);
  switch (D) {
    WKV6_BWD_CASE(8)
    WKV6_BWD_CASE(16)
    WKV6_BWD_CASE(32)
    WKV6_BWD_CASE(64)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef WKV6_BWD_CASE
}

}  // namespace

// r, k, v, dr, dk, dv: (B, S, H, D) contiguous, bfloat16 (bf16 != 0) or
// float32; lw, dy, dlw: (B, S, H, D) float32; u: (H, D); state0, dstate,
// dstate0: (B, H, D, D) float32, k index first; du_part: (B, H, D); ckpt:
// (B H, ceil(S / chunk), D, D) float32 scratch; D one of 8, 16, 32, 64 and
// chunk the kernel's (16, 16, 16, 4)
extern "C" int repro_wkv6_bwd(const void* r, const void* k, const void* v,
                              const void* lw, const void* u,
                              const void* state0, const void* dy,
                              const void* dstate, void* dr, void* dk,
                              void* dv, void* dlw, void* du_part,
                              void* dstate0, void* ckpt, int32_t B,
                              int32_t S, int32_t H, int32_t D, int32_t chunk,
                              int32_t bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch_bwd<__nv_bfloat16>(r, k, v, lw, u, state0, dy,
                                            dstate, dr, dk, dv, dlw, du_part,
                                            dstate0, ckpt, B, S, H, D, chunk,
                                            st)
              : dispatch_bwd<float>(r, k, v, lw, u, state0, dy, dstate, dr,
                                    dk, dv, dlw, du_part, dstate0, ckpt, B,
                                    S, H, D, chunk, st);
}
