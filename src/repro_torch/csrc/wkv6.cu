// The WKV recurrence of RWKV-6's time mixing ("Finch", arXiv:2404.05892)
// for Hopper (sm_90a).
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
// lw (the log decay, <= 0) and u in float32.  The state update is a
// product and a sum each rounded (no FMA), as the plain version's
// S * w + k v^T, and exp is expf, as torch.exp: the state matches it bit
// for bit; y sums its D products in four interleaved chains.
//
// Design.  One block per (batch, head), one thread per value column j,
// which keeps column S[:, j] (D floats) in registers.  Each step the
// thread of index i stages r_i, k_i, exp(lw_i) and u_i k_i in shared
// memory (two buffers, so one barrier a step), and every thread reads
// them back as broadcasts; the next step's loads are issued before this
// step's arithmetic.  S = 1 is the decode step.
//
// Bound: at RWKV-6-1.6B's prefill (B 4, S 4096, 32 heads of 64) about
// 5 D^2 float32 operations a token and head, 10.7 GFLOP, 160 us at the
// CUDA cores' rate; bytes (bf16 r, k, v, float32 lw and y) 470 MB, 140 us.
// 128 blocks of D threads walking 4096 steps in order sit far above it:
// the kernel is latency-bound by the sequential walk.
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
